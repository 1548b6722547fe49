// RG-LRU linear recurrence over the sequence axis of a (B, S, R) f32 tensor.
//
// Replaces repro/kernels/rglru.py: rglru_scan (_rglru_kernel, the Pallas scan
// that streams (256, 128) tiles through VMEM and carries h in VMEM scratch
// across the sequential seq-chunk grid axis). Three modes of one kernel:
//     forward:  h_t = a_t * h_{t-1} + b_t,          t = 0 .. S-1, h_{-1} = 0
//     reverse:  g_t = a_{t+1} * g_{t+1} + d_t,      t = S-1 .. 0, g_S = a_S = 0
//     grad:     the reverse scan of d = dL/dh, and also
//               da_t = g_t * h_{t-1} (h_{-1} = 0) from the forward output h
// g is dL/db and da is dL/da of the forward scan, so the grad mode is the
// whole backward in one launch. JAX differentiates its XLA associative scan
// and has no backward kernel; here both directions are this one source.
//
// Bound on the H100: bytes (2 flops per 12 bytes). Each input read once and
// each output written once: forward and reverse 12 B per element, (8, 255,
// 2560) moves 62.7 MB, 0.0187 ms at 3.35 TB/s; grad reads a, d, h and writes
// g, da, 20 B per element, 104.4 MB, 0.0312 ms.
//
// Design: a block owns COLS = 64 neighbouring columns of one batch row and
// walks all S steps; one consumer thread per column keeps the carry in a
// register. The inputs stream through a ring of STAGES stages of
// (ROWS = 32 steps x 64 columns) tiles in dynamic shared memory, filled by
// asynchronous copies: stage j + STAGES is issued as soon as stage j has been
// consumed, so STAGES - 1 stages are in flight while the chain runs.
//   forward, reverse: 2 inputs x 4 stages x 8 KB = 64 KB per block,
//                     48 KB in flight;
//   grad:             3 inputs x 3 stages x 8 KB = 72 KB per block,
//                     48 KB in flight.
// Three blocks fit on an SM (~145 KB in flight per SM), so the 320 blocks of
// the training shape (8 x 40 column tiles) are all resident at once.
// A thread reads column c of a stage, so a warp reads 32 neighbouring banks,
// and writes each output as a coalesced 4-byte store.
//
// Copies: where every row segment starts 16-byte aligned (R % 4 == 0 and the
// input base pointers 16-byte aligned, as the model's R = 2560 gives), warp 0
// fills a stage with TMA bulk copies (cp.async.bulk, one per row segment per
// input, lane r taking row r) that count their bytes on the stage's mbarrier;
// the block waits on the barrier and syncs before a consumed stage is
// refilled. Otherwise (an odd R, a misaligned view) each thread copies its
// own column with 4-byte cp.async, one commit group per stage; since a thread
// reads back only what it copied, that variant needs no barrier at all. The
// caller picks the variant (kernels/rglru.py: copy_variant); the launcher
// refuses a bulk request that the alignment does not allow. Any (B, S, R) is
// taken as it is: no padded copy; ragged chunks and tiles are masked.
//
// Every input tile of a stage covers the same rows [lo, lo + n). The reverse
// walk needs a_{t+1} and h_{t-1}, one row off: it keeps a_t in a register for
// the next step (t - 1), and forms da_{t+1} = g_{t+1} * h_t when it reaches
// row t, with g_{t+1} still in its carry; da_0 = g_0 * 0 after the walk.
//
// The chain stays one sequential multiply-add per step, in walk order: a
// chunked parallel scan that combines carries would reorder the rounding, and
// the kernel must equal the plain PyTorch loop (kernels/ref.py) bit for bit.
// The product and the sum are rounded separately with __fmul_rn / __fadd_rn,
// which nvcc never contracts into an FMA; da is one __fmul_rn, as torch.mul.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 64;   // columns per block, one thread each
constexpr int ROWS = 32;   // steps per ring stage
constexpr int BAR_BYTES = 128;   // the stages' mbarriers, ahead of the ring

enum Mode { FORWARD = 0, REVERSE = 1, GRAD = 2 };

template <int MODE>
struct Ring {
  static constexpr int inputs = MODE == GRAD ? 3 : 2;
  static constexpr int stages = MODE == GRAD ? 3 : 4;
  static constexpr int tile = ROWS * COLS;   // floats per input per stage
  static constexpr int smem = BAR_BYTES + stages * inputs * tile * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete. A stage lands within
// microseconds; one that has not after ~2^32 cycles (about 2 s) was never
// going to, and the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 32)) __trap();
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// completion counted on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// a, b, h: (batch, seq, width) inputs; b is d = dL/dh in the reverse modes,
// h (grad only) the forward output. out: h (forward) or g; da: grad only.
template <int MODE, bool BULK>
__global__ void __launch_bounds__(COLS)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h, float* __restrict__ out,
                      float* __restrict__ da, long long seq, long long width,
                      long long tiles) {
  using RG = Ring<MODE>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + BAR_BYTES);

  const long long c0 = (blockIdx.x % tiles) * COLS;
  const int w = (int)min((long long)COLS, width - c0);   // columns here
  const int tid = threadIdx.x;
  const bool active = tid < w;
  const long long base = (blockIdx.x / tiles) * seq * width + c0;
  const float* src[RG::inputs];
  src[0] = a + base;
  src[1] = b + base;
  if constexpr (MODE == GRAD) src[2] = h + base;
  const int chunks = (int)((seq + ROWS - 1) / ROWS);

  // chunk j covers rows [lo, lo + n): from t = 0 up in the forward, from
  // t = S - 1 down in the reverse modes (the ragged chunk comes last)
  auto rows_of = [&](int j, long long& lo) -> int {
    if (MODE == FORWARD) {
      lo = (long long)j * ROWS;
      return (int)min((long long)ROWS, seq - lo);
    }
    const long long hi = seq - (long long)j * ROWS;
    lo = hi > ROWS ? hi - ROWS : 0;
    return (int)(hi - lo);
  };
  auto load = [&](int j) {
    long long lo;
    const int n = rows_of(j, lo);
    float* st = ring + (j % RG::stages) * RG::inputs * RG::tile;
    if (BULK) {
      if (tid < 32) {
        const uint32_t bar = smem_u32(&bars[j % RG::stages]);
        if (tid == 0) mbar_expect_tx(bar, (uint32_t)(n * w * 4 * RG::inputs));
        __syncwarp();
        for (int r = tid; r < n; r += 32) {
#pragma unroll
          for (int i = 0; i < RG::inputs; ++i)
            bulk_load(smem_u32(st + i * RG::tile + r * COLS),
                      src[i] + (lo + r) * width, (uint32_t)(w * 4), bar);
        }
      }
    } else if (active) {
      for (int r = 0; r < n; ++r) {
#pragma unroll
        for (int i = 0; i < RG::inputs; ++i)
          cp_async4(smem_u32(st + i * RG::tile + r * COLS + tid),
                    src[i] + (lo + r) * width + tid);
      }
    }
  };

  if (BULK) {
    if (tid == 0) {
      for (int s = 0; s < RG::stages; ++s) mbar_init(smem_u32(&bars[s]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  for (int j = 0; j < RG::stages; ++j) {
    if (j < chunks) load(j);
    if (!BULK) cp_async_commit();   // empty groups keep the count uniform
  }

  float carry = 0.f;   // h_{t-1} forward; g_{t+1} in reverse
  float coef = 0.f;    // a_{t+1} in reverse (a_S = 0)
  for (int j = 0; j < chunks; ++j) {
    const int s = j % RG::stages;
    if (BULK)
      mbar_wait(smem_u32(&bars[s]), (uint32_t)((j / RG::stages) & 1));
    else
      cp_async_wait<RG::stages - 1>();   // chunk j's group has landed
    long long lo;
    const int n = rows_of(j, lo);
    const float* sa = ring + s * RG::inputs * RG::tile + tid;
    const float* sb = sa + RG::tile;
    if (active) {
      float* o = out + base + lo * width + tid;
      if (MODE == FORWARD) {
#pragma unroll 8
        for (int r = 0; r < n; ++r) {
          carry = __fadd_rn(__fmul_rn(sa[r * COLS], carry), sb[r * COLS]);
          o[r * width] = carry;
        }
      } else {
        const float* sh = sb + RG::tile;
        float* d = da + base + lo * width + tid;
#pragma unroll 8
        for (int r = n - 1; r >= 0; --r) {
          const float g = __fadd_rn(__fmul_rn(coef, carry), sb[r * COLS]);
          o[r * width] = g;
          // da_{t+1} = g_{t+1} * h_t, t = lo + r
          if (MODE == GRAD && lo + r + 1 < seq)
            d[(r + 1) * width] = __fmul_rn(carry, sh[r * COLS]);
          carry = g;
          coef = sa[r * COLS];
        }
      }
    }
    if (j + RG::stages < chunks) {
      if (BULK) __syncthreads();   // every column is done with stage s
      load(j + RG::stages);
    }
    if (!BULK) cp_async_commit();
  }
  if (MODE == GRAD && active) da[base + tid] = __fmul_rn(carry, 0.f);
}

template <int MODE, bool BULK>
int launch(const float* a, const float* b, const float* h, float* out,
           float* da, long long batch, long long seq, long long width,
           cudaStream_t stream) {
  auto kernel = rglru_scan_kernel<MODE, BULK>;
  // the attribute holds per device: set it at the first launch on each
  // (one bit per device; past 64 devices it is set at every launch)
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Ring<MODE>::smem);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  const long long tiles = (width + COLS - 1) / COLS;
  kernel<<<(unsigned)(batch * tiles), COLS, Ring<MODE>::smem, stream>>>(
      a, b, h, out, da, seq, width, tiles);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const float* a, const float* b, const float* h, float* out,
             float* da, long long batch, long long seq, long long width,
             int bulk, cudaStream_t stream) {
  if (bulk)
    return launch<MODE, true>(a, b, h, out, da, batch, seq, width, stream);
  return launch<MODE, false>(a, b, h, out, da, batch, seq, width, stream);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// a, b, h, out, da: contiguous (batch, seq, width) float32 on the device.
// mode 0: out = h, the forward scan of b (h, da unused);
// mode 1: out = g, the reverse scan of b = dL/dh (h, da unused);
// mode 2: also da = g_t * h_{t-1}, with h the forward scan's output.
// bulk = 1 fills the ring with TMA bulk copies: it needs width % 4 == 0 and
// 16-byte aligned a, b (and h); bulk = 0 copies 4 bytes a thread.
int rt_rglru_scan(const float* a, const float* b, const float* h, float* out,
                  float* da, long long batch, long long seq, long long width,
                  int mode, int bulk, cudaStream_t stream) {
  if (mode < FORWARD || mode > GRAD || (mode == GRAD && (!h || !da)))
    return (int)cudaErrorInvalidValue;
  if (bulk && (width % 4 || !aligned16(a) || !aligned16(b) ||
               (mode == GRAD && !aligned16(h))))
    return (int)cudaErrorInvalidValue;
  if (batch * width == 0 || seq == 0) return (int)cudaGetLastError();
  if (mode == FORWARD)
    return dispatch<FORWARD>(a, b, h, out, da, batch, seq, width, bulk, stream);
  if (mode == REVERSE)
    return dispatch<REVERSE>(a, b, h, out, da, batch, seq, width, bulk, stream);
  return dispatch<GRAD>(a, b, h, out, da, batch, seq, width, bulk, stream);
}

}  // extern "C"
