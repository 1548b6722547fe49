// RG-LRU linear recurrence over the sequence axis of a (B, S, R) f32 tensor.
//
// Replaces repro/kernels/rglru.py: rglru_scan (_rglru_kernel, the Pallas scan
// that streams (256, 128) tiles through VMEM and carries h in VMEM scratch
// across the sequential seq-chunk grid axis). It computes
//     forward:  h_t = a_t * h_{t-1} + b_t,            t = 0 .. S-1, h_{-1} = 0
//     reverse:  g_t = a_{t+1} * g_{t+1} + d_t,        t = S-1 .. 0, g_S = 0
// The reverse pass is the gradient of the forward one (d = dL/dh, g = dL/db;
// dL/da_t = g_t * h_{t-1} is formed by the caller). JAX differentiates its XLA
// associative scan and has no backward kernel; here both directions are this
// one source.
//
// Bound on the H100: bytes — 4 B read of a, 4 B of b and 4 B written per
// element for 2 floating-point operations; (8, 255, 2560) moves 62.7 MB, 0.0187
// ms at 3.35 TB/s. Design: the TPU grid's sequential seq axis and VMEM carry
// become a loop inside one thread. One thread owns one (b, r) column and keeps
// its carry in a register; neighbouring threads take neighbouring r, so every
// load and store of a warp is 128 contiguous bytes. The loop loads UNROLL steps
// of both inputs before the dependent multiply-add chain consumes them, so the
// loads of later steps are in flight while earlier ones are combined. Any
// (B, S, R) is taken as it is: no padded copy, the ragged last group of steps
// is masked.
//
// Bit-exactness with the plain PyTorch version (a loop over t of one multiply
// and one add): the product and the sum are rounded separately with
// __fmul_rn / __fadd_rn, which nvcc never contracts into an FMA.

#include <cuda_runtime.h>

#define SCAN_THREADS 128   // threads per block: one (b, r) column each
#define UNROLL 8           // steps loaded ahead of the multiply-add chain

template <bool REVERSE>
__global__ void rglru_scan_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  float* __restrict__ out, long long batch,
                                  long long seq, long long width) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= batch * width) return;
  const long long bi = col / width, r = col % width;
  const float* ab = a + bi * seq * width + r;
  const float* bb = b + bi * seq * width + r;
  float* ob = out + bi * seq * width + r;
  float carry = 0.f;
  // step i (0-based in walk order) works on position t(i): i forward, S-1-i in
  // reverse; its coefficient is a[t] forward and a[t+1] (0 past the end) in
  // reverse
  for (long long i0 = 0; i0 < seq; i0 += UNROLL) {
    float ca[UNROLL], cb[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long i = i0 + k;
      ca[k] = 0.f;
      cb[k] = 0.f;
      if (i < seq) {
        const long long t = REVERSE ? seq - 1 - i : i;
        cb[k] = bb[t * width];
        if (!REVERSE)
          ca[k] = ab[t * width];
        else if (t + 1 < seq)
          ca[k] = ab[(t + 1) * width];
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long i = i0 + k;
      if (i < seq) {
        carry = __fadd_rn(__fmul_rn(ca[k], carry), cb[k]);
        ob[(REVERSE ? seq - 1 - i : i) * width] = carry;
      }
    }
  }
}

extern "C" {

// a, b, out: contiguous (batch, seq, width) float32 on the device.
// reverse = 0: out = h (forward scan of b); reverse = 1: out = g (reverse scan
// of b = dL/dh against a shifted by one step).
int rt_rglru_scan(const float* a, const float* b, float* out, long long batch,
                  long long seq, long long width, int reverse,
                  cudaStream_t stream) {
  const long long cols = batch * width;
  if (cols == 0 || seq == 0) return (int)cudaGetLastError();
  const long long blocks = (cols + SCAN_THREADS - 1) / SCAN_THREADS;
  if (reverse)
    rglru_scan_kernel<true><<<(unsigned)blocks, SCAN_THREADS, 0, stream>>>(
        a, b, out, batch, seq, width);
  else
    rglru_scan_kernel<false><<<(unsigned)blocks, SCAN_THREADS, 0, stream>>>(
        a, b, out, batch, seq, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
