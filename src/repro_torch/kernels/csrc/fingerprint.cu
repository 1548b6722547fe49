// fp128 chunk fingerprints of checkpoint payloads, computed where the bytes
// live so only the 16-byte-per-chunk digest table crosses to the host.
//
// Digest (repro/kernels/fingerprint.py, fp128 v1): a chunk's bytes, zero-
// padded to a multiple of 4, are little-endian uint32 lanes v_0..v_{L-1};
// d_k = (sum_i v_i * (fmix32((i+1) ^ SEED_k) | 1) + n * LEN_k) mod 2^32 with
// n the chunk's byte length.

#include "common.cuh"

// Replaces repro/kernels/fingerprint.py: fingerprint_chunks (_fp_kernel) and
// its prologue (lanes_u32 / _fp_prep_jit: little-endian lanes, zero-padded
// ragged last chunk). Bound on the H100: bytes — each payload byte is read
// once and 16 B per chunk are written; the weights are regenerated from the
// lane index (about ten integer operations per lane and seed) instead of
// being read. Design: one block per chunk, 16-byte loads over whole lanes,
// the partial last lane assembled bytewise, a warp-shuffle + shared-memory
// reduction of the four sums. The source is read in place — no padded lane
// copy is made.
__global__ void fingerprint_kernel(const uint8_t* __restrict__ data,
                                   long long nbytes, long long chunk_bytes,
                                   uint32_t* __restrict__ d) {
  const long long c = blockIdx.x;
  const long long start = c * chunk_bytes;
  const long long rem = nbytes - start;
  const uint32_t m = (uint32_t)(rem < chunk_bytes ? rem : chunk_bytes);
  const uint8_t* base = data + start;
  const uint32_t full = m / 4;                 // whole lanes
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  uint32_t vec_lanes = 0;
  if ((reinterpret_cast<uintptr_t>(base) & 15u) == 0) {
    vec_lanes = full & ~3u;
    const uint4* b4 = reinterpret_cast<const uint4*>(base);
    for (uint32_t g = threadIdx.x; g < vec_lanes / 4; g += THREADS) {
      const uint4 v = b4[g];
      digest_lane(acc, 4 * g, v.x);
      digest_lane(acc, 4 * g + 1, v.y);
      digest_lane(acc, 4 * g + 2, v.z);
      digest_lane(acc, 4 * g + 3, v.w);
    }
  }
  const uint32_t* b32 = reinterpret_cast<const uint32_t*>(base);
  for (uint32_t i = vec_lanes + threadIdx.x; i < full; i += THREADS)
    digest_lane(acc, i, b32[i]);
  if (threadIdx.x == 0 && (m & 3u)) {          // partial last lane
    uint32_t v = 0;
    for (uint32_t b = 0; b < (m & 3u); ++b)
      v |= (uint32_t)base[4 * full + b] << (8 * b);
    digest_lane(acc, full, v);
  }
  digest_reduce_store(acc, m, d + 4 * c);
}

// Replaces repro/kernels/fingerprint.py: quantize_fingerprint_blocks
// (_quant_fp_kernel) — the int8 quantize of quantize.cu fused with the
// digest of the q bytes it produces. Bound on the H100: bytes — 4 B read and
// ~1 B written per value; the q stream is digested from registers, never
// re-read. Design: one block per digest chunk (chunk_bytes / 512 rows), each
// warp quantizes one row at a time as in quantize_kernel and folds its four
// q words into the block's sums at their lane index within the chunk.
__global__ void quant_fingerprint_kernel(const float* __restrict__ x,
                                         long long n_valid,
                                         long long chunk_rows,
                                         uint32_t* __restrict__ q,
                                         float* __restrict__ s,
                                         uint32_t* __restrict__ d) {
  const long long c = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  for (long long r = warp; r < chunk_rows; r += THREADS / 32) {
    const long long row = c * chunk_rows + r;
    const RowQ rq = quant_row(x, row, n_valid);
    uint32_t* qrow = q + row * (LANE_COLS / 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      qrow[j * 32 + lane] = rq.packed[j];
      digest_lane(acc, (uint32_t)(r * (LANE_COLS / 4) + j * 32 + lane),
                  rq.packed[j]);
    }
    if (lane == 0) s[row] = rq.scale;
  }
  digest_reduce_store(acc, (uint32_t)(chunk_rows * LANE_COLS), d + 4 * c);
}

extern "C" {

int rt_fingerprint_chunks(const void* data, long long nbytes,
                          long long chunk_bytes, void* d,
                          cudaStream_t stream) {
  const long long nc = (nbytes + chunk_bytes - 1) / chunk_bytes;
  if (nc > 0)
    fingerprint_kernel<<<(unsigned)nc, THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(data), nbytes, chunk_bytes,
        static_cast<uint32_t*>(d));
  return (int)cudaGetLastError();
}

int rt_quant_fingerprint_blocks(const float* x, long long n_valid,
                                long long n_chunks, long long chunk_rows,
                                void* q, float* s, void* d,
                                cudaStream_t stream) {
  if (n_chunks > 0)
    quant_fingerprint_kernel<<<(unsigned)n_chunks, THREADS, 0, stream>>>(
        x, n_valid, chunk_rows, static_cast<uint32_t*>(q), s,
        static_cast<uint32_t*>(d));
  return (int)cudaGetLastError();
}

}  // extern "C"
