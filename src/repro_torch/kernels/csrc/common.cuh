// Shared definitions for the checkpoint kernels (quantize.cu, fingerprint.cu).
//
// Bit-exactness is the contract: q, the scales and the digests must equal the
// JAX package's bytes, because the fp128 delta index content-addresses exactly
// these bytes. So every float step is spelled with an explicit IEEE
// round-to-nearest intrinsic (no fast-math, no reciprocal multiply, no FMA
// contraction) and all digest arithmetic is uint32, wrapping mod 2^32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define LANE_COLS 512          // quantization group: one row of 512 values
#define THREADS 256            // threads per block in every kernel here

// fp128 digest constants (repro/kernels/fingerprint.py: _SEEDS, _LEN, _M1/_M2)
static __constant__ uint32_t kSeeds[4] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                   0x27D4EB2Fu};
static __constant__ uint32_t kLen[4] = {0x165667B1u, 0xD3A2646Du, 0x9E3779B9u,
                                 0x27D4EB2Fu};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// acc[k] += v * w_k(lane) for the lane at 0-based index `lane` of its chunk;
// w_k(i) = fmix32((i + 1) ^ seed_k) | 1 is regenerated, never loaded
__device__ __forceinline__ void digest_lane(uint32_t acc[4], uint32_t lane,
                                            uint32_t v) {
  const uint32_t pos = lane + 1u;
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] += v * (fmix32(pos ^ kSeeds[k]) | 1u);
}

// Sum the four accumulators over the block (mod 2^32); thread 0 writes
// d[k] = sum_k + nbytes * len_k.
__device__ __forceinline__ void digest_reduce_store(uint32_t acc[4],
                                                    uint32_t nbytes,
                                                    uint32_t* d) {
  __shared__ uint32_t part[THREADS / 32][4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    if (lane == 0) part[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int k = threadIdx.x;
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += part[w][k];
    d[k] = s + nbytes * kLen[k];
  }
}

// One 512-value row quantized by one warp: lane l holds the four float4s at
// column groups (j*32 + l), j = 0..3, i.e. columns 4*(j*32+l) .. +3. Values at
// flat index >= n_valid read as 0 (the zero padding of the packed format).
struct RowQ {
  uint32_t packed[4];   // four int8 q per word, little-endian column order
  float scale;
};

__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        long long at, long long n_valid) {
  if (at + 3 < n_valid) return *reinterpret_cast<const float4*>(x + at);
  float4 v;
  v.x = at < n_valid ? x[at] : 0.f;
  v.y = at + 1 < n_valid ? x[at + 1] : 0.f;
  v.z = at + 2 < n_valid ? x[at + 2] : 0.f;
  v.w = at + 3 < n_valid ? x[at + 3] : 0.f;
  return v;
}

__device__ __forceinline__ uint32_t q8(float v, float scale) {
  // correctly rounded divide, round half to even, clip to [-127, 127]
  float r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(r)));
}

__device__ __forceinline__ RowQ quant_row(const float* __restrict__ x,
                                          long long row, long long n_valid) {
  const int lane = threadIdx.x & 31;
  const long long base = row * LANE_COLS;
  float4 v[4];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = load4(x, base + 4 * (j * 32 + lane), n_valid);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[j].x), fabsf(v[j].y)),
                             fmaxf(fabsf(v[j].z), fabsf(v[j].w))));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  RowQ out;
  // absmax * f32(1/127) as one rounded multiply; 1.0 for an all-zero row
  out.scale = amax > 0.f ? __fmul_rn(amax, (float)(1.0 / 127.0)) : 1.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out.packed[j] = q8(v[j].x, out.scale) | (q8(v[j].y, out.scale) << 8) |
                    (q8(v[j].z, out.scale) << 16) |
                    (q8(v[j].w, out.scale) << 24);
  return out;
}
