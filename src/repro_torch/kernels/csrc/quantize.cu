// Blockwise int8 quantize / dequantize of checkpoint tensors (one group = one
// 512-value row, one f32 scale per row) — the PQ8P payload of quant_codec.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

// Replaces repro/kernels/quantize.py: quantize_blocks (_quant_kernel, math in
// quant_rows). Bound on the H100: bytes — 4 B read and ~1 B written per value,
// a handful of float ops each. Design: one warp per row (512 values = 16 per
// lane as four 16-byte loads), absmax by warp shuffle, q stored as 4-byte
// words so a warp writes 128 contiguous bytes per store; 8 rows per block.
// The zero padding of the packed format (values past n_valid) is virtual —
// the source is never copied into a padded buffer.
__global__ void quantize_kernel(const float* __restrict__ x, long long n_valid,
                                long long rows, uint32_t* __restrict__ q,
                                float* __restrict__ s) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const RowQ r = quant_row(x, row, n_valid);
  uint32_t* qrow = q + row * (LANE_COLS / 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) qrow[j * 32 + lane] = r.packed[j];
  if (lane == 0) s[row] = r.scale;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ double from_f32<double>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Replaces repro/kernels/quantize.py: dequantize_blocks (_dequant_kernel);
// restore decode in repro/core/quant_codec.py (dequantize_blocks_ref in f32,
// then a host cast to the saved dtype) — same bits: one rounded f32 multiply,
// then one round-to-nearest-even cast. Bound: bytes — 1 B read and 4 B
// written per f32 value. Design: each thread decodes 4 values from one 4-byte
// q word and writes them as one 16-byte store (f32); only the first n_out
// values are produced, so the padding never reaches device memory.
template <typename T>
__global__ void dequantize_kernel(const uint32_t* __restrict__ q,
                                  const float* __restrict__ s, long long n_out,
                                  T* __restrict__ out) {
  const long long groups = (n_out + 3) / 4;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    const uint32_t w = q[g];
    const float sc = s[(4 * g) / LANE_COLS];   // 4 values never straddle rows
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __fmul_rn((float)(int8_t)((w >> (8 * k)) & 0xffu), sc);
    const long long at = 4 * g;
    if constexpr (sizeof(T) == 4) {
      if (at + 3 < n_out) {
        reinterpret_cast<float4*>(out)[g] = make_float4(v[0], v[1], v[2], v[3]);
        continue;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (at + k < n_out) out[at + k] = from_f32<T>(v[k]);
  }
}

extern "C" {

int rt_quantize_blocks(const float* x, long long n_valid, long long rows,
                       void* q, float* s, cudaStream_t stream) {
  const long long per = THREADS / 32;
  const long long blocks = (rows + per - 1) / per;
  if (blocks > 0)
    quantize_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        x, n_valid, rows, static_cast<uint32_t*>(q), s);
  return (int)cudaGetLastError();
}

// out_dtype: 0 float32, 1 float16, 2 bfloat16, 3 float64
int rt_dequantize_blocks(const void* q, const float* s, long long n_out,
                         int out_dtype, void* out, cudaStream_t stream) {
  const long long groups = (n_out + 3) / 4;
  long long blocks = (groups + THREADS - 1) / THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  if (blocks == 0) return (int)cudaGetLastError();
  const uint32_t* qw = static_cast<const uint32_t*>(q);
  switch (out_dtype) {
    case 0:
      dequantize_kernel<float><<<(unsigned)blocks, THREADS, 0, stream>>>(
          qw, s, n_out, static_cast<float*>(out));
      break;
    case 1:
      dequantize_kernel<__half><<<(unsigned)blocks, THREADS, 0, stream>>>(
          qw, s, n_out, static_cast<__half*>(out));
      break;
    case 2:
      dequantize_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0,
                                         stream>>>(
          qw, s, n_out, static_cast<__nv_bfloat16*>(out));
      break;
    case 3:
      dequantize_kernel<double><<<(unsigned)blocks, THREADS, 0, stream>>>(
          qw, s, n_out, static_cast<double*>(out));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
