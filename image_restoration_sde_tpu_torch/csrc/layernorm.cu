// Channel LayerNorm over the last axis of a row-major (rows, C) tensor:
//
//     y = (x - mean_C) * rsqrt(var_C + eps) * g,   f32 statistics,
//     y in the input's dtype (float32 or bfloat16), g float32.
//
// Replaces the Pallas TPU kernel image_restoration_sde_tpu/ops/layernorm.py
// (_kernel, launched by _pallas_ln).
//
// Bound on the H100: bytes.  One read and one write of the activation for
// ~8 FLOP per element, far below the ~295 FLOP/byte bf16 ridge.  Design:
// one warp per row with 16-byte loads, the row held in registers, so the
// activation crosses device memory exactly once each way.  The variance is
// taken in two passes over the registers (mean first, then the centered sum
// of squares), not as E[x^2] - mean^2, which cancels on residual-stream rows
// whose mean is large.
//
// Left for later: rows of C = 64 use 8 of the 32 lanes; several rows per
// warp would fill them.  Loads are plain 16-byte loads, not TMA or
// cp.async, and nothing is fused with the ops around the norm.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

// NV: 16-byte vectors per lane (C <= 32 * NV * VEC)
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
channel_layernorm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                         T* __restrict__ y, long long rows, int C, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nvec = C / VEC;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * C);

  float v[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + 32 * i;
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[i][j] = 0.f;
    if (idx < nvec) {
      const uint4 raw = __ldg(xr + idx);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[i][j] = to_f32(e[j]);
        sum += v[i][j];
      }
    }
  }
  const float mean = warp_sum(sum) / (float)C;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[i][j] -= mean;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)C + eps);

  uint4* yr = reinterpret_cast<uint4*>(y + row * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + 32 * i;
    if (idx < nvec) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(v[i][j] * rstd * __ldg(g + idx * VEC + j));
      yr[idx] = raw;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, void* y, long long rows, int C,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (C <= 0 || C % VEC != 0 || C > 32 * 8 * VEC) return cudaErrorInvalidValue;
  const int per_lane = (C / VEC + 31) / 32;
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(g);
  T* yp = static_cast<T*>(y);
  if (per_lane <= 1)
    channel_layernorm_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xp, gp, yp, rows, C, eps);
  else if (per_lane <= 2)
    channel_layernorm_kernel<T, 2><<<grid, kThreads, 0, stream>>>(xp, gp, yp, rows, C, eps);
  else if (per_lane <= 4)
    channel_layernorm_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xp, gp, yp, rows, C, eps);
  else
    channel_layernorm_kernel<T, 8><<<grid, kThreads, 0, stream>>>(xp, gp, yp, rows, C, eps);
  return cudaSuccess;
}

}  // namespace

extern "C" int irsde_channel_layernorm(const void* x, const void* g, void* y,
                                       long long rows, int C, float eps, int dtype,
                                       void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == IRSDE_BF16 ? launch<__nv_bfloat16>(x, g, y, rows, C, eps, s)
                    : dtype == IRSDE_F32 ? launch<float>(x, g, y, rows, C, eps, s)
                                         : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* irsde_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
