// Channel LayerNorm over the last axis of a row-major (rows, C) tensor:
//
//     y = (x - mean_C) * rsqrt(var_C + eps) * g,   f32 statistics,
//     y in the input's dtype (float32 or bfloat16), g float32.
//
// Replaces the Pallas TPU kernel image_restoration_sde_tpu/ops/layernorm.py
// (_kernel, launched by _pallas_ln).
//
// Bound on the H100: bytes.  One read and one write of the activation for
// ~8 FLOP per element, far below the ~295 FLOP/byte bf16 ridge, so the
// design is about keeping enough 16-byte loads in flight on every SM:
//
// - A row gets a group of G lanes, G = C/VEC rounded up to a power of two
//   (VEC = 8 bf16 or 4 float32 elements per 16-byte vector), and a warp
//   holds 32/G rows, so narrow rows (C = 64 bf16: 8 lanes) fill the warp.
//   Lanes past C/VEC are masked (C = 96, 192, 320 bf16).  Above 32 vectors
//   a row takes the whole warp with NV vectors per lane.
// - Each lane group takes R rows per iteration and issues all of their
//   loads before the first reduction: 64 bytes in flight per thread where
//   the site is large enough to keep the card busy that way.
// - The thread's slice of g is read into registers once, before the loop.
// - Rows per CTA follow from `rows`: R = 1 at small sites, so that 2048
//   rows still spread over the SMs; large sites run a grid of at most the
//   CTAs the card holds at once, each walking its rows with a grid stride.
// - The row stays in registers, so the activation crosses device memory
//   once each way.  The variance is taken in two passes over the registers
//   (mean first, then the centred sum of squares), not as E[x^2] - mean^2,
//   which cancels on residual-stream rows whose mean is large.
//
// Left for later: fusing the norm with the ops around it (the residual add
// before and the casts after), and overlapping the prologue with the
// previous kernel's tail (programmatic dependent launch).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 16;

// G lanes per row, NV 16-byte vectors per lane, R rows per lane group and
// iteration
template <typename T, int G, int NV, int R>
__global__ void __launch_bounds__(kThreads)
channel_layernorm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                         T* __restrict__ y, long long rows, int C, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RPW = 32 / G;       // rows a warp holds at once
  constexpr int ROWS = RPW * R;     // rows a warp takes per iteration
  const int lane = threadIdx.x & 31, l = lane % G, sub = lane / G;
  const int nvec = C / VEC;
  const float inv_c = 1.f / (float)C;

  float gv[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = l + G * i;
#pragma unroll
    for (int j = 0; j < VEC; ++j) gv[i][j] = idx < nvec ? __ldg(g + idx * VEC + j) : 0.f;
  }

  const long long warps = (long long)gridDim.x * kWarps;
  for (long long it = (long long)blockIdx.x * kWarps + threadIdx.x / 32; it * ROWS < rows; it += warps) {
    const long long row0 = it * ROWS + sub;  // this group's rows: row0 + RPW * r
    uint4 raw[R][NV];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = row0 + (long long)RPW * r;
      const uint4* xr = reinterpret_cast<const uint4*>(x + row * C);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int idx = l + G * i;
        raw[r][i] = row < rows && idx < nvec ? __ldg(xr + idx) : make_uint4(0u, 0u, 0u, 0u);
      }
    }

    float v[R][NV][VEC];
    float sum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sum[r] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const T* e = reinterpret_cast<const T*>(&raw[r][i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          v[r][i][j] = to_f32(e[j]);
          sum[r] += v[r][i][j];
        }
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o, G);

    float sq[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mean = sum[r] * inv_c;
      sq[r] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (l + G * i < nvec) {  // masked lanes hold zeros, not -mean
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            v[r][i][j] -= mean;
            sq[r] += v[r][i][j] * v[r][i][j];
          }
        }
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], o, G);

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = row0 + (long long)RPW * r;
      const float rstd = rsqrtf(sq[r] * inv_c + eps);
      uint4* yr = reinterpret_cast<uint4*>(y + row * C);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int idx = l + G * i;
        if (row < rows && idx < nvec) {
          uint4 out;
          T* e = reinterpret_cast<T*>(&out);
#pragma unroll
          for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(v[r][i][j] * rstd * gv[i][j]);
          yr[idx] = out;
        }
      }
    }
  }
}

// The card's SMs and how many CTAs of this instantiation each holds, once
// per device.
template <typename T, int G, int NV, int R>
cudaError_t occupancy(int* sms, int* per_sm) {
  static int cache[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev][0] == 0) {
    if ((err = cudaDeviceGetAttribute(&cache[dev][1], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cache[dev][0], channel_layernorm_kernel<T, G, NV, R>,
                                                             kThreads, 0)) != cudaSuccess)
      return err;
    if (cache[dev][0] < 1) return cudaErrorLaunchOutOfResources;
  }
  *per_sm = cache[dev][0];
  *sms = cache[dev][1];
  return cudaSuccess;
}

// At most one wave of CTAs, each walking its rows with a grid stride.
template <typename T, int G, int NV, int R>
cudaError_t run(const T* x, const float* g, T* y, long long rows, int C, float eps, int sms, int per_sm,
                cudaStream_t s) {
  constexpr long long rows_per_cta = (long long)kWarps * (32 / G) * R;
  const long long want = (rows + rows_per_cta - 1) / rows_per_cta, cap = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  channel_layernorm_kernel<T, G, NV, R><<<grid, kThreads, 0, s>>>(x, g, y, rows, C, eps);
  return cudaSuccess;
}

// R = 4 rows per lane group (2 at two vectors a lane, 1 above) where each
// SM still gets kBusyWarps warp iterations that way; else R = 1, so that a
// small site spreads over as many SMs as it can.
constexpr int kBusyWarps = 8;

template <typename T, int G, int NV>
cudaError_t pick_rows(const T* x, const float* g, T* y, long long rows, int C, float eps, cudaStream_t s) {
  constexpr int RMAX = NV >= 4 ? 1 : 4 / NV;
  int sms = 0, per_sm = 0;
  cudaError_t err = occupancy<T, G, NV, RMAX>(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  if (RMAX > 1 && rows >= (long long)(32 / G) * RMAX * kBusyWarps * sms)
    return run<T, G, NV, RMAX>(x, g, y, rows, C, eps, sms, per_sm, s);
  if ((err = occupancy<T, G, NV, 1>(&sms, &per_sm)) != cudaSuccess) return err;
  return run<T, G, NV, 1>(x, g, y, rows, C, eps, sms, per_sm, s);
}

template <typename T>
cudaError_t launch(const void* xv, const void* gv, void* yv, long long rows, int C, float eps,
                   cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (C <= 0 || C % VEC != 0 || C * (int)sizeof(T) > 4096) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  const float* g = static_cast<const float*>(gv);
  T* y = static_cast<T*>(yv);
  const int nvec = C / VEC;  // 1..256
  if (nvec <= 1) return pick_rows<T, 1, 1>(x, g, y, rows, C, eps, s);
  if (nvec <= 2) return pick_rows<T, 2, 1>(x, g, y, rows, C, eps, s);
  if (nvec <= 4) return pick_rows<T, 4, 1>(x, g, y, rows, C, eps, s);
  if (nvec <= 8) return pick_rows<T, 8, 1>(x, g, y, rows, C, eps, s);
  if (nvec <= 16) return pick_rows<T, 16, 1>(x, g, y, rows, C, eps, s);
  if (nvec <= 32) return pick_rows<T, 32, 1>(x, g, y, rows, C, eps, s);
  if (nvec <= 64) return pick_rows<T, 32, 2>(x, g, y, rows, C, eps, s);
  if (nvec <= 128) return pick_rows<T, 32, 4>(x, g, y, rows, C, eps, s);
  return pick_rows<T, 32, 8>(x, g, y, rows, C, eps, s);
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
