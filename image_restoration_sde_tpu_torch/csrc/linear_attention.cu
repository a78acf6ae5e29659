// Packed all-heads linear attention on the qkv projection (B, N, 3*hid),
// hid = heads * 32, channels ordered [q heads | k heads | v heads]:
//
//   context (K2a):  ctxT[b,h,e,d] = sum_n softmax_N(k)[n,d] * v[n,e] / N
//   apply   (K2b):  out[b,n,h*32+e] = sum_d softmax_d(q)[n,d] * 32^-1/2 * ctxT[b,h,e,d]
//
// (d, e index the 32 channels of head h.)  Replaces the two Pallas TPU
// kernels of image_restoration_sde_tpu/ops/linear_attention.py:_pallas_packed
// (_ctx_kernel and _apply_kernel).  The TPU version computes all four heads
// as one 128x128 block and masks the cross-head terms; they are exactly zero,
// so here each head's 32x32 block is computed alone.
//
// Bound on the H100: bytes.  The context pass reads k and v once (k twice
// within a block's slice, the second time from L1/L2) for 2*32 FLOP per
// element read; the apply pass reads q and writes out for 2*32 FLOP per
// element: both far below the ~295 FLOP/byte bf16 ridge.  Design:
//
// - K2a splits N into slices of kSliceRows rows so that B*heads*slices
//   blocks fill the card.  Each block takes its slice's per-channel max
//   (first pass), then accumulates exp(k - max) and the 32x32 outer
//   products from shared-memory tiles (second pass), and writes
//   (max, sum, acc) to a workspace.  The last block of each (b, h) to finish
//   (counted with an atomic) rescales the slices to the common max and writes
//   ctxT, with 1/N and 1/sum folded into the finish.  The combine visits the
//   slices in order, so the result does not depend on which block is last.
// - K2b gives one warp to each (row, head): one lane per channel d, so the
//   per-head max and sum are warp shuffles (the softmax is shifted by the
//   head's own max), then the head's 32x32 ctx block from shared memory
//   gives the 32 outputs.
// - Any N is taken; the ragged edge is masked.
//
// Left for later: the outer products run on CUDA cores, not wgmma/mma; the
// tiles are loaded with plain loads, not TMA or cp.async.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int DH = 32;  // dim_head: one lane per channel of a head
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ K2a: context
constexpr int kCtxThreads = 256;
constexpr int kCtxWarps = kCtxThreads / 32;
constexpr int kTile = 64;         // rows per shared-memory tile
constexpr int kSliceRows = 512;   // rows of N per block
constexpr int kPartFloats = DH + DH + DH * DH;  // max, sum, acc[d][e]

template <typename T>
__global__ void __launch_bounds__(kCtxThreads)
la_ctx_kernel(const T* __restrict__ qkv, float* __restrict__ ctx, float* __restrict__ ws,
              unsigned* __restrict__ done, int N, int heads) {
  const int slice = blockIdx.x, nslices = gridDim.x;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int hid = heads * DH;
  const long long rs = 3LL * hid;  // row stride
  const T* kp = qkv + (long long)b * N * rs + hid + h * DH;
  const T* vp = kp + hid;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_lo = slice * kSliceRows;
  const int n_hi = min(N, n_lo + kSliceRows);

  __shared__ float red[kCtxWarps][DH];
  __shared__ float col[DH];
  __shared__ float ks[kTile][DH];
  __shared__ __align__(16) float vs[kTile][DH];
  __shared__ bool is_last;

  // pass 1: per-channel max of k over the slice (lane = channel)
  float m = -INFINITY;
  for (int n = n_lo + warp; n < n_hi; n += kCtxWarps) m = fmaxf(m, to_f32(kp[n * rs + lane]));
  red[warp][lane] = m;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int w = 1; w < kCtxWarps; ++w) m = fmaxf(m, red[w][lane]);
    col[lane] = m;
  }
  __syncthreads();
  const float mc = col[lane];  // loads below always read channel `lane`

  // pass 2: s[d] = sum_n e[n,d], acc[d][e] = sum_n e[n,d] v[n,e]
  const int d = tid >> 3, e0 = (tid & 7) * 4;  // this thread's 4 outputs
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float s = 0.f;
  for (int t0 = n_lo; t0 < n_hi; t0 += kTile) {
    for (int r = warp; r < kTile; r += kCtxWarps) {
      const int n = t0 + r;
      float kv = 0.f, vv = 0.f;
      if (n < n_hi) {
        kv = expf(to_f32(kp[n * rs + lane]) - mc);
        vv = to_f32(vp[n * rs + lane]);
      }
      ks[r][lane] = kv;
      vs[r][lane] = vv;
      s += kv;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      const float kd = ks[r][d];
      const float4 v4 = *reinterpret_cast<const float4*>(&vs[r][e0]);
      acc[0] += kd * v4.x;
      acc[1] += kd * v4.y;
      acc[2] += kd * v4.z;
      acc[3] += kd * v4.w;
    }
    __syncthreads();
  }
  red[warp][lane] = s;
  __syncthreads();

  float* part = ws + ((long long)bh * nslices + slice) * kPartFloats;
  if (warp == 0) {
#pragma unroll
    for (int w = 1; w < kCtxWarps; ++w) s += red[w][lane];
    part[lane] = mc;
    part[DH + lane] = s;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part[2 * DH + d * DH + e0 + j] = acc[j];

  // the last block of this (b, h) to finish combines the slices
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&done[bh], 1u) == (unsigned)(nslices - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  const float* parts = ws + (long long)bh * nslices * kPartFloats;
  if (tid < DH) {
    float mx = -INFINITY;
    for (int p = 0; p < nslices; ++p) mx = fmaxf(mx, __ldcg(parts + p * kPartFloats + tid));
    float tot = 0.f;
    for (int p = 0; p < nslices; ++p) {
      const float* q = parts + p * kPartFloats;
      tot += __ldcg(q + DH + tid) * expf(__ldcg(q + tid) - mx);
    }
    red[0][tid] = mx;
    red[1][tid] = tot;
  }
  __syncthreads();
  const float mx = red[0][d];
  float out[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p = 0; p < nslices; ++p) {
    const float* q = parts + p * kPartFloats;
    const float c = expf(__ldcg(q + d) - mx);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] += __ldcg(q + 2 * DH + d * DH + e0 + j) * c;
  }
  const float denom = red[1][d] * (float)N;
  float* o = ctx + (long long)bh * DH * DH;  // [e][d]
#pragma unroll
  for (int j = 0; j < 4; ++j) o[(e0 + j) * DH + d] = out[j] / denom;
}

// -------------------------------------------------------------- K2b: apply
constexpr int kApplyThreads = 256;
constexpr int kApplyWarps = kApplyThreads / 32;
constexpr int kApplyRows = 64;  // rows of N per block

template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
la_apply_kernel(const T* __restrict__ qkv, const float* __restrict__ ctx, T* __restrict__ out,
                int N, int heads) {
  extern __shared__ float cs[];  // [h][e][DH + 1], padded against bank conflicts
  const int b = blockIdx.y, n0 = blockIdx.x * kApplyRows;
  const int hid = heads * DH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* cb = ctx + (long long)b * heads * DH * DH;
  for (int i = tid; i < heads * DH * DH; i += kApplyThreads) cs[(i / DH) * (DH + 1) + i % DH] = cb[i];
  __syncthreads();

  const float scale = 0.17677669529663687f;  // 32 ** -0.5
  for (int task = warp; task < kApplyRows * heads; task += kApplyWarps) {
    const int n = n0 + task / heads, h = task % heads;
    if (n >= N) break;  // tasks run in row order: the rest are past N too
    const long long row = (long long)b * N + n;
    const float q = to_f32(qkv[row * 3 * hid + h * DH + lane]);
    const float e = expf(q - warp_max(q));
    const float qs = e / warp_sum(e) * scale;
    const float* c = cs + (h * DH + lane) * (DH + 1);
    float acc = 0.f;
#pragma unroll
    for (int dd = 0; dd < DH; ++dd) acc += __shfl_sync(FULL, qs, dd) * c[dd];
    out[row * hid + h * DH + lane] = from_f32<T>(acc);
  }
}

template <typename T>
void launch_ctx(const void* qkv, void* ctx, void* ws, void* done, int B, int N, int heads,
                cudaStream_t s) {
  const dim3 grid((N + kSliceRows - 1) / kSliceRows, B * heads);
  la_ctx_kernel<T><<<grid, kCtxThreads, 0, s>>>(static_cast<const T*>(qkv), static_cast<float*>(ctx),
                                              static_cast<float*>(ws), static_cast<unsigned*>(done),
                                              N, heads);
}

template <typename T>
void launch_apply(const void* qkv, const void* ctx, void* out, int B, int N, int heads,
                  cudaStream_t s) {
  const dim3 grid((N + kApplyRows - 1) / kApplyRows, B);
  const size_t smem = (size_t)heads * DH * (DH + 1) * sizeof(float);
  la_apply_kernel<T><<<grid, kApplyThreads, smem, s>>>(static_cast<const T*>(qkv),
                                                     static_cast<const float*>(ctx),
                                                     static_cast<T*>(out), N, heads);
}

}  // namespace

// Workspace floats the context pass needs (the caller allocates them, plus
// B*heads zeroed unsigned counters).
extern "C" long long irsde_la_ctx_workspace(int B, int N, int heads) {
  return (long long)B * heads * ((N + kSliceRows - 1) / kSliceRows) * kPartFloats;
}

extern "C" int irsde_la_ctx(const void* qkv, void* ctx, void* ws, void* done, int B, int N,
                            int heads, int dtype, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || B * heads > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == IRSDE_BF16)
    launch_ctx<__nv_bfloat16>(qkv, ctx, ws, done, B, N, heads, s);
  else if (dtype == IRSDE_F32)
    launch_ctx<float>(qkv, ctx, ws, done, B, N, heads, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int irsde_la_apply(const void* qkv, const void* ctx, void* out, int B, int N,
                              int heads, int dtype, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || B > 65535 || heads * DH * (DH + 1) * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == IRSDE_BF16)
    launch_apply<__nv_bfloat16>(qkv, ctx, out, B, N, heads, s);
  else if (dtype == IRSDE_F32)
    launch_apply<float>(qkv, ctx, out, B, N, heads, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
