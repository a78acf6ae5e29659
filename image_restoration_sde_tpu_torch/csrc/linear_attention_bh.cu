// Linear attention per (batch*head) slice, on separate q, k, v of shape
// (BH, N, D) with D in {16, 32, 64}:
//
//   context (pass 1):  ctx[bh,d,e] = sum_n softmax_N(k)[n,d] * v[n,e] / N
//   apply   (pass 2):  out[bh,n,e] = sum_d softmax_d(q)[n,d] * D^-1/2 * ctx[bh,d,e]
//
// Replaces the two Pallas TPU kernels of
// image_restoration_sde_tpu/ops/linear_attention.py: _kernel (:46, the whole
// (N, D) slice resident in VMEM, taken when N*D*4 <= 1 MiB and N % 128 == 0)
// and _stream_kernel (:102, N tiled in two phases, taken when N % 2048 == 0
// above that).  They compute one function; which of them runs is a VMEM
// figure, so here one design takes any N (the ragged edge masked) and the
// JAX op's composition fallback above both budgets has no counterpart.
//
// Bound on the H100: bytes.  Pass 1 reads k and v once for ~2*D FLOP per
// element read, pass 2 reads q and writes out for ~2*D FLOP per element:
// 2*D <= 128 FLOP per element, far below the ~295 FLOP/byte bf16 ridge.
// Design, K2's (linear_attention.cu) for one head per slice and any D:
//
// - Pass 1 splits N into slices of whole 64-row tiles, enough of them that
//   BH * slices reaches two blocks per SM (BH = 32 at the deraining UNet's
//   levels would fill a quarter of the card with one block per slice).
//   Each block takes its slice's per-channel max of k (first sweep), then
//   accumulates exp(k - max) and the D x D outer products with v from
//   shared-memory tiles (second sweep), and writes (max, sum, acc) to a
//   workspace.  The last block of each slice row to finish (counted with
//   one atomic increment, which orders nothing numeric) rescales the
//   slices to the common max in slice order and writes ctx with 1/N and
//   1/sum folded in: no float atomics, so the result does not depend on
//   which block finishes last.
// - Pass 2 gives each row min(D, 32) lanes of a warp (two rows per warp at
//   D = 16, two channels per lane at D = 64): the row's max and sum are
//   shuffles within the lane group, and ctx[bh] from shared memory gives
//   the row's D outputs.
//
// Left for later: the outer products run on CUDA cores, not mma/wgmma; the
// tiles are loaded with plain loads, not TMA or cp.async.

#include <math.h>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;           // rows of k and v per shared-memory tile
constexpr int kTargetBlocks = 264;  // two context blocks per SM of the H100's 132
constexpr int kApplyRows = 64;      // rows of N per apply block

// Rows of N per context block: whole tiles, enough slices that BH * slices
// reaches kTargetBlocks where N allows.
int slice_rows(int BH, int N) {
  const int want = (kTargetBlocks + BH - 1) / BH;
  const int rows = (N + want - 1) / want;
  return (rows + kTile - 1) / kTile * kTile;
}

int num_slices(int BH, int N) {
  const int rows = slice_rows(BH, N);
  return (N + rows - 1) / rows;
}

__host__ __device__ constexpr int part_floats(int D) { return 2 * D + D * D; }  // max, sum, acc[d][e]

template <int D>
__host__ __device__ constexpr float inv_sqrt() {
  return D == 16 ? 0.25f : D == 32 ? 0.17677669529663687f : 0.125f;
}

// ------------------------------------------------------------ pass 1: context
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
lin_attn_ctx_kernel(const T* __restrict__ k, const T* __restrict__ v, float* __restrict__ ctx,
                    float* __restrict__ ws, unsigned* __restrict__ done, int N, int rows_per_slice) {
  static_assert(kThreads % D == 0 && D % (kThreads / D) == 0, "D must divide the block evenly");
  constexpr int TPR = kThreads / D;  // threads per row d of acc
  constexpr int EPT = D / TPR;       // acc entries per thread
  constexpr int PF = part_floats(D);
  const int slice = blockIdx.x, nslices = gridDim.x, bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int col = tid % D;  // every load of this thread reads channel `col`
  const int n_lo = slice * rows_per_slice;
  const int n_hi = min(N, n_lo + rows_per_slice);
  const T* kp = k + (long long)bh * N * D;
  const T* vp = v + (long long)bh * N * D;

  __shared__ float red[TPR][D];
  __shared__ float colmax[D];
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];
  __shared__ bool is_last;

  // first sweep: per-channel max of k over the slice (consecutive threads
  // read consecutive elements of the slice's contiguous rows)
  float m = -INFINITY;
  for (long long i = (long long)n_lo * D + tid; i < (long long)n_hi * D; i += kThreads)
    m = fmaxf(m, to_f32(kp[i]));
  red[tid / D][col] = m;
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int w = 1; w < TPR; ++w) m = fmaxf(m, red[w][tid]);
    colmax[tid] = m;
  }
  __syncthreads();
  const float mc = colmax[col];

  // second sweep: s[col] = sum_n e[n,col]; acc[d][e] = sum_n e[n,d] v[n,e]
  const int d = tid / TPR, e0 = (tid % TPR) * EPT;  // this thread's EPT outputs
  float acc[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) acc[j] = 0.f;
  float s = 0.f;
  for (int t0 = n_lo; t0 < n_hi; t0 += kTile) {
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int n = t0 + i / D;
      float kv = 0.f, vv = 0.f;
      if (n < n_hi) {
        kv = expf(to_f32(kp[(long long)n * D + col]) - mc);
        vv = to_f32(vp[(long long)n * D + col]);
      }
      ks[i / D][col] = kv;
      vs[i / D][col] = vv;
      s += kv;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      const float kd = ks[r][d];
      if constexpr (EPT >= 4) {
#pragma unroll
        for (int j = 0; j < EPT; j += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(&vs[r][e0 + j]);
          acc[j] += kd * v4.x;
          acc[j + 1] += kd * v4.y;
          acc[j + 2] += kd * v4.z;
          acc[j + 3] += kd * v4.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < EPT; ++j) acc[j] += kd * vs[r][e0 + j];
      }
    }
    __syncthreads();
  }
  red[tid / D][col] = s;
  __syncthreads();

  float* part = ws + ((long long)bh * nslices + slice) * PF;
  if (tid < D) {
#pragma unroll
    for (int w = 1; w < TPR; ++w) s += red[w][tid];
    part[tid] = mc;
    part[D + tid] = s;
  }
#pragma unroll
  for (int j = 0; j < EPT; ++j) part[2 * D + d * D + e0 + j] = acc[j];

  // the last block of this bh to finish combines the slices, in slice order
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&done[bh], 1u) == (unsigned)(nslices - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  const float* parts = ws + (long long)bh * nslices * PF;
  if (tid < D) {
    float mx = -INFINITY;
    for (int p = 0; p < nslices; ++p) mx = fmaxf(mx, __ldcg(parts + p * PF + tid));
    float tot = 0.f;
    for (int p = 0; p < nslices; ++p) {
      const float* q = parts + p * PF;
      tot += __ldcg(q + D + tid) * expf(__ldcg(q + tid) - mx);
    }
    colmax[tid] = mx;
    red[0][tid] = tot;
  }
  __syncthreads();
  const float mx = colmax[d];
  float out[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) out[j] = 0.f;
  for (int p = 0; p < nslices; ++p) {
    const float* q = parts + p * PF;
    const float c = expf(__ldcg(q + d) - mx);
#pragma unroll
    for (int j = 0; j < EPT; ++j) out[j] += __ldcg(q + 2 * D + d * D + e0 + j) * c;
  }
  const float denom = red[0][d] * (float)N;
  float* o = ctx + (long long)bh * D * D;  // [d][e]
#pragma unroll
  for (int j = 0; j < EPT; ++j) o[d * D + e0 + j] = out[j] / denom;
}

// -------------------------------------------------------------- pass 2: apply
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
lin_attn_apply_kernel(const T* __restrict__ q, const float* __restrict__ ctx, T* __restrict__ out,
                      int N) {
  constexpr int LPR = D < 32 ? D : 32;  // lanes per row
  constexpr int CPL = D / LPR;          // channels per lane: lane l holds l, l + 32
  constexpr int RPW = 32 / LPR;         // rows per warp at a time
  __shared__ float cs[D * D];           // ctx[bh] as [d][e]: lanes read consecutive e
  const int bh = blockIdx.y, n0 = blockIdx.x * kApplyRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPR, l = lane % LPR;

  const float* cb = ctx + (long long)bh * D * D;
  for (int i = tid; i < D * D; i += kThreads) cs[i] = cb[i];
  __syncthreads();

  for (int r = warp * RPW; r < kApplyRows; r += kWarps * RPW) {
    const int n = n0 + r + sub;
    if (n0 + r >= N) break;    // rows run in order: the warp's later rows are past N too
    const bool valid = n < N;  // the second row of a D = 16 pair may be past N
    const long long base = ((long long)bh * N + n) * D + l;
    float qv[CPL];
    float mq = -INFINITY;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      qv[c] = valid ? to_f32(q[base + c * LPR]) : 0.f;
      mq = fmaxf(mq, qv[c]);
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) mq = fmaxf(mq, __shfl_xor_sync(FULL, mq, o, LPR));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      qv[c] = expf(qv[c] - mq);
      sum += qv[c];
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o, LPR);
#pragma unroll
    for (int c = 0; c < CPL; ++c) qv[c] = qv[c] / sum * inv_sqrt<D>();

    float acc[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      const float qd = __shfl_sync(FULL, qv[dd / LPR], dd % LPR, LPR);
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] += qd * cs[dd * D + l + c * LPR];
    }
    if (valid) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) out[base + c * LPR] = from_f32<T>(acc[c]);
    }
  }
}

template <typename T, int D>
void launch_ctx(const void* k, const void* v, void* ctx, void* ws, void* done, int BH, int N,
                cudaStream_t s) {
  const int rows = slice_rows(BH, N);
  const dim3 grid((N + rows - 1) / rows, BH);
  lin_attn_ctx_kernel<T, D><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<float*>(ctx),
      static_cast<float*>(ws), static_cast<unsigned*>(done), N, rows);
}

template <typename T, int D>
void launch_apply(const void* q, const void* ctx, void* out, int BH, int N, cudaStream_t s) {
  const dim3 grid((N + kApplyRows - 1) / kApplyRows, BH);
  lin_attn_apply_kernel<T, D><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const float*>(ctx), static_cast<T*>(out), N);
}

template <typename T>
bool dispatch_ctx(const void* k, const void* v, void* ctx, void* ws, void* done, int BH, int N,
                  int D, cudaStream_t s) {
  switch (D) {
    case 16: launch_ctx<T, 16>(k, v, ctx, ws, done, BH, N, s); return true;
    case 32: launch_ctx<T, 32>(k, v, ctx, ws, done, BH, N, s); return true;
    case 64: launch_ctx<T, 64>(k, v, ctx, ws, done, BH, N, s); return true;
    default: return false;
  }
}

template <typename T>
bool dispatch_apply(const void* q, const void* ctx, void* out, int BH, int N, int D, cudaStream_t s) {
  switch (D) {
    case 16: launch_apply<T, 16>(q, ctx, out, BH, N, s); return true;
    case 32: launch_apply<T, 32>(q, ctx, out, BH, N, s); return true;
    case 64: launch_apply<T, 64>(q, ctx, out, BH, N, s); return true;
    default: return false;
  }
}

}  // namespace

// Workspace floats the context pass needs (the caller allocates them, plus
// BH zeroed unsigned counters).
extern "C" long long irsde_lin_attn_ctx_workspace(int BH, int N, int D) {
  return (long long)BH * num_slices(BH, N) * part_floats(D);
}

extern "C" int irsde_lin_attn_ctx(const void* k, const void* v, void* ctx, void* ws, void* done,
                                  int BH, int N, int D, int dtype, void* stream) {
  if (BH <= 0 || BH > 65535 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == IRSDE_BF16)
    ok = dispatch_ctx<__nv_bfloat16>(k, v, ctx, ws, done, BH, N, D, s);
  else if (dtype == IRSDE_F32)
    ok = dispatch_ctx<float>(k, v, ctx, ws, done, BH, N, D, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int irsde_lin_attn_apply(const void* q, const void* ctx, void* out, int BH, int N, int D,
                                    int dtype, void* stream) {
  if (BH <= 0 || BH > 65535 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == IRSDE_BF16)
    ok = dispatch_apply<__nv_bfloat16>(q, ctx, out, BH, N, D, s);
  else if (dtype == IRSDE_F32)
    ok = dispatch_apply<float>(q, ctx, out, BH, N, D, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
