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
// The design is K2's (linear_attention.cu, whose ring, TF32 split and
// mma.sync wrapper both files take from tf32_ring.cuh) for one head per
// slice and a D template:
//
// - Context: one cooperative launch, at most two CTAs per SM.  Each CTA
//   takes a slice of one bh's rows and streams k|v through a 3-stage ring
//   of 16-byte cp.async copies (16 KB of data a stage).  k is read once:
//   per tile a per-channel max, and the running sum and accumulator
//   rescaled by exp(m_old - m_new) when it grows, as _stream_kernel does.
//   The D x D outer products run on the tensor cores (mma.sync m16n8k8
//   TF32; a warp per 16 channels d and 32 channels e, and where D < 64 the
//   spare warps take their own share of each tile's rows), exp(k - m) split
//   into two TF32 parts and float32 v too: bf16 v is exact in TF32 (two
//   products), float32 v takes three.  Each tile's products go into float32
//   registers by plain adds.  The warps of a CTA that split the rows merge
//   their (max, sum, acc) in shared memory in warp order; each slice leaves
//   its partial in a workspace; after a grid barrier every CTA combines its
//   share of the channels, each over its share of the slices, in a fixed
//   order.  No counters, nothing to zero, and two runs are bit-equal.
// - Apply: CTAs stay resident and walk contiguous row tiles of q (all bh
//   in one sequence) through a 3-stage cp.async ring.  ctx[bh] is split
//   into TF32 hi and lo once per CTA and bh, laid out in shared memory in
//   mma fragment order (and held in registers where D <= 32).  A row is read
//   by four lanes, D/4 contiguous channels each; its max and sum over d are
//   two shuffles; the reduction index d and the output index e are permuted
//   inside the fragments so that each thread also writes D/4 contiguous
//   outputs.  qs and ctx are float32: three TF32 products.
//
// Left for later: the grid barrier and the combine set a floor of several
// microseconds at small BH * N; fusing the combine into the apply pass would
// remove it.

#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

#include "tf32_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kCtasPerSm = 2;
constexpr int kPad = 8;  // elements after each k|v tile row: a warp's fragment loads hit distinct banks

template <int D>
__host__ __device__ constexpr float inv_sqrt() {
  return D == 16 ? 0.25f : D == 32 ? 0.17677669529663687f : 0.125f;
}

__host__ __device__ constexpr int part_floats(int D) { return 2 * D + D * D; }  // max[d], sum[d], acc[d][e]

// ------------------------------------------------------------ pass 1: context
// Warp w takes task w % TASKS (16 channels d, 32 or D channels e) on rows
// [KW (w / TASKS), +KW) of each tile; RS = kWarps / TASKS row shares.  A
// tile holds 16 KB of k|v data: TR = KW * RS rows.
template <typename T, int D>
struct Ctx {
  static constexpr int EB = D > 32 ? D / 32 : 1;  // e blocks
  static constexpr int NJ = D > 32 ? 4 : D / 8;   // n tiles of 8 e per warp
  static constexpr int TASKS = (D / 16) * EB;
  static constexpr int RS = kWarps / TASKS;
  static constexpr int TR = 8192 / (D * (int)sizeof(T));
  static constexpr int KW = TR / RS;
  static constexpr int KS = KW / 8;
  static constexpr int PITCH = 2 * D + kPad;
  static constexpr int SMEM = kStages * TR * PITCH * (int)sizeof(T);
  static_assert(KW % 8 == 0 && RS * TASKS == kWarps, "tile shape");
  static_assert(RS == 1 || RS * (part_floats(D) + D) * 4 <= SMEM, "the merge fits in the ring");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
lin_attn_ctx_kernel(const T* __restrict__ k, const T* __restrict__ v, float* __restrict__ ctx,
                    float* __restrict__ ws, int BH, int N, int P, int slice_rows, int G) {
  using C = Ctx<T, D>;
  constexpr int PF = part_floats(D);
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kHalf = D / kVec;       // copies per row of k (and of v)
  constexpr int kChunks = 2 * kHalf;    // copies per tile row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* merge = reinterpret_cast<float*>(smem);  // after the ring drains: RS partials
  __shared__ float red_m[kWarps], red_s[kWarps], red_a[kWarps][D];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column
  const int task = warp % C::TASKS, rs = warp / C::TASKS;
  const int dg = task / C::EB, eb = task % C::EB;
  const int kc = dg * 16 + g;  // this thread's channels d: kc and kc + 8
  const int r0 = rs * C::KW;   // this warp's rows of each tile

  for (int item = blockIdx.x; item < BH * P; item += gridDim.x) {
    const int bh = item / P, slice = item - bh * P;
    const int n_lo = slice * slice_rows;
    const int rows = min(N - n_lo, slice_rows);
    const int tiles = (rows + C::TR - 1) / C::TR;
    const long long base = ((long long)bh * N + n_lo) * D;

    auto load_tile = [&](int tile) {
      T* st = ring + (tile % kStages) * C::TR * C::PITCH;
      for (int c = tid; c < C::TR * kChunks; c += kThreads) {
        const int r = c / kChunks, col = c - r * kChunks, n = tile * C::TR + r;
        const bool ok = n < rows;
        const T* src = (col < kHalf ? k + col * kVec : v + (col - kHalf) * kVec) + base + (long long)(ok ? n : 0) * D;
        cp_async16(smem_addr(st + r * C::PITCH + col * kVec), src, ok ? 16 : 0);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < tiles) load_tile(s);
      cp_async_commit();
    }

    float acc[C::NJ][4] = {};  // C fragments of acc[d][e]
    float m0 = -INFINITY, m1 = -INFINITY, s0 = 0.f, s1 = 0.f;  // channels kc, kc + 8
    for (int tile = 0; tile < tiles; ++tile) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (tile + kStages - 1 < tiles) load_tile(tile + kStages - 1);
      cp_async_commit();
      const T* st = ring + (tile % kStages) * C::TR * C::PITCH;
      const int valid = rows - tile * C::TR;

      // A = exp(k - m)^T: a0 (d=g, n=t), a1 (d=g+8, n=t), a2 (d=g, n=t+4), a3 (d=g+8, n=t+4)
      float kr[C::KS][4];
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks) {
        const int na = r0 + ks * 8 + t, nb = na + 4;
        kr[ks][0] = na < valid ? lds(st + na * C::PITCH + kc) : -INFINITY;
        kr[ks][1] = na < valid ? lds(st + na * C::PITCH + kc + 8) : -INFINITY;
        kr[ks][2] = nb < valid ? lds(st + nb * C::PITCH + kc) : -INFINITY;
        kr[ks][3] = nb < valid ? lds(st + nb * C::PITCH + kc + 8) : -INFINITY;
        t0 = fmaxf(t0, fmaxf(kr[ks][0], kr[ks][2]));
        t1 = fmaxf(t1, fmaxf(kr[ks][1], kr[ks][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, o));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, o));
      }
      // A warp's share of a tile may hold no valid row (the slice's last
      // tile): its max stays -inf and the shift is taken as 0, so every
      // exponential below is exp(-inf) = 0 and nothing is rescaled.
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      const float b0 = n0 == -INFINITY ? 0.f : n0, b1 = n1 == -INFINITY ? 0.f : n1;
      const float c0 = __expf(m0 - b0), c1 = __expf(m1 - b1);  // 1 when the max holds, 0 on the first rows
      m0 = n0;
      m1 = n1;
      s0 *= c0;
      s1 *= c1;
#pragma unroll
      for (int nj = 0; nj < C::NJ; ++nj) {
        acc[nj][0] *= c0;
        acc[nj][1] *= c0;
        acc[nj][2] *= c1;
        acc[nj][3] *= c1;
      }
      // this tile's products, added into acc by float32 adds (K2a's reason:
      // the tensor cores' accumulation rounds toward zero)
      float tacc[C::NJ][4] = {};
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks) {
        const int na = r0 + ks * 8 + t, nb = na + 4;
        float e[4];
        e[0] = __expf(kr[ks][0] - b0);  // masked rows: exp(-inf) = 0
        e[1] = __expf(kr[ks][1] - b1);
        e[2] = __expf(kr[ks][2] - b0);
        e[3] = __expf(kr[ks][3] - b1);
        s0 += e[0] + e[2];
        s1 += e[1] + e[3];
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(e[i], ah[i], al[i]);
#pragma unroll
        for (int nj = 0; nj < C::NJ; ++nj) {
          const int vc = D + eb * 32 + nj * 8 + g;  // B = v: b0 (n=t, e=g), b1 (n=t+4, e=g)
          const float v0 = lds(st + na * C::PITCH + vc), v1 = lds(st + nb * C::PITCH + vc);
          if constexpr (sizeof(T) == 2) {  // bf16 v is exact in TF32
            mma_tf32(tacc[nj], ah, __float_as_uint(v0), __float_as_uint(v1));
            mma_tf32(tacc[nj], al, __float_as_uint(v0), __float_as_uint(v1));
          } else {
            uint32_t vh0, vl0, vh1, vl1;
            split_tf32(v0, vh0, vl0);
            split_tf32(v1, vh1, vl1);
            mma_tf32(tacc[nj], ah, vh0, vh1);
            mma_tf32(tacc[nj], ah, vl0, vl1);
            mma_tf32(tacc[nj], al, vh0, vh1);
          }
        }
      }
#pragma unroll
      for (int nj = 0; nj < C::NJ; ++nj)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nj][i] += tacc[nj][i];
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: the merge or the next item may use it

#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    float* part = ws + (long long)item * PF;
    // with one row share a warp writes its partial to the workspace, else
    // to its slot in shared memory for the merge
    float* out = C::RS == 1 ? part : merge + rs * PF;
    if (t == 0 && eb == 0) {
      out[kc] = m0;
      out[kc + 8] = m1;
      out[D + kc] = s0;
      out[D + kc + 8] = s1;
    }
    float* pa = out + 2 * D + kc * D + eb * 32;  // acc[d = kc][e = eb * 32 + .]
#pragma unroll
    for (int nj = 0; nj < C::NJ; ++nj) {
      *reinterpret_cast<float2*>(pa + nj * 8 + 2 * t) = make_float2(acc[nj][0], acc[nj][1]);
      *reinterpret_cast<float2*>(pa + 8 * D + nj * 8 + 2 * t) = make_float2(acc[nj][2], acc[nj][3]);
    }
    if constexpr (C::RS > 1) {
      // merge the RS row shares in share order: (max, weights) per channel,
      // then the sums; the weights go where the maxima of share 0 were read
      __syncthreads();
      float* w = merge + C::RS * PF;  // w[rs][d], after the partials
      if (tid < D) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < C::RS; ++j) mx = fmaxf(mx, merge[j * PF + tid]);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < C::RS; ++j) {
          w[j * D + tid] = __expf(merge[j * PF + tid] - mx);  // a share with no rows: exp(-inf) = 0
          sum += merge[j * PF + D + tid] * w[j * D + tid];
        }
        part[tid] = mx;
        part[D + tid] = sum;
      }
      __syncthreads();
      for (int i = tid; i < D * D; i += kThreads) {
        const int d = i / D;
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < C::RS; ++j) a += merge[j * PF + 2 * D + i] * w[j * D + d];
        part[2 * D + i] = a;
      }
      __syncthreads();  // the ring is free for the next item
    }
  }

  cg::this_grid().sync();

  // Combine: G warps per channel (bh, d), each over its share of the P
  // slices, lanes over e; the shares are summed in warp order.
  constexpr int EPL = D > 32 ? D / 32 : 1;  // e per lane
  const int cpb = kWarps / G;               // channels per CTA pass
  const int cl = warp / G, gi = warp - cl * G;
  const int p0 = gi * P / G, p1 = (gi + 1) * P / G;
  for (int u = blockIdx.x; u < BH * D / cpb; u += gridDim.x) {
    const int chan = u * cpb + cl, bh = chan / D, d = chan - bh * D;
    const float* base = ws + (long long)bh * P * PF;
    float mx = -INFINITY;
    for (int p = p0 + lane; p < p1; p += 32) mx = fmaxf(mx, __ldcg(base + (long long)p * PF + d));
    mx = warp_max(mx);
    if (lane == 0) red_m[warp] = mx;
    __syncthreads();
    float M = -INFINITY;
    for (int j = 0; j < G; ++j) M = fmaxf(M, red_m[cl * G + j]);
    float sl = 0.f;
    for (int p = p0 + lane; p < p1; p += 32) {
      const float* q = base + (long long)p * PF;
      sl += __ldcg(q + D + d) * __expf(__ldcg(q + d) - M);
    }
    sl = warp_sum(sl);
    if (lane == 0) red_s[warp] = sl;
    float a[EPL] = {};
    if (lane < D) {
#pragma unroll 4
      for (int p = p0; p < p1; ++p) {
        const float* q = base + (long long)p * PF;
        const float c = __expf(__ldcg(q + d) - M);
#pragma unroll
        for (int j = 0; j < EPL; ++j) a[j] += __ldcg(q + 2 * D + d * D + lane + 32 * j) * c;
      }
#pragma unroll
      for (int j = 0; j < EPL; ++j) red_a[warp][lane + 32 * j] = a[j];
    }
    __syncthreads();
    if (gi == 0 && lane < D) {
      float S = 0.f;
      for (int j = 0; j < G; ++j) S += red_s[cl * G + j];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float tot = 0.f;
        for (int j = 0; j < G; ++j) tot += red_a[cl * G + j][lane + 32 * e];
        ctx[((long long)bh * D + d) * D + lane + 32 * e] = tot / (S * (float)N);  // [d][e]
      }
    }
    __syncthreads();
  }
}

// -------------------------------------------------------------- pass 2: apply
// A tile is 128 * MT rows: warp w takes the m tiles (16 rows) w + 8 i,
// i < MT.  In a row, thread t of a quad holds channels [D/4 t, D/4 (t+1)).
// The row pitch keeps a quarter warp's 16-byte shared loads (two rows, four
// threads) in distinct banks where a thread reads 16 or 32 bytes.
template <typename T, int D>
struct Apply {
  static constexpr int MT = sizeof(T) == 2 ? 64 / D : (D >= 32 ? 1 : 32 / D);
  static constexpr int TR = 128 * MT;
  static constexpr int ROW = D * (int)sizeof(T);  // bytes
  static constexpr int CB = ROW / 4;              // bytes per thread and row
  static constexpr int PITCH = CB >= 32 ? ROW + 16 : ROW;
  static constexpr int KS = D / 8;  // k steps
  static constexpr int NJ = D / 8;  // n tiles
  static constexpr int RING = kStages * TR * PITCH;
  static constexpr int SMEM = RING + KS * NJ * 32 * 16;  // + ctx split in fragment order
  static constexpr bool REG = D <= 32;                   // B fragments also in registers
  // CTAs an SM can hold by shared memory (227 KB, 1 KB reserved a CTA):
  // float32 at D = 64 takes one, and then all the registers it wants
  static constexpr int CTAS = 2 * (SMEM + 1024) <= 232448 ? kCtasPerSm : 1;
};

template <typename T, int NE>
__device__ __forceinline__ void lds_row(const T* p, float (&x)[NE]) {
  if constexpr (sizeof(T) == 2 && NE == 4) {  // 8 bytes
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(u.x << 16);
    x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16);
    x[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (sizeof(T) == 4 && NE == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < NE; i += 8) lds8(p + i, x + i);
  }
}

template <typename T, int NE>
__device__ __forceinline__ void stg_row(T* p, const float (&y)[NE]) {
  if constexpr (sizeof(T) == 2 && NE == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
  } else if constexpr (sizeof(T) == 4 && NE == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int i = 0; i < NE; i += 8) stg8(p + i, y + i);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Apply<T, D>::CTAS)
lin_attn_apply_kernel(const T* __restrict__ q, const float* __restrict__ ctx, T* __restrict__ out, int N,
                      long long tiles_total, long long tiles_per_cta) {
  using A = Apply<T, D>;
  constexpr int NE = D / 4;  // channels per thread and row
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;  // copies per row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  uint4* bs = reinterpret_cast<uint4*>(smem + A::RING);  // [ks][nj][lane]: hi b0, hi b1, lo b0, lo b1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_per_bh = (N + A::TR - 1) / A::TR;
  const long long tile0 = blockIdx.x * tiles_per_cta;
  const int mine = (int)min(tiles_per_cta, tiles_total - tile0);

  auto load_tile = [&](int j) {
    unsigned char* st = ring + (j % kStages) * A::TR * A::PITCH;
    const long long tile = tile0 + j;
    const int bh = (int)(tile / tiles_per_bh);
    const int n0 = (int)(tile - (long long)bh * tiles_per_bh) * A::TR;
    const T* src = q + ((long long)bh * N + n0) * D;
    for (int c = tid; c < A::TR * kChunks; c += kThreads) {
      const int r = c / kChunks, col = c - r * kChunks;
      const bool ok = n0 + r < N;
      cp_async16(smem_addr(st + r * A::PITCH + col * 16), src + (long long)(ok ? r : 0) * D + col * kVec,
                 ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) load_tile(s);
    cp_async_commit();
  }

  // The reduction index d and the output index e are permuted: in k step
  // ks, B row k is d = (D/4)(k%4) + (D/8)(k/4) + ks; in n tile nj, column n
  // is e = (D/4)(n/2) + 2 nj + n%2.  Then a thread's A values are channels
  // (D/4) t .. (D/4)(t+1) - 1 of its rows and its C values the same outputs.
  uint4 breg[A::REG ? A::KS * A::NJ : 1];
  int cur = -1;
  for (int j = 0; j < mine; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < mine) load_tile(j + kStages - 1);
    cp_async_commit();
    const long long tile = tile0 + j;
    const int bh = (int)(tile / tiles_per_bh);
    const int n0 = (int)(tile - (long long)bh * tiles_per_bh) * A::TR;
    if (bh != cur) {  // CTA-uniform: every warp is past its last use of bs
      const float* cb = ctx + (long long)bh * D * D;  // [d][e]
      for (int i = tid; i < A::KS * A::NJ * 32; i += kThreads) {
        const int ks = i / (A::NJ * 32), nj = (i / 32) % A::NJ, ln = i % 32;
        const int gg = ln >> 2, tt = ln & 3;
        const int e = NE * (gg >> 1) + 2 * nj + (gg & 1);
        const int d0 = NE * tt + ks, d1 = d0 + D / 8;
        uint32_t h0, l0, h1, l1;
        split_tf32(__ldg(cb + d0 * D + e), h0, l0);
        split_tf32(__ldg(cb + d1 * D + e), h1, l1);
        bs[i] = make_uint4(h0, h1, l0, l1);
      }
      __syncthreads();
      if constexpr (A::REG) {
#pragma unroll
        for (int i = 0; i < A::KS * A::NJ; ++i) breg[i] = bs[i * 32 + lane];
      }
      cur = bh;
    }
    const unsigned char* st = ring + (j % kStages) * A::TR * A::PITCH;
#pragma unroll
    for (int mi = 0; mi < A::MT; ++mi) {
      const int ra = (warp + kWarps * mi) * 16 + g, rb = ra + 8;  // rows ra and rb of the tile
      float qa[NE], qb[NE];
      lds_row<T, NE>(reinterpret_cast<const T*>(st + ra * A::PITCH + t * A::CB), qa);
      lds_row<T, NE>(reinterpret_cast<const T*>(st + rb * A::PITCH + t * A::CB), qb);
      // per-row softmax over d
      float ma = qa[0], mb = qb[0];
#pragma unroll
      for (int i = 1; i < NE; ++i) {
        ma = fmaxf(ma, qa[i]);
        mb = fmaxf(mb, qb[i]);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      }
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        qa[i] = __expf(qa[i] - ma);
        qb[i] = __expf(qb[i] - mb);
        sa += qa[i];
        sb += qb[i];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, o);
        sb += __shfl_xor_sync(0xffffffffu, sb, o);
      }
      const float fa = inv_sqrt<D>() / sa, fb = inv_sqrt<D>() / sb;
      float acc[A::NJ][4] = {};
#pragma unroll
      for (int ks = 0; ks < A::KS; ++ks) {
        uint32_t ah[4], al[4];
        split_tf32(qa[ks] * fa, ah[0], al[0]);           // (row g, d = NE t + ks)
        split_tf32(qb[ks] * fb, ah[1], al[1]);           // (row g + 8, d = NE t + ks)
        split_tf32(qa[D / 8 + ks] * fa, ah[2], al[2]);   // (row g, d = NE t + D/8 + ks)
        split_tf32(qb[D / 8 + ks] * fb, ah[3], al[3]);
#pragma unroll
        for (int nj = 0; nj < A::NJ; ++nj) {
          uint4 b;
          if constexpr (A::REG)
            b = breg[ks * A::NJ + nj];
          else
            b = bs[(ks * A::NJ + nj) * 32 + lane];
          mma_tf32(acc[nj], ah, b.x, b.y);
          mma_tf32(acc[nj], ah, b.z, b.w);
          mma_tf32(acc[nj], al, b.x, b.y);
        }
      }
      float ya[NE], yb[NE];
#pragma unroll
      for (int nj = 0; nj < A::NJ; ++nj) {
        ya[2 * nj] = acc[nj][0];
        ya[2 * nj + 1] = acc[nj][1];
        yb[2 * nj] = acc[nj][2];
        yb[2 * nj + 1] = acc[nj][3];
      }
      T* ob = out + ((long long)bh * N + n0) * D + NE * t;
      if (n0 + ra < N) stg_row<T, NE>(ob + (long long)ra * D, ya);
      if (n0 + rb < N) stg_row<T, NE>(ob + (long long)rb * D, yb);
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------- host
// The context pass's partition: P slices of slice_rows rows per bh (about
// two CTAs per SM over BH, at least a tile of rows each, whole warp shares
// of a tile), and G warps per channel in the combine.  The grid has a CTA
// per slice, but at least one per kWarps channels (BH * D of them, up to
// what the card holds at once), as K2a's.
struct CtxPlan {
  int P, slice_rows, grid, G;
};

template <typename T, int D>
cudaError_t ctx_plan(int BH, int N, CtxPlan* pl) {
  using C = Ctx<T, D>;
  static int cache[kMaxDevices];
  int cap = 0;
  cudaError_t err = capacity(lin_attn_ctx_kernel<T, D>, kThreads, C::SMEM, kCtasPerSm, cache, &cap);
  if (err != cudaSuccess) return err;
  const int want = cap / BH > 1 ? cap / BH : 1;
  const int most = (N + C::TR - 1) / C::TR;
  const int P0 = want < most ? want : most;
  pl->slice_rows = ((N + P0 - 1) / P0 + C::KW - 1) / C::KW * C::KW;
  pl->P = (N + pl->slice_rows - 1) / pl->slice_rows;
  const long long channels = (long long)BH * D;
  const long long want_grid = std::max((long long)BH * pl->P, channels / kWarps);
  pl->grid = (int)std::min(want_grid, (long long)cap);
  const long long warps = (long long)pl->grid * kWarps;
  pl->G = 1;
  while (pl->G < kWarps && channels * pl->G * 2 <= warps && pl->G * 2 <= pl->P) pl->G *= 2;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_ctx(const void* k, const void* v, void* ctx, void* ws, int BH, int N, cudaStream_t s) {
  CtxPlan pl;
  cudaError_t err = ctx_plan<T, D>(BH, N, &pl);
  if (err != cudaSuccess) return err;
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  float* c = static_cast<float*>(ctx);
  float* w = static_cast<float*>(ws);
  void* args[] = {&kp, &vp, &c, &w, &BH, &N, &pl.P, &pl.slice_rows, &pl.G};
  return cudaLaunchCooperativeKernel((const void*)lin_attn_ctx_kernel<T, D>, dim3(pl.grid), dim3(kThreads), args,
                                     (size_t)Ctx<T, D>::SMEM, s);
}

template <typename T, int D>
cudaError_t launch_apply(const void* q, const void* ctx, void* out, int BH, int N, cudaStream_t s) {
  using A = Apply<T, D>;
  static int cache[kMaxDevices];
  int cap = 0;
  cudaError_t err = capacity(lin_attn_apply_kernel<T, D>, kThreads, A::SMEM, A::CTAS, cache, &cap);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)BH * ((N + A::TR - 1) / A::TR);
  const long long per_cta = (tiles + cap - 1) / cap;
  const unsigned grid = (unsigned)((tiles + per_cta - 1) / per_cta);
  lin_attn_apply_kernel<T, D><<<grid, kThreads, A::SMEM, s>>>(
      static_cast<const T*>(q), static_cast<const float*>(ctx), static_cast<T*>(out), N, tiles, per_cta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t plan_ctx(int BH, int N, int D, CtxPlan* pl) {
  switch (D) {
    case 16: return ctx_plan<T, 16>(BH, N, pl);
    case 32: return ctx_plan<T, 32>(BH, N, pl);
    case 64: return ctx_plan<T, 64>(BH, N, pl);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_ctx(const void* k, const void* v, void* ctx, void* ws, int BH, int N, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_ctx<T, 16>(k, v, ctx, ws, BH, N, s);
    case 32: return launch_ctx<T, 32>(k, v, ctx, ws, BH, N, s);
    case 64: return launch_ctx<T, 64>(k, v, ctx, ws, BH, N, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_apply(const void* q, const void* ctx, void* out, int BH, int N, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_apply<T, 16>(q, ctx, out, BH, N, s);
    case 32: return launch_apply<T, 32>(q, ctx, out, BH, N, s);
    case 64: return launch_apply<T, 64>(q, ctx, out, BH, N, s);
    default: return cudaErrorInvalidValue;
  }
}

// BH * max(N, D) within an int: the kernels index items and channels by int
bool shape_ok(int BH, int N) { return BH > 0 && N > 0 && (long long)BH * std::max(N, 64) <= 0x7fffffffLL; }

}  // namespace

// Workspace floats the context pass needs for (BH, N, D) in this dtype (0
// for a shape it does not take).
extern "C" long long irsde_lin_attn_ctx_workspace(int BH, int N, int D, int dtype) {
  if (!shape_ok(BH, N)) return 0;
  CtxPlan pl;
  cudaError_t err = dtype == IRSDE_BF16 ? plan_ctx<__nv_bfloat16>(BH, N, D, &pl)
                    : dtype == IRSDE_F32 ? plan_ctx<float>(BH, N, D, &pl)
                                         : cudaErrorInvalidValue;
  if (err != cudaSuccess) return 0;
  return (long long)BH * pl.P * part_floats(D);
}

extern "C" int irsde_lin_attn_ctx(const void* k, const void* v, void* ctx, void* ws, int BH, int N, int D,
                                  int dtype, void* stream) {
  if (!shape_ok(BH, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == IRSDE_BF16) return (int)dispatch_ctx<__nv_bfloat16>(k, v, ctx, ws, BH, N, D, s);
  if (dtype == IRSDE_F32) return (int)dispatch_ctx<float>(k, v, ctx, ws, BH, N, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int irsde_lin_attn_apply(const void* q, const void* ctx, void* out, int BH, int N, int D,
                                    int dtype, void* stream) {
  if (!shape_ok(BH, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == IRSDE_BF16) return (int)dispatch_apply<__nv_bfloat16>(q, ctx, out, BH, N, D, s);
  if (dtype == IRSDE_F32) return (int)dispatch_apply<float>(q, ctx, out, BH, N, D, s);
  return (int)cudaErrorInvalidValue;
}
