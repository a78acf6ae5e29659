// Packed all-heads linear attention on the qkv projection (B, N, 3*hid),
// hid = heads * 32 = 128, channels ordered [q heads | k heads | v heads]:
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
// Bound on the H100: bytes.  Each pass reads 256 of a row's 384 channels
// (K2a k and v, K2b q, and K2b writes 128) for 2*32 FLOP per element, far
// below the ~295 FLOP/byte bf16 ridge.  So the design keeps the loads wide
// and deep and takes the products off the load path:
//
// - K2a: one cooperative launch, at most two CTAs per SM.  Each CTA takes a
//   slice of one sample's rows (all four heads: a row's k|v is one
//   contiguous run of 256 channels) and streams it through a 3-stage ring
//   of 16-byte cp.async copies.  k is read once: per tile a per-channel
//   max, the running sum and accumulator rescaled when it grows (as
//   _ctx_kernel does).  The 32x32 outer products run on the tensor cores
//   (mma.sync m16n8k8 TF32, one warp per (head, 16 channels d)), with
//   exp(k - m) split into two TF32 parts and float32 v split too, so the
//   products keep float32 accuracy: bf16 v is exact in TF32 (two products),
//   float32 v takes three; each tile's products go into the slice's
//   float32 sums by plain adds.  Each slice leaves (max, sum, acc) in a
//   workspace; after a grid barrier every CTA combines its share of the
//   channels, each over its share of the slices, in a fixed order, so the
//   result does not depend on which CTA finishes first and two runs are
//   bit-equal.  The combine reads at most 2*SMs partials, whatever N is.
// - K2b: CTAs stay resident and walk contiguous 64-row tiles of one
//   sample through a 3-stage cp.async ring.  Each warp holds one head's
//   ctxT, loaded and split into TF32 parts once per CTA, as mma.sync B
//   fragments; the softmax and the product run in registers with the
//   reduction dimension d and the output dimension e permuted so that each
//   thread reads 8 contiguous q channels (16 bytes in bf16) and writes 8
//   contiguous outputs; the per-(row, head) max and sum take two shuffles.
//   Both operands are float32, so the product takes three TF32 products.
// - Any N is taken; the ragged edge is zero-filled and masked.

#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

#include "tf32_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int DH = 32;              // dim_head
constexpr int HEADS = 4;
constexpr int HID = HEADS * DH;     // 128
constexpr int ROW = 3 * HID;        // channels of a qkv row
constexpr int kThreads = 256;       // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;          // cp.async ring depth
constexpr int kCtasPerSm = 2;
constexpr float kScale = 0.17677669529663687f;  // 32 ** -0.5

// ------------------------------------------------------------ K2a: context
// Rows per ring tile: 64 bf16 rows or 32 float32 rows of k|v (32 KB); a
// tile row is padded by 8 elements so that the fragment loads of one warp
// (4 rows x 8 channels) fall in distinct banks.
template <typename T>
struct CtxTile;
template <>
struct CtxTile<__nv_bfloat16> {
  static constexpr int kRows = 64;
};
template <>
struct CtxTile<float> {
  static constexpr int kRows = 32;
};
constexpr int kCtxPitch = 2 * HID + 8;  // elements per tile row (k|v)
constexpr int kCtxSmem = kStages * 64 * kCtxPitch * 2;  // bytes, either type: 101376
constexpr int kSliceQuantum = 64;       // a slice is a multiple of this many rows
constexpr int kMinSliceRows = 128;
constexpr int kPartFloats = 2 * HID + HEADS * DH * DH;  // per slice: max[c], sum[c], acc[h][d][e]

template <typename T>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
la_ctx_kernel(const T* __restrict__ qkv, float* __restrict__ ctx, float* __restrict__ ws, int B, int N,
              int P, int slice_rows, int G) {
  constexpr int R = CtxTile<T>::kRows, KS = R / 8;
  constexpr int kVec = 16 / sizeof(T);         // elements per 16-byte copy
  constexpr int kChunks = 2 * HID / kVec;      // copies per k|v row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  __shared__ float red_m[kWarps], red_s[kWarps], red_a[kWarps][DH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column
  const int h = warp >> 1;
  const int kc = h * DH + (warp & 1) * 16 + g;  // this thread's k channels: kc and kc + 8

  for (int item = blockIdx.x; item < B * P; item += gridDim.x) {
    const int b = item / P, slice = item - b * P;
    const int n_lo = slice * slice_rows;
    const int rows = min(N - n_lo, slice_rows);
    const int tiles = (rows + R - 1) / R;
    const T* src = qkv + ((long long)b * N + n_lo) * ROW + HID;  // k of the slice's first row

    auto load_tile = [&](int tile) {
      T* st = ring + (tile % kStages) * R * kCtxPitch;
      for (int c = tid; c < R * kChunks; c += kThreads) {
        const int r = c / kChunks, col = c - r * kChunks, n = tile * R + r;
        const bool ok = n < rows;
        cp_async16(smem_addr(st + r * kCtxPitch + col * kVec), src + (long long)(ok ? n : 0) * ROW + col * kVec,
                   ok ? 16 : 0);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < tiles) load_tile(s);
      cp_async_commit();
    }

    float acc[4][4] = {};  // C fragments of acc[d][e], e tiles of 8
    float m0 = -INFINITY, m1 = -INFINITY, s0 = 0.f, s1 = 0.f;  // channels kc, kc + 8
    for (int tile = 0; tile < tiles; ++tile) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (tile + kStages - 1 < tiles) load_tile(tile + kStages - 1);
      cp_async_commit();
      const T* st = ring + (tile % kStages) * R * kCtxPitch;
      const int valid = rows - tile * R;

      // A = exp(k - m)^T: a0 (d=g, n=t), a1 (d=g+8, n=t), a2 (d=g, n=t+4), a3 (d=g+8, n=t+4)
      float kr[KS][4];
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int na = ks * 8 + t, nb = na + 4;
        kr[ks][0] = na < valid ? lds(st + na * kCtxPitch + kc) : -INFINITY;
        kr[ks][1] = na < valid ? lds(st + na * kCtxPitch + kc + 8) : -INFINITY;
        kr[ks][2] = nb < valid ? lds(st + nb * kCtxPitch + kc) : -INFINITY;
        kr[ks][3] = nb < valid ? lds(st + nb * kCtxPitch + kc + 8) : -INFINITY;
        t0 = fmaxf(t0, fmaxf(kr[ks][0], kr[ks][2]));
        t1 = fmaxf(t1, fmaxf(kr[ks][1], kr[ks][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, o));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, o));
      }
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      const float c0 = __expf(m0 - n0), c1 = __expf(m1 - n1);  // 1 when the max holds, 0 on the first tile
      m0 = n0;
      m1 = n1;
      s0 *= c0;
      s1 *= c1;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        acc[nj][0] *= c0;
        acc[nj][1] *= c0;
        acc[nj][2] *= c1;
        acc[nj][3] *= c1;
      }
      // This tile's products, added into acc by float32 adds: the tensor
      // cores' accumulation rounds toward zero, which over a slice-long
      // chain of products drifted ~5e-6 of max|ctx| on an H100.
      float tacc[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int na = ks * 8 + t, nb = na + 4;
        float e[4];
        e[0] = __expf(kr[ks][0] - m0);  // masked rows: exp(-inf) = 0
        e[1] = __expf(kr[ks][1] - m1);
        e[2] = __expf(kr[ks][2] - m0);
        e[3] = __expf(kr[ks][3] - m1);
        s0 += e[0] + e[2];
        s1 += e[1] + e[3];
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(e[i], ah[i], al[i]);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int vc = HID + h * DH + nj * 8 + g;  // B = v: b0 (n=t, e=g), b1 (n=t+4, e=g)
          const float v0 = lds(st + na * kCtxPitch + vc), v1 = lds(st + nb * kCtxPitch + vc);
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
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nj][i] += tacc[nj][i];
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next item

#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    float* part = ws + (long long)item * kPartFloats;
    if (t == 0) {
      part[kc] = m0;
      part[kc + 8] = m1;
      part[HID + kc] = s0;
      part[HID + kc + 8] = s1;
    }
    float* pa = part + 2 * HID + h * DH * DH + (kc - h * DH) * DH;  // acc[h][d = kc - h*32][.]
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      *reinterpret_cast<float2*>(pa + nj * 8 + 2 * t) = make_float2(acc[nj][0], acc[nj][1]);
      *reinterpret_cast<float2*>(pa + 8 * DH + nj * 8 + 2 * t) = make_float2(acc[nj][2], acc[nj][3]);
    }
  }

  cg::this_grid().sync();

  // Combine: G warps per channel (b, c), each over its share of the P
  // slices; the shares are summed in warp order.
  const int cpb = kWarps / G;  // channels per CTA pass
  const int cl = warp / G, gi = warp - cl * G;
  const int p0 = gi * P / G, p1 = (gi + 1) * P / G;
  for (int u = blockIdx.x; u < B * HID / cpb; u += gridDim.x) {
    const int chan = u * cpb + cl, b = chan / HID, c = chan - b * HID;
    const int hh = c / DH, d = c - hh * DH;
    const float* base = ws + (long long)b * P * kPartFloats;
    float mx = -INFINITY;
    for (int p = p0 + lane; p < p1; p += 32) mx = fmaxf(mx, __ldcg(base + (long long)p * kPartFloats + c));
    mx = warp_max(mx);
    if (lane == 0) red_m[warp] = mx;
    __syncthreads();
    float M = -INFINITY;
    for (int j = 0; j < G; ++j) M = fmaxf(M, red_m[cl * G + j]);
    float sl = 0.f;
    for (int p = p0 + lane; p < p1; p += 32) {
      const float* q = base + (long long)p * kPartFloats;
      sl += __ldcg(q + HID + c) * __expf(__ldcg(q + c) - M);
    }
    sl = warp_sum(sl);
    if (lane == 0) red_s[warp] = sl;
    float a = 0.f;
#pragma unroll 4
    for (int p = p0; p < p1; ++p) {
      const float* q = base + (long long)p * kPartFloats;
      a += __ldcg(q + 2 * HID + hh * DH * DH + d * DH + lane) * __expf(__ldcg(q + c) - M);
    }
    red_a[warp][lane] = a;
    __syncthreads();
    if (gi == 0) {
      float S = 0.f, tot = 0.f;
      for (int j = 0; j < G; ++j) {
        S += red_s[cl * G + j];
        tot += red_a[cl * G + j][lane];
      }
      ctx[((long long)b * HEADS + hh) * DH * DH + lane * DH + d] = tot / (S * (float)N);  // [e][d]
    }
    __syncthreads();
  }
}

// -------------------------------------------------------------- K2b: apply
constexpr int kApplyRows = 64;  // rows per ring tile
template <typename T>
struct ApplyTile;
template <>
struct ApplyTile<__nv_bfloat16> {
  static constexpr int kPitch = HID + 32;  // 320 bytes: a warp's 16-byte loads fall in distinct banks
};
template <>
struct ApplyTile<float> {
  static constexpr int kPitch = HID + 4;  // 528 bytes
};
template <typename T>
constexpr int apply_smem() {
  return kStages * kApplyRows * ApplyTile<T>::kPitch * (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
la_apply_kernel(const T* __restrict__ qkv, const float* __restrict__ ctx, T* __restrict__ out, int N,
                int tiles_per_cta) {
  constexpr int kPitch = ApplyTile<T>::kPitch;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HID / kVec;  // copies per q row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = warp & 3, mt = warp >> 2;  // head; m tiles mt and mt + 2 of each 64-row tile
  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * tiles_per_cta;
  const int mine = min(tiles_per_cta, (N + kApplyRows - 1) / kApplyRows - tile0);

  const T* src = qkv + (long long)b * N * ROW;
  auto load_tile = [&](int j) {
    T* st = ring + (j % kStages) * kApplyRows * kPitch;
    const int n0 = (tile0 + j) * kApplyRows;
    for (int c = tid; c < kApplyRows * kChunks; c += kThreads) {
      const int r = c / kChunks, col = c - r * kChunks, n = n0 + r;
      const bool ok = n < N;
      cp_async16(smem_addr(st + r * kPitch + col * kVec), src + (long long)(ok ? n : 0) * ROW + col * kVec,
                 ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) load_tile(s);
    cp_async_commit();
  }

  // ctxT of head h as B fragments, split once while the first tiles load.
  // The reduction index d and the output index e are permuted: in k step
  // ks, B row k is d = 8(k%4) + 4(k/4) + ks; in e tile nj, column n is
  // e = 8(n/2) + 2nj + n%2.  Then a thread's A values are q channels
  // 8t..8t+7 of its rows and its C values outputs 8t..8t+7.
  uint32_t bh[4][4][2], bl[4][4][2];
  {
    const float* cb = ctx + ((long long)b * HEADS + h) * DH * DH;  // [e][d]
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int e = 8 * (g >> 1) + 2 * nj + (g & 1);
        split_tf32(__ldg(cb + e * DH + 8 * t + ks), bh[ks][nj][0], bl[ks][nj][0]);
        split_tf32(__ldg(cb + e * DH + 8 * t + 4 + ks), bh[ks][nj][1], bl[ks][nj][1]);
      }
  }

  for (int j = 0; j < mine; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < mine) load_tile(j + kStages - 1);
    cp_async_commit();
    const T* st = ring + (j % kStages) * kApplyRows * kPitch;
    const int n0 = (tile0 + j) * kApplyRows;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0 = (mt + 2 * half) * 16 + g;  // rows r0 and r0 + 8
      float qa[8], qb[8];
      lds8(st + r0 * kPitch + h * DH + 8 * t, qa);
      lds8(st + (r0 + 8) * kPitch + h * DH + 8 * t, qb);
      // per-(row, head) softmax over d, shifted by the head's own max
      float ma = qa[0], mb = qb[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) {
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
      for (int i = 0; i < 8; ++i) {
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
      const float ra = kScale / sa, rb = kScale / sb;
      float acc[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ah[4], al[4];
        split_tf32(qa[ks] * ra, ah[0], al[0]);      // (row g, d = 8t + ks)
        split_tf32(qb[ks] * rb, ah[1], al[1]);      // (row g + 8, d = 8t + ks)
        split_tf32(qa[4 + ks] * ra, ah[2], al[2]);  // (row g, d = 8t + 4 + ks)
        split_tf32(qb[4 + ks] * rb, ah[3], al[3]);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          mma_tf32(acc[nj], ah, bh[ks][nj][0], bh[ks][nj][1]);
          mma_tf32(acc[nj], ah, bl[ks][nj][0], bl[ks][nj][1]);
          mma_tf32(acc[nj], al, bh[ks][nj][0], bh[ks][nj][1]);
        }
      }
      const float ya[8] = {acc[0][0], acc[0][1], acc[1][0], acc[1][1], acc[2][0], acc[2][1], acc[3][0], acc[3][1]};
      const float yb[8] = {acc[0][2], acc[0][3], acc[1][2], acc[1][3], acc[2][2], acc[2][3], acc[3][2], acc[3][3]};
      const int na = n0 + r0, nb = na + 8;
      if (na < N) stg8(out + ((long long)b * N + na) * HID + h * DH + 8 * t, ya);
      if (nb < N) stg8(out + ((long long)b * N + nb) * HID + h * DH + 8 * t, yb);
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------- host
// K2a's partition: P slices of slice_rows rows per sample (about two CTAs
// per SM over the batch, at least kMinSliceRows rows each), and G warps
// per channel in the combine.  The grid has a CTA per slice, but at least
// one per kWarps channels (up to what the card holds at once), so that the
// combine takes one pass where there are few slices (N = 256 at batch 8:
// 16 slices, 1024 channels).  A grid of every CTA the card holds measured
// 2-3 us slower on an H100 where there are fewer channels than slices.
struct CtxPlan {
  int P, slice_rows, grid, G;
};

template <typename T>
cudaError_t ctx_plan(int B, int N, CtxPlan* pl) {
  static int cache[kMaxDevices];
  int cap = 0;
  cudaError_t err = capacity(la_ctx_kernel<T>, kThreads, kCtxSmem, kCtasPerSm, cache, &cap);
  if (err != cudaSuccess) return err;
  const int want = cap / B > 1 ? cap / B : 1;
  const int most = (N + kMinSliceRows - 1) / kMinSliceRows;
  const int P0 = want < most ? want : most;
  pl->slice_rows = ((N + P0 - 1) / P0 + kSliceQuantum - 1) / kSliceQuantum * kSliceQuantum;
  pl->P = (N + pl->slice_rows - 1) / pl->slice_rows;
  const long long channels = (long long)B * HID;
  const long long want_grid = std::max((long long)B * pl->P, channels / kWarps);
  pl->grid = (int)std::min(want_grid, (long long)cap);
  const long long warps = (long long)pl->grid * kWarps;
  pl->G = 1;
  while (pl->G < kWarps && channels * pl->G * 2 <= warps && pl->G * 2 <= pl->P) pl->G *= 2;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_ctx(const void* qkv, void* ctx, void* ws, int B, int N, cudaStream_t s) {
  CtxPlan pl;
  cudaError_t err = ctx_plan<T>(B, N, &pl);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(qkv);
  float* c = static_cast<float*>(ctx);
  float* w = static_cast<float*>(ws);
  void* args[] = {&q, &c, &w, &B, &N, &pl.P, &pl.slice_rows, &pl.G};
  return cudaLaunchCooperativeKernel((const void*)la_ctx_kernel<T>, dim3(pl.grid), dim3(kThreads), args,
                                     (size_t)kCtxSmem, s);
}

template <typename T>
cudaError_t launch_apply(const void* qkv, const void* ctx, void* out, int B, int N, cudaStream_t s) {
  static int cache[kMaxDevices];
  int cap = 0;
  cudaError_t err = capacity(la_apply_kernel<T>, kThreads, apply_smem<T>(), kCtasPerSm, cache, &cap);
  if (err != cudaSuccess) return err;
  const int tiles = (N + kApplyRows - 1) / kApplyRows;
  const int per_b = cap / B > 1 ? cap / B : 1;
  const int tiles_per_cta = (tiles + per_b - 1) / per_b;
  const dim3 grid((tiles + tiles_per_cta - 1) / tiles_per_cta, B);
  la_apply_kernel<T><<<grid, kThreads, apply_smem<T>(), s>>>(static_cast<const T*>(qkv),
                                                             static_cast<const float*>(ctx),
                                                             static_cast<T*>(out), N, tiles_per_cta);
  return cudaGetLastError();
}

}  // namespace

// Workspace floats the context pass needs for (B, N) in this dtype.
extern "C" long long irsde_la_ctx_workspace(int B, int N, int heads, int dtype) {
  if (B <= 0 || N <= 0 || heads != HEADS) return 0;
  CtxPlan pl;
  cudaError_t err = dtype == IRSDE_BF16 ? ctx_plan<__nv_bfloat16>(B, N, &pl) : ctx_plan<float>(B, N, &pl);
  if (err != cudaSuccess) return 0;
  return (long long)B * pl.P * kPartFloats;
}

extern "C" int irsde_la_ctx(const void* qkv, void* ctx, void* ws, int B, int N, int heads, int dtype,
                            void* stream) {
  if (B <= 0 || N <= 0 || heads != HEADS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == IRSDE_BF16) return (int)launch_ctx<__nv_bfloat16>(qkv, ctx, ws, B, N, s);
  if (dtype == IRSDE_F32) return (int)launch_ctx<float>(qkv, ctx, ws, B, N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int irsde_la_apply(const void* qkv, const void* ctx, void* out, int B, int N, int heads,
                              int dtype, void* stream) {
  if (B <= 0 || N <= 0 || heads != HEADS || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == IRSDE_BF16) return (int)launch_apply<__nv_bfloat16>(qkv, ctx, out, B, N, s);
  if (dtype == IRSDE_F32) return (int)launch_apply<float>(qkv, ctx, out, B, N, s);
  return (int)cudaErrorInvalidValue;
}
