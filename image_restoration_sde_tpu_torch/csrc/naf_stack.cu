// K fused NAFBlocks in one launch, on an NHWC activation x (P = B*H*W rows
// of C channels), float32 or bfloat16.  Per block, in float32 with float32
// weights (tm = the block's time modulation row for the pixel's sample):
//
//     h   = LN(x; g1) * (tm[C:2C] + 1) + tm[0:C]
//     h   = conv1(h)                               1x1, C -> 2C
//     h   = dwconv3x3(h)                           zero padding
//     h   = h[:, :C] * h[:, C:]                    SimpleGate
//     h   = h * (W_sca @ mean_HW(h) + b_sca)       simplified channel attention
//     y   = x + conv3(h) * beta                    1x1, C -> C
//     h   = LN(y; g2) * (tm[3C:4C] + 1) + tm[2C:3C]
//     h   = conv4(h)                               1x1, C -> 2C
//     out = y + conv5(h[:, :C] * h[:, C:]) * gamma 1x1, C -> C
//
// and out is rounded to x's dtype before the next block, as the reference
// does.  LN is the bias-free channel LayerNorm with the centered variance.
//
// Replaces the Pallas TPU kernel image_restoration_sde_tpu/ops/naf_stack.py
// (_kernel, launched by _pallas_naf_stack), which keeps the activation in
// VMEM across a sequential grid over the K blocks.
//
// Bound on the H100: operations, in float32.  At the Refusion latent shapes
// (K = 28, C = 512, 8x8 maps, batch 4) the kernel does ~22.9 GFLOP, almost
// all of it the four 1x1 products, on float32 FMA units (67 TFLOP/s):
// ~0.34 ms; its ~207 MB of float32 weights take ~0.062 ms at 3.35 TB/s.
//
// Design: one cooperative, persistent launch (grid sized from the shapes,
// never from K), each NAFBlock five phases separated by grid barriers:
//   1. LN1 + modulation + conv1 + dwconv3x3 + SimpleGate + HW mean: a work
//      item is one sample and n_c channel pairs (c, c + C), so the 3x3
//      neighbourhood and the per-sample mean stay inside the CTA (conv1's
//      2 n_c columns for all the sample's pixels go to an L2-resident
//      workspace, read back by the same CTA)           -> g (P, C), pooled
//   2. SCA 1x1 on the pooled vector, one warp per output channel -> sca
//   3. conv3(g * sca), beta residual                  -> ymid (P, C)
//   4. LN2 + modulation + conv4                       -> t4 (P, 2C)
//   5. SimpleGate, conv5, gamma residual              -> y (P, C), x's dtype
// Every 1x1 product is tiled as 64 rows x CT output channels (CT 32, 16 or
// 8, chosen from the shapes so a phase has ~128 tiles): the CTA's weight
// slice (CT rows of the (out, in) weight) stays in shared memory for the
// whole tile and is fetched with cp.async *before* the CTA waits at the
// barrier that opens the phase, so its latency hides behind the barrier;
// the activation streams in 64-row x 64-channel slabs through a 3-stage
// cp.async ring (two slabs in flight during the math), and LN,
// modulation, gating or the SCA scale is applied as a slab moves from the
// ring to the slab the products read.  Each thread owns a 4x4 register
// tile of outputs (FMA, float32: no TF32), the 256 threads splitting the
// reduction into 64/CT fixed parts summed in a fixed order.  LayerNorm
// statistics are taken once per row per phase: the phase that writes a
// row (3 for LN2, 5 for the next block's LN1, and an opening pass for x)
// leaves each tile's (mean, M2) of its columns, and the last tile of a
// 64-row band (one atomic counter) combines them into the rows' mean and
// rstd (Chan's centered update: four lanes per row fold a quarter of the
// tiles each in tile order, then merge pairwise).  Every sum runs in a
// fixed order and no float atomics are used, so results do not depend on
// scheduling, and a chain of one-block launches ends bit-equal to one
// K-block launch.  Weights are read in place through a device table of
// per-block pointers.  C must be a multiple of 8.
//
// On the card each product phase takes several times its FMA work at the
// float32 peak (chip_profile.py prints the time of every phase).  Left for
// later: tensor cores through a 3xTF32 split, and fewer, wider tiles fed
// to a cluster by TMA multicast.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                    // rows (pixels) of a product tile
constexpr int kSlab = 64;                    // channels of one activation slab
constexpr int kLDA = kSlab + 4;              // A slab stored [row][channel], rows padded
constexpr int kSlabFloats = kRows * kLDA;
constexpr int kStages = 3;                   // raw activation slabs in flight (cp.async ring)
constexpr int kRawSrcBytes = kRows * (kSlab * 4 + 16);  // one float32 source's raw slab
constexpr int kRawStageBytes = 2 * kRawSrcBytes;        // up to two sources (the gate's halves)
constexpr int kRingFloats = kStages * kRawStageBytes / 4;
constexpr int kRedFloats = kRows * 64;       // split-reduction partials: 64/CT parts of 64 x CT
constexpr int kTargetTiles = 128;            // a phase aims for this many tiles
constexpr int kMaxSmem = 226 * 1024;          // dynamic shared memory, below the 227 KB a block may have

// per-block pointer table order (ops/naf_stack.py PARAM_ORDER)
enum {
  P_W1, P_B1, P_WDW, P_B2, P_WSCA, P_BSCA, P_W3, P_B3,
  P_W4, P_B4, P_W5, P_B5, P_G1, P_G2, P_BETA, P_GAMMA, kPtrs
};

template <typename T>
struct Args {
  const T* x;                  // (P, C) input
  T* y;                        // (P, C) output, the resident activation
  const float* tmod;           // (K, B, 4C)
  const float* const* table;   // (K, kPtrs)
  float* t1;                   // (P, 2C): conv1's output, then conv4's
  float* g;                    // (P, C)
  float* ymid;                 // (P, C)
  float* pooled;               // (B, C)
  float* sca;                  // (B, C)
  float2* part;                // (P, C / ct_cc): (mean, M2) of a row over one tile's columns
  float2* stats1;              // (P): (mean, rstd) for LN1
  float2* stats2;              // (P): (mean, rstd) for LN2
  int* count;                  // (row bands): tiles of the band done
  long long* stamps;           // null, or irsde_naf_stack_stamps(K) clock readings of CTA 0
  int B, HW, H, W, C, K;
  int ct1, ct_cc, ct4;         // tile widths of phase 1, phases 3 and 5, phase 4
  int ldw;                     // weight slice row stride in shared memory
  float eps;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ldg4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }

// CT rows of a weight (out, in = C) into Ws[CT][ldw]: row j is weight row
// orow(j); channels C .. ldw - 4 are zero (the last slab's tail)
template <typename RowMap>
__device__ void fetch_weights(float* Ws, int ldw, const float* W, int C, int CT, RowMap orow) {
  const int quads = C / 4;
  for (int i = threadIdx.x; i < CT * quads; i += kThreads) {
    const int j = i / quads, k = (i % quads) * 4;
    cp_async16(Ws + j * ldw + k, W + (long long)orow(j) * C + k);
  }
  const int tail = ldw - 4 - C;
  for (int i = threadIdx.x; i < CT * tail; i += kThreads) Ws[(i / tail) * ldw + C + i % tail] = 0.f;
}

// cp.async of 16 bytes, zero-filled (src not read) when !valid
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 raw4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 raw4(const __nv_bfloat16* p) { return ld4(p); }

// out[r][c] = sum_k A(p0 + r, k) Ws[c][k] for the 64 x CT tile at rows
// p0 .. p0 + 63 (rows >= pend are zero), reduction over C channels in
// 64-channel slabs.  A is NSRC row-major arrays of E (row stride ld) that
// kStages-deep cp.async ring stages bring in raw, slab by slab, and
// f(raw, p, k) turns channels k .. k + 3 of row p into A's (LN,
// modulation, gate or scale) as the slab moves to `buf`.  Thread t
// finishes row t / 4, columns (t % 4) CT/4 .. + CT/4 - 1, and hands them
// to epi(r, cq, v).  The weight slice must be in Ws (cp.async issued, not
// yet waited for).
template <int CT, typename E, int NSRC, typename F, typename Epi>
__device__ void product_tile(int p0, int pend, int C, const float* Ws, int ldw, const E* const (&base)[NSRC],
                             long long ld, uint8_t* ring, float* buf, float* red, F f, Epi epi) {
  constexpr int KS = 64 / CT;   // reduction parts
  constexpr int CG = CT / 4;    // column groups of 4 (a thread's columns cg + CG j)
  constexpr int KP = kSlab / KS;
  constexpr int kChunks = kSlab * (int)sizeof(E) / 16;  // 16-byte chunks of a slab row
  constexpr int kRawLd = kSlab * (int)sizeof(E) + 16;   // bytes per raw row
  const int tid = threadIdx.x;
  const int part = tid / (16 * CG), lt = tid % (16 * CG);
  const int rg = lt / CG, cg = lt % CG;  // rows rg + 16 i, columns cg + CG j
  const int n_slabs = (C + kSlab - 1) / kSlab;

  auto issue = [&](int s) {
    if (s < n_slabs) {
      uint8_t* stage = ring + (s % kStages) * kRawStageBytes;
#pragma unroll
      for (int j = 0; j < NSRC; ++j)
        for (int q = tid; q < kRows * kChunks; q += kThreads) {
          const int r = q / kChunks, c = q % kChunks;
          const int p = p0 + r, k = s * kSlab + c * (16 / (int)sizeof(E));
          const bool valid = p < pend && k < C;
          cp_async16z(stage + j * kRawSrcBytes + r * kRawLd + c * 16, valid ? base[j] + p * ld + k : base[j], valid);
        }
    }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<kStages - 2>();  // slab s (and the weight slice) landed for this thread's copies
    __syncthreads();               // ... for all; every thread is done with buf and the stage refilled next
    {
      const uint8_t* stage = ring + (s % kStages) * kRawStageBytes;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = tid + kThreads * i, r = q / 16, kq = q % 16;
        const int p = p0 + r, k = s * kSlab + kq * 4;
        float4 raw[NSRC];
#pragma unroll
        for (int j = 0; j < NSRC; ++j)
          raw[j] = raw4(reinterpret_cast<const E*>(stage + j * kRawSrcBytes + r * kRawLd) + kq * 4);
        *reinterpret_cast<float4*>(buf + r * kLDA + kq * 4) =
            p < pend && k < C ? f(raw, p, k) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    issue(s + kStages - 1);
    __syncthreads();
#pragma unroll 2
    for (int kk = part * KP; kk < (part + 1) * KP; kk += 4) {
      float a[4][4], w[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(buf + (rg + 16 * i) * kLDA + kk);
        a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(Ws + (cg + CG * j) * ldw + s * kSlab + kk);
        w[j][0] = v.x, w[j][1] = v.y, w[j][2] = v.z, w[j][3] = v.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][e], w[j][e], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(part * kRows + rg + 16 * i) * CT + cg + CG * j] = acc[i][j];
  __syncthreads();
  const int r = tid / 4, cq = tid % 4;
  float v[CG];
#pragma unroll
  for (int jj = 0; jj < CG; ++jj) {
    float sum = red[r * CT + cq * CG + jj];
#pragma unroll
    for (int q = 1; q < KS; ++q) sum += red[(q * kRows + r) * CT + cq * CG + jj];
    v[jj] = sum;
  }
  epi(r, cq, v);
  __syncthreads();  // red, buf and the ring are free again
}

// (mean, M2) of the 4 CG values of a row held by 4 consecutive lanes;
// every lane of the warp takes part
template <int CG>
__device__ __forceinline__ float2 row_partial(const float (&v)[CG]) {
  float s = 0.f;
#pragma unroll
  for (int jj = 0; jj < CG; ++jj) s += v[jj];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const float mean = s / (float)(4 * CG);
  float q = 0.f;
#pragma unroll
  for (int jj = 0; jj < CG; ++jj) {
    const float d = v[jj] - mean;
    q += d * d;
  }
  q += __shfl_xor_sync(0xffffffffu, q, 1);
  q += __shfl_xor_sync(0xffffffffu, q, 2);
  return make_float2(mean, q);
}

// (mean, rstd) of the 64 rows of band `band` from their n tiles' (mean,
// M2) partials of width w: four lanes per row (thread t: row t / 4) each
// fold a quarter of the tiles in tile order, then the quarters merge
// pairwise, lower quarter first (Chan's update: centered, no E[x^2] -
// mean^2), so the order is fixed and the four lanes agree.  All 256
// threads call it; lanes of rows past P return garbage.
__device__ float2 combine_band(const float2* part, int band, int n, int w, int P, int C, float eps) {
  const int r = threadIdx.x / 4, sub = threadIdx.x & 3, p = band * kRows + r;
  const float2* row = part + (long long)p * n;
  const int lo = p < P ? sub * n / 4 : 0, hi = p < P ? (sub + 1) * n / 4 : 0;
  float mean = 0.f, m2 = 0.f, cnt = 0.f;
  for (int i = lo; i < hi; ++i) {
    const float2 t = __ldcg(row + i);
    const float nw = cnt + (float)w;
    const float d = t.x - mean;
    mean += d * ((float)w / nw);
    m2 += t.y + d * d * (cnt * (float)w / nw);
    cnt = nw;
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, mean, o);
    const float o2 = __shfl_xor_sync(0xffffffffu, m2, o);
    const float oc = __shfl_xor_sync(0xffffffffu, cnt, o);
    const bool lower = (sub & o) == 0;
    const float ma = lower ? mean : om, mb = lower ? om : mean;
    const float m2a = lower ? m2 : o2, m2b = lower ? o2 : m2;
    const float ca = lower ? cnt : oc, cb = lower ? oc : cnt;
    const float nw = ca + cb;
    if (nw > 0.f) {
      const float d = mb - ma;
      mean = ma + d * (cb / nw);
      m2 = (m2a + m2b) + d * d * (ca * cb / nw);
    }
    cnt = nw;
  }
  return make_float2(mean, rsqrtf(m2 / (float)C + eps));
}

// After a tile of row band `band` left its partials: the band's last tile
// combines them into `stats`.  Block-uniform.
__device__ void finish_band(int band, int n_tiles, int w, int P, int C, float eps, const float2* part,
                            float2* stats, int* count, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(count + band, 1) == n_tiles - 1;
  __syncthreads();
  if (*flag) {
    __threadfence();
    const float2 st = combine_band(part, band, n_tiles, w, P, C, eps);
    const int p = band * kRows + threadIdx.x / 4;
    if ((threadIdx.x & 3) == 0 && p < P) stats[p] = st;
    if (threadIdx.x == 0) count[band] = 0;
  }
  __syncthreads();
}

template <typename T>
struct Block {
  const Args<T>& a;
  const float* const* w;  // this block's pointers
  const float* tm;        // (B, 4C)
  const T* cur;           // this block's input
  float* Ws;              // weight slice
  uint8_t* ring;          // raw activation slabs in flight
  float* buf;             // the activation slab the products read
  float* red;             // split-reduction partials, also scratch
  float2* sstats;         // 64 rows' (mean, rstd)
  int* flag;

  __device__ int P() const { return a.B * a.HW; }
  __device__ int bands() const { return (P() + kRows - 1) / kRows; }
  __device__ int tiles1() const { return a.B * (a.C / (a.ct1 / 2)); }
  __device__ int tiles3() const { return bands() * (a.C / a.ct_cc); }
  __device__ int tiles4() const { return bands() * (2 * a.C / a.ct4); }

  // phase 1's tile: column j < nc is conv1 channel c0 + j, j >= nc is C + c0 + j - nc
  __device__ void prefetch1(int tile) const {
    const int nc = a.ct1 / 2, c0 = (tile % (a.C / nc)) * nc, C = a.C;
    fetch_weights(Ws, a.ldw, w[P_W1], C, a.ct1, [=](int j) { return j < nc ? c0 + j : C + c0 + j - nc; });
  }
  __device__ void prefetch2() const {
    const float* wsca = w[P_WSCA];
    const int o0 = blockIdx.x * (kThreads / 32), C = a.C;
    fetch_weights(Ws, a.ldw, wsca, C, kThreads / 32, [=](int j) { return min(o0 + j, C - 1); });
  }
  __device__ void prefetch3(int tile) const {
    const int o0 = (tile / bands()) * a.ct_cc;
    fetch_weights(Ws, a.ldw, w[P_W3], a.C, a.ct_cc, [=](int j) { return o0 + j; });
  }
  __device__ void prefetch4(int tile) const {
    const int o0 = (tile / bands()) * a.ct4;
    fetch_weights(Ws, a.ldw, w[P_W4], a.C, a.ct4, [=](int j) { return o0 + j; });
  }
  __device__ void prefetch5(int tile) const {
    const int o0 = (tile / bands()) * a.ct_cc;
    fetch_weights(Ws, a.ldw, w[P_W5], a.C, a.ct_cc, [=](int j) { return o0 + j; });
  }

  // rows p0 .. p0 + 63 (< pend) of `stats` into shared memory
  __device__ void rows_stats(const float2* stats, int p0, int pend) const {
    if (threadIdx.x < kRows) {
      const int p = p0 + threadIdx.x;
      sstats[threadIdx.x] = p < pend ? stats[p] : make_float2(0.f, 0.f);
    }
    __syncthreads();
  }

  // 1. LN1 + modulation + conv1 + dwconv3x3 + SimpleGate + HW mean
  template <int CT>
  __device__ void phase1() const {
    constexpr int CG = CT / 4;
    const int nc = CT / 2, C = a.C, C2 = 2 * C, HW = a.HW;
    const int groups = C / nc;
    const float* g1 = w[P_G1];
    const float* b1 = w[P_B1];
    for (int tile = blockIdx.x; tile < tiles1(); tile += gridDim.x) {
      const int b = tile / groups, c0 = (tile % groups) * nc;
      if (tile != blockIdx.x) prefetch1(tile);
      const float* t = tm + (long long)b * 4 * C;
      for (int q0 = 0; q0 < HW; q0 += kRows) {
        const int p0 = b * HW + q0, pend = (b + 1) * HW;
        rows_stats(a.stats1, p0, pend);
        auto load = [&](const float4 (&raw)[1], int p, int k) {
          const float2 st = sstats[p - p0];
          const float4 xv = raw[0], gg = ldg4(g1 + k);
          const float4 sc = ldg4(t + C + k), sh = ldg4(t + k);
          return make_float4(((xv.x - st.x) * st.y * gg.x) * (sc.x + 1.f) + sh.x,
                             ((xv.y - st.x) * st.y * gg.y) * (sc.y + 1.f) + sh.y,
                             ((xv.z - st.x) * st.y * gg.z) * (sc.z + 1.f) + sh.z,
                             ((xv.w - st.x) * st.y * gg.w) * (sc.w + 1.f) + sh.w);
        };
        auto epi = [&](int r, int cq, const float (&v)[CG]) {
          const int p = p0 + r;
          if (p >= pend) return;
#pragma unroll
          for (int jj = 0; jj < CG; ++jj) {
            const int j = cq * CG + jj, o = j < nc ? c0 + j : C + c0 + j - nc;
            a.t1[(long long)p * C2 + o] = v[jj] + __ldg(b1 + o);
          }
        };
        const T* const src[1] = {cur};
        product_tile<CT>(p0, pend, C, Ws, a.ldw, src, C, ring, buf, red, load, epi);
      }
      // depthwise 3x3 + SimpleGate over the sample's pixels, channel means
      const float* wdw = w[P_WDW];
      const float* b2 = w[P_B2];
      const int ci = threadIdx.x % nc, lanes = kThreads / nc, ql = threadIdx.x / nc;
      const int c = c0 + ci;
      float k1[9], k2[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        k1[i] = __ldg(wdw + c * 9 + i);
        k2[i] = __ldg(wdw + (c + C) * 9 + i);
      }
      const float bias1 = __ldg(b2 + c), bias2 = __ldg(b2 + c + C);
      float sum = 0.f;
      for (int q = ql; q < HW; q += lanes) {
        const int yy = q / a.W, xx = q % a.W;
        float h1 = 0.f, h2 = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int sy = yy + dy - 1;
          if (sy < 0 || sy >= a.H) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int sx = xx + dx - 1;
            if (sx < 0 || sx >= a.W) continue;
            const float* src = a.t1 + ((long long)b * HW + sy * a.W + sx) * C2;
            h1 += src[c] * k1[dy * 3 + dx];
            h2 += src[c + C] * k2[dy * 3 + dx];
          }
        }
        const float gate = (h1 + bias1) * (h2 + bias2);
        a.g[((long long)b * HW + q) * C + c] = gate;
        sum += gate;
      }
      red[ql * nc + ci] = sum;
      __syncthreads();
      if (threadIdx.x < nc) {
        float s = 0.f;
        for (int l = 0; l < lanes; ++l) s += red[l * nc + threadIdx.x];
        a.pooled[b * C + c0 + threadIdx.x] = s / (float)HW;
      }
      __syncthreads();
    }
  }

  // 2. sca[b, o] = W_sca[o, :] . pooled[b, :] + b_sca[o]; one warp per o
  __device__ void phase2() const {
    const float* wsca = w[P_WSCA];
    const float* bsca = w[P_BSCA];
    const int C = a.C, lane = threadIdx.x & 31, warp = threadIdx.x / 32;
    cp_async_wait_all();
    __syncthreads();
    for (int o = blockIdx.x * (kThreads / 32) + warp, round = 0; o < C;
         o += gridDim.x * (kThreads / 32), ++round) {
      const float* row = round == 0 ? Ws + warp * a.ldw : wsca + (long long)o * C;
      for (int b = 0; b < a.B; ++b) {
        float s = 0.f;
#pragma unroll 4
        for (int k = lane; k < C; k += 32) s += a.pooled[b * C + k] * row[k];
        s = warp_sum(s);
        if (lane == 0) a.sca[b * C + o] = s + __ldg(bsca + o);
      }
    }
    __syncthreads();  // the slice in Ws is free again
  }

  // 3. conv3(g * sca), beta residual -> ymid, and LN2's statistics
  template <int CT>
  __device__ void phase3() const {
    constexpr int CG = CT / 4;
    const int C = a.C, HW = a.HW, Pn = P(), nb = bands(), nt = C / CT;
    const float* b3 = w[P_B3];
    const float* beta = w[P_BETA];
    for (int tile = blockIdx.x; tile < tiles3(); tile += gridDim.x) {
      const int band = tile % nb, ct = tile / nb, p0 = band * kRows, o0 = ct * CT;
      if (tile != blockIdx.x) prefetch3(tile);
      auto load = [&](const float4 (&raw)[1], int p, int k) {
        const float4 gv = raw[0], s = ld4(a.sca + (p / HW) * C + k);
        return make_float4(gv.x * s.x, gv.y * s.y, gv.z * s.z, gv.w * s.w);
      };
      auto epi = [&](int r, int cq, const float (&v)[CG]) {
        const int p = p0 + r;
        float ym[CG];
#pragma unroll
        for (int jj = 0; jj < CG; ++jj) {
          const int o = o0 + cq * CG + jj;
          ym[jj] = 0.f;
          if (p < Pn) {
            const long long i = (long long)p * C + o;
            ym[jj] = to_f32(cur[i]) + (v[jj] + __ldg(b3 + o)) * __ldg(beta + o);
            a.ymid[i] = ym[jj];
          }
        }
        const float2 pr = row_partial<CG>(ym);
        if (cq == 0 && p < Pn) a.part[(long long)p * nt + ct] = pr;
      };
      const float* const src[1] = {a.g};
      product_tile<CT>(p0, Pn, C, Ws, a.ldw, src, C, ring, buf, red, load, epi);
      finish_band(band, nt, CT, Pn, C, a.eps, a.part, a.stats2, a.count, flag);
    }
  }

  // 4. LN2 + modulation + conv4 -> t4 (in t1's space)
  template <int CT>
  __device__ void phase4() const {
    constexpr int CG = CT / 4;
    const int C = a.C, C2 = 2 * C, HW = a.HW, Pn = P(), nb = bands();
    const float* g2 = w[P_G2];
    const float* b4 = w[P_B4];
    for (int tile = blockIdx.x; tile < tiles4(); tile += gridDim.x) {
      const int band = tile % nb, p0 = band * kRows, o0 = (tile / nb) * CT;
      if (tile != blockIdx.x) prefetch4(tile);
      rows_stats(a.stats2, p0, Pn);
      auto load = [&](const float4 (&raw)[1], int p, int k) {
        const float2 st = sstats[p - p0];
        const float* t = tm + (long long)(p / HW) * 4 * C;
        const float4 yv = raw[0], gg = ldg4(g2 + k);
        const float4 sc = ldg4(t + 3 * C + k), sh = ldg4(t + 2 * C + k);
        return make_float4(((yv.x - st.x) * st.y * gg.x) * (sc.x + 1.f) + sh.x,
                           ((yv.y - st.x) * st.y * gg.y) * (sc.y + 1.f) + sh.y,
                           ((yv.z - st.x) * st.y * gg.z) * (sc.z + 1.f) + sh.z,
                           ((yv.w - st.x) * st.y * gg.w) * (sc.w + 1.f) + sh.w);
      };
      auto epi = [&](int r, int cq, const float (&v)[CG]) {
        const int p = p0 + r;
        if (p >= Pn) return;
#pragma unroll
        for (int jj = 0; jj < CG; ++jj) {
          const int o = o0 + cq * CG + jj;
          a.t1[(long long)p * C2 + o] = v[jj] + __ldg(b4 + o);
        }
      };
      const float* const src[1] = {a.ymid};
      product_tile<CT>(p0, Pn, C, Ws, a.ldw, src, C, ring, buf, red, load, epi);
    }
  }

  // 5. SimpleGate, conv5, gamma residual -> y rounded to T, and the next
  //    block's LN1 statistics of the rounded rows
  template <int CT>
  __device__ void phase5() const {
    constexpr int CG = CT / 4;
    const int C = a.C, C2 = 2 * C, Pn = P(), nb = bands(), nt = C / CT;
    const float* b5 = w[P_B5];
    const float* gamma = w[P_GAMMA];
    for (int tile = blockIdx.x; tile < tiles3(); tile += gridDim.x) {
      const int band = tile % nb, ct = tile / nb, p0 = band * kRows, o0 = ct * CT;
      if (tile != blockIdx.x) prefetch5(tile);
      auto load = [&](const float4 (&raw)[2], int, int) {
        return make_float4(raw[0].x * raw[1].x, raw[0].y * raw[1].y, raw[0].z * raw[1].z, raw[0].w * raw[1].w);
      };
      auto epi = [&](int r, int cq, const float (&v)[CG]) {
        const int p = p0 + r;
        float yv[CG];
#pragma unroll
        for (int jj = 0; jj < CG; ++jj) {
          const int o = o0 + cq * CG + jj;
          yv[jj] = 0.f;
          if (p < Pn) {
            const long long i = (long long)p * C + o;
            const T out = from_f32<T>(a.ymid[i] + (v[jj] + __ldg(b5 + o)) * __ldg(gamma + o));
            a.y[i] = out;
            yv[jj] = to_f32(out);
          }
        }
        const float2 pr = row_partial<CG>(yv);
        if (cq == 0 && p < Pn) a.part[(long long)p * nt + ct] = pr;
      };
      const float* const src[2] = {a.t1, a.t1 + C};
      product_tile<CT>(p0, Pn, C, Ws, a.ldw, src, C2, ring, buf, red, load, epi);
      finish_band(band, nt, CT, Pn, C, a.eps, a.part, a.stats1, a.count, flag);
    }
  }

  // LN1's statistics of x, the same partials and combination phase 5
  // leaves for the next block (so one launch and a chain of launches
  // agree bit for bit); also clears the band counters
  template <int CT>
  __device__ void opening_partials() const {
    constexpr int CG = CT / 4;
    const int C = a.C, Pn = P(), nb = bands(), nt = C / CT;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < nb; i += gridDim.x * kThreads) a.count[i] = 0;
    for (int tile = blockIdx.x; tile < tiles3(); tile += gridDim.x) {
      const int band = tile % nb, ct = tile / nb;
      const int r = threadIdx.x / 4, cq = threadIdx.x % 4, p = band * kRows + r;
      float v[CG];
#pragma unroll
      for (int jj = 0; jj < CG; ++jj) v[jj] = p < Pn ? to_f32(a.x[(long long)p * C + ct * CT + cq * CG + jj]) : 0.f;
      const float2 pr = row_partial<CG>(v);
      if (cq == 0 && p < Pn) a.part[(long long)p * nt + ct] = pr;
    }
  }
  __device__ void opening_combine() const {
    const int Pn = P(), nt = a.C / a.ct_cc;
    for (int band = blockIdx.x; band < bands(); band += gridDim.x) {
      const float2 st = combine_band(a.part, band, nt, a.ct_cc, Pn, a.C, a.eps);
      const int p = band * kRows + threadIdx.x / 4;
      if ((threadIdx.x & 3) == 0 && p < Pn) a.stats1[p] = st;
    }
  }
};

#define IRSDE_CT_SWITCH(ct, call) \
  switch (ct) {                   \
    case 32: call<32>(); break;   \
    case 16: call<16>(); break;   \
    default: call<8>(); break;    \
  }

template <typename T>
__global__ void __launch_bounds__(kThreads) naf_stack_kernel(Args<T> a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float2 sstats[kRows];
  __shared__ int flag;
  cg::grid_group grid = cg::this_grid();
  // phase timing (a.stamps set): CTA 0 reads the card's clock at the start,
  // before and after every grid barrier, and at the end
  int n_stamps = 0;
  auto stamp = [&]() {
    if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      a.stamps[n_stamps] = t;
    }
    ++n_stamps;
  };
  auto barrier = [&]() {
    stamp();
    grid.sync();
    stamp();
  };

  stamp();
  Block<T> blk{a,
               a.table,
               a.tmod,
               a.x,
               smem + kRingFloats + kSlabFloats + kRedFloats,
               reinterpret_cast<uint8_t*>(smem),
               smem + kRingFloats,
               smem + kRingFloats + kSlabFloats,
               sstats,
               &flag};
  IRSDE_CT_SWITCH(a.ct_cc, blk.template opening_partials)
  if (blockIdx.x < blk.tiles1()) blk.prefetch1(blockIdx.x);  // block 0's first weights, across the barriers
  barrier();
  blk.opening_combine();
  barrier();

  for (int kb = 0; kb < a.K; ++kb) {
    blk.w = a.table + (long long)kb * kPtrs;
    blk.tm = a.tmod + (long long)kb * a.B * 4 * a.C;
    blk.cur = kb == 0 ? a.x : a.y;

    IRSDE_CT_SWITCH(a.ct1, blk.template phase1)
    blk.prefetch2();
    barrier();
    blk.phase2();
    if (blockIdx.x < blk.tiles3()) blk.prefetch3(blockIdx.x);
    barrier();
    IRSDE_CT_SWITCH(a.ct_cc, blk.template phase3)
    if (blockIdx.x < blk.tiles4()) blk.prefetch4(blockIdx.x);
    barrier();
    IRSDE_CT_SWITCH(a.ct4, blk.template phase4)
    if (blockIdx.x < blk.tiles3()) blk.prefetch5(blockIdx.x);
    barrier();
    IRSDE_CT_SWITCH(a.ct_cc, blk.template phase5)
    if (kb + 1 < a.K) {
      if (blockIdx.x < blk.tiles1()) {
        blk.w = a.table + (long long)(kb + 1) * kPtrs;
        blk.prefetch1(blockIdx.x);
      }
      barrier();
    }
  }
  cp_async_wait_all();
  stamp();
}

#undef IRSDE_CT_SWITCH

// the widest tile (32, 16 or 8 columns, at most max_ct) dividing `cols` that
// still gives a phase kTargetTiles tiles over `rows` row groups
int tile_width(long long rows, int cols, int max_ct) {
  for (int ct = 32; ct > 8; ct /= 2)
    if (ct <= max_ct && cols % ct == 0 && rows * (cols / ct) >= kTargetTiles) return ct;
  return 8;
}

struct Layout {
  int ct1, ct_cc, ct4, ldw;
  long long smem;
};

// tile widths and shared memory: the ring, the slab, the reduction
// partials, and the widest weight slice (CT rows, or phase 2's 8 rows of
// W_sca) that the budget holds
Layout layout(int B, long long HW, int C) {
  const long long bands = (B * HW + kRows - 1) / kRows;
  Layout l;
  l.ldw = (C + kSlab - 1) / kSlab * kSlab + 4;
  const long long fixed = (long long)(kRingFloats + kSlabFloats + kRedFloats) * 4;
  const int max_ct = (int)((kMaxSmem - fixed) / (l.ldw * 4LL));
  l.ct1 = tile_width(B, 2 * C, max_ct);  // nc = ct1 / 2 channel pairs of C per tile
  l.ct_cc = tile_width(bands, C, max_ct);
  l.ct4 = tile_width(bands, 2 * C, max_ct);
  int rows = l.ct1 > l.ct4 ? l.ct1 : l.ct4;
  rows = rows > l.ct_cc ? rows : l.ct_cc;
  rows = rows > kThreads / 32 ? rows : kThreads / 32;
  l.smem = fixed + (long long)rows * l.ldw * 4;
  return l;
}

long long workspace_floats(long long B, long long HW, long long C) {
  const long long P = B * HW, bands = (P + kRows - 1) / kRows;
  // t1/t4, g, ymid, pooled, sca, partials (at most C / 8 tiles a row), stats1, stats2, counters
  return P * (2 * C + C + C) + 2 * B * C + P * (C / 8) * 2 + 2 * P + 2 * P + bands;
}

template <typename T>
cudaError_t launch(const void* x, void* y, const float* tmod, const float* const* table,
                   float* ws, int B, int H, int W, int C, int K, float eps, long long* stamps,
                   cudaStream_t stream) {
  auto kernel = naf_stack_kernel<T>;
  const long long HW = (long long)H * W, P = B * HW;
  const Layout l = layout(B, HW, C);
  if (l.smem > kMaxSmem) return cudaErrorInvalidValue;
  int device = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, (size_t)l.smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;

  // no more blocks than the widest phase has tiles (the grid never depends on K)
  const long long bands = (P + kRows - 1) / kRows;
  long long want = (long long)B * (2 * C / l.ct1);
  want = want > bands * (C / l.ct_cc) ? want : bands * (C / l.ct_cc);
  want = want > bands * (2 * C / l.ct4) ? want : bands * (2 * C / l.ct4);
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(want < cap ? want : cap);

  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.y = static_cast<T*>(y);
  a.tmod = tmod;
  a.table = table;
  a.t1 = ws;
  a.g = a.t1 + P * 2 * C;
  a.ymid = a.g + P * C;
  a.pooled = a.ymid + P * C;
  a.sca = a.pooled + (long long)B * C;
  a.part = reinterpret_cast<float2*>(a.sca + (long long)B * C);
  a.stats1 = a.part + P * (C / 8);
  a.stats2 = a.stats1 + P;
  a.count = reinterpret_cast<int*>(a.stats2 + P);
  a.B = B;
  a.HW = (int)HW;
  a.H = H;
  a.W = W;
  a.C = C;
  a.K = K;
  a.ct1 = l.ct1;
  a.ct_cc = l.ct_cc;
  a.ct4 = l.ct4;
  a.ldw = l.ldw;
  a.eps = eps;
  a.stamps = stamps;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), params, (size_t)l.smem, stream);
}

}  // namespace

extern "C" long long irsde_naf_stack_workspace(int B, int H, int W, int C) {
  return workspace_floats(B, (long long)H * W, C);
}

// room for the phase-timing readings of a K-block launch: the start, two
// around each of the 2 + 5K - 1 grid barriers, the end
extern "C" int irsde_naf_stack_stamps(int K) { return 2 + 2 * (2 + 5 * K - 1); }

// stamps: null, or int64 room for irsde_naf_stack_stamps(K) nanosecond
// readings of the card's clock by CTA 0
extern "C" int irsde_naf_stack(const void* x, void* y, const void* tmod, const void* table,
                               void* ws, int B, int H, int W, int C, int K, float eps,
                               int dtype, void* stamps, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tm = static_cast<const float*>(tmod);
  const float* const* tab = static_cast<const float* const*>(table);
  float* w = static_cast<float*>(ws);
  long long* st = static_cast<long long*>(stamps);
  cudaError_t err =
      dtype == IRSDE_BF16 ? launch<__nv_bfloat16>(x, y, tm, tab, w, B, H, W, C, K, eps, st, s)
      : dtype == IRSDE_F32 ? launch<float>(x, y, tm, tab, w, B, H, W, C, K, eps, st, s)
                           : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
