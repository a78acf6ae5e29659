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
// Bound on the H100: bytes.  At the Refusion latent shapes (K = 28,
// C = 512, 8x8 maps, batch 4) the kernel must read ~207 MB of float32
// weights for ~23 GFLOP; the weights take ~0.062 ms at 3.35 TB/s.
//
// Design (simple first): one cooperative, persistent launch whose grid is
// as large as can be co-resident; each NAFBlock runs as six phases
// separated by grid-wide barriers, because the depthwise conv's neighbours
// and the SCA mean over H*W cross pixel tiles:
//   1. LN1 + modulation + conv1          -> t1    (P, 2C)
//   2. dwconv3x3 + SimpleGate + HW mean  -> g (P, C), pooled (B, C)
//   3. SCA 1x1 on the pooled vector      -> sca   (B, C)
//   4. g * sca, conv3, beta residual     -> ymid  (P, C)
//   5. LN2 + modulation + conv4          -> t4    (P, 2C), aliasing t1
//   6. SimpleGate, conv5, gamma residual -> y     (P, C) in x's dtype
// The intermediates live in a float32 workspace that L2 holds at these
// sizes.  Each 1x1 conv is a 32x32-tiled shared-memory FMA loop over the
// weight as PyTorch stores it, (out, in) row-major; the LayerNorm statistics
// of a tile's rows are taken in its prologue.  Every sum runs in a fixed
// order (no atomics), so results do not depend on scheduling.  Weights are
// read in place through a device table of per-block pointers.
//
// Left for later: wgmma/TMA tiles, one cluster per sample with the
// activation in distributed shared memory, and fewer grid barriers.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // rows, output channels and reduction depth of a GEMM tile

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
  float* t1;                   // (P, 2C), also t4
  float* g;                    // (P, C)
  float* pooled;               // (B, C)
  float* sca;                  // (B, C)
  float* ymid;                 // (P, C)
  int B, HW, H, W, C, K;
  float eps;
};

struct Smem {
  float a[kTile][kTile + 1];   // [k][row]
  float w[kTile][kTile + 1];   // [k][out]
  float mean[kTile];
  float rstd[kTile];
  float red[kThreads / 32][32];
};

// LayerNorm statistics (centered variance) of the kTile rows of a (P, C)
// tensor starting at row p0; one warp per row.
template <typename S>
__device__ void row_stats(const S* src, int p0, int P, int C, float eps, Smem& sm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int p = p0 + r;
    float mean = 0.f, rstd = 0.f;
    if (p < P) {
      const S* row = src + (long long)p * C;
      float s = 0.f;
      for (int k = lane; k < C; k += 32) s += to_f32(row[k]);
      mean = warp_sum(s) / (float)C;
      float q = 0.f;
      for (int k = lane; k < C; k += 32) {
        const float d = to_f32(row[k]) - mean;
        q += d * d;
      }
      rstd = rsqrtf(warp_sum(q) / (float)C + eps);
    }
    if (lane == 0) {
      sm.mean[r] = mean;
      sm.rstd[r] = rstd;
    }
  }
}

// Grid-strided 32x32 tiles of out[p, o] = epi(p, o, sum_k in(p, k) * W[o, k])
// for p < P, o < O, k < Kd.  `load(p, k, r, sm)` gives the input element
// (r: p's row in the tile), and `prologue(p0, sm)` runs before a tile's
// reduction loop.
template <typename Load, typename Prologue, typename Epi>
__device__ void gemm_tiles(int P, int O, int Kd, const float* __restrict__ Wt, Load load,
                           Prologue prologue, Epi epi, Smem& sm) {
  const int tiles_p = (P + kTile - 1) / kTile, tiles_o = (O + kTile - 1) / kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // 2 outputs x 2 rows each
  for (int tile = blockIdx.x; tile < tiles_p * tiles_o; tile += gridDim.x) {
    const int p0 = (tile / tiles_o) * kTile, o0 = (tile % tiles_o) * kTile;
    prologue(p0, sm);
    __syncthreads();
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int k0 = 0; k0 < Kd; k0 += kTile) {
#pragma unroll
      for (int j = 0; j < kTile * kTile / kThreads; ++j) {
        const int idx = threadIdx.x + j * kThreads;
        const int r = idx / kTile, k = idx % kTile;
        const int p = p0 + r, o = o0 + r, kk = k0 + k;
        sm.a[k][r] = (p < P && kk < Kd) ? load(p, kk, r, sm) : 0.f;
        sm.w[k][r] = (o < O && kk < Kd) ? __ldg(Wt + (long long)o * Kd + kk) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kTile; ++k) {
        const float a0 = sm.a[k][2 * ty], a1 = sm.a[k][2 * ty + 1];
        const float w0 = sm.w[k][2 * tx], w1 = sm.w[k][2 * tx + 1];
        acc[0][0] += a0 * w0;
        acc[0][1] += a0 * w1;
        acc[1][0] += a1 * w0;
        acc[1][1] += a1 * w1;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = p0 + 2 * ty + i, o = o0 + 2 * tx + j;
        if (p < P && o < O) epi(p, o, acc[i][j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) naf_stack_kernel(Args<T> a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int C = a.C, C2 = 2 * a.C, HW = a.HW;
  const int P = a.B * HW;

  for (int kb = 0; kb < a.K; ++kb) {
    const float* const* w = a.table + (long long)kb * kPtrs;
    const float* tm = a.tmod + (long long)kb * a.B * 4 * C;
    const T* cur = kb == 0 ? a.x : a.y;
    auto no_prologue = [](int, Smem&) {};

    // 1. LN1 + modulation + conv1 -> t1
    {
      const float* g1 = w[P_G1];
      const float* b1 = w[P_B1];
      auto stats = [&](int p0, Smem& s) { row_stats(cur, p0, P, C, a.eps, s); };
      auto load = [&](int p, int k, int r, Smem& s) {
        const float* t = tm + (long long)(p / HW) * 4 * C;
        const float h = (to_f32(cur[(long long)p * C + k]) - s.mean[r]) * s.rstd[r] * __ldg(g1 + k);
        return h * (t[C + k] + 1.f) + t[k];
      };
      auto epi = [&](int p, int o, float v) { a.t1[(long long)p * C2 + o] = v + __ldg(b1 + o); };
      gemm_tiles(P, C2, C, w[P_W1], load, stats, epi, sm);
    }
    grid.sync();

    // 2. dwconv3x3 (zero padding) + SimpleGate -> g, and the per-sample
    //    channel means -> pooled.  A tile is (sample, 32 gated channels);
    //    lanes take channels, warps take pixels.
    {
      const float* wdw = w[P_WDW];
      const float* b2 = w[P_B2];
      const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
      const int tiles_c = (C + 31) / 32;
      for (int tile = blockIdx.x; tile < a.B * tiles_c; tile += gridDim.x) {
        const int b = tile / tiles_c, c = (tile % tiles_c) * 32 + lane;
        float sum = 0.f;
        if (c < C) {
          float k1[9], k2[9];
#pragma unroll
          for (int j = 0; j < 9; ++j) {
            k1[j] = __ldg(wdw + c * 9 + j);
            k2[j] = __ldg(wdw + (c + C) * 9 + j);
          }
          const float bias1 = __ldg(b2 + c), bias2 = __ldg(b2 + c + C);
          for (int q = warp; q < HW; q += kThreads / 32) {
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
        }
        sm.red[warp][lane] = sum;
        __syncthreads();
        if (warp == 0 && c < C) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kThreads / 32; ++i) s += sm.red[i][lane];
          a.pooled[b * C + c] = s / (float)HW;
        }
        __syncthreads();
      }
    }
    grid.sync();

    // 3. sca[b, o] = W_sca[o, :] . pooled[b, :] + b_sca[o]; one warp each
    {
      const float* wsca = w[P_WSCA];
      const float* bsca = w[P_BSCA];
      const int lane = threadIdx.x & 31;
      const int warps = gridDim.x * (kThreads / 32);
      for (int i = blockIdx.x * (kThreads / 32) + threadIdx.x / 32; i < a.B * C; i += warps) {
        const int b = i / C, o = i % C;
        float s = 0.f;
        for (int k = lane; k < C; k += 32) s += a.pooled[b * C + k] * __ldg(wsca + (long long)o * C + k);
        s = warp_sum(s);
        if (lane == 0) a.sca[i] = s + __ldg(bsca + o);
      }
    }
    grid.sync();

    // 4. conv3(g * sca) and the beta residual -> ymid
    {
      const float* b3 = w[P_B3];
      const float* beta = w[P_BETA];
      auto load = [&](int p, int k, int, Smem&) {
        return a.g[(long long)p * C + k] * a.sca[(p / HW) * C + k];
      };
      auto epi = [&](int p, int o, float v) {
        const long long i = (long long)p * C + o;
        a.ymid[i] = to_f32(cur[i]) + (v + __ldg(b3 + o)) * __ldg(beta + o);
      };
      gemm_tiles(P, C, C, w[P_W3], load, no_prologue, epi, sm);
    }
    grid.sync();

    // 5. LN2 + modulation + conv4 -> t4 (in t1's space)
    {
      const float* g2 = w[P_G2];
      const float* b4 = w[P_B4];
      auto stats = [&](int p0, Smem& s) { row_stats(a.ymid, p0, P, C, a.eps, s); };
      auto load = [&](int p, int k, int r, Smem& s) {
        const float* t = tm + (long long)(p / HW) * 4 * C;
        const float h = (a.ymid[(long long)p * C + k] - s.mean[r]) * s.rstd[r] * __ldg(g2 + k);
        return h * (t[3 * C + k] + 1.f) + t[2 * C + k];
      };
      auto epi = [&](int p, int o, float v) { a.t1[(long long)p * C2 + o] = v + __ldg(b4 + o); };
      gemm_tiles(P, C2, C, w[P_W4], load, stats, epi, sm);
    }
    grid.sync();

    // 6. SimpleGate, conv5 and the gamma residual -> y, rounded to T
    {
      const float* b5 = w[P_B5];
      const float* gamma = w[P_GAMMA];
      auto load = [&](int p, int k, int, Smem&) {
        const float* row = a.t1 + (long long)p * C2;
        return row[k] * row[k + C];
      };
      auto epi = [&](int p, int o, float v) {
        const long long i = (long long)p * C + o;
        a.y[i] = from_f32<T>(a.ymid[i] + (v + __ldg(b5 + o)) * __ldg(gamma + o));
      };
      gemm_tiles(P, C, C, w[P_W5], load, no_prologue, epi, sm);
    }
    grid.sync();
  }
}

long long workspace_floats(long long B, long long HW, long long C) {
  return B * HW * (2 * C + C + C) + 2 * B * C;  // t1/t4, g, ymid, pooled, sca
}

template <typename T>
cudaError_t launch(const void* x, void* y, const float* tmod, const float* const* table,
                   float* ws, int B, int H, int W, int C, int K, float eps,
                   cudaStream_t stream) {
  auto kernel = naf_stack_kernel<T>;
  int device = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;

  // no more blocks than the widest phase has work items
  const long long P = (long long)B * H * W;
  const long long gemm = ((P + kTile - 1) / kTile) * ((2LL * C + kTile - 1) / kTile);
  const long long dw = (long long)B * ((C + 31) / 32);
  const long long sca = ((long long)B * C + kThreads / 32 - 1) / (kThreads / 32);
  long long want = gemm > dw ? gemm : dw;
  want = want > sca ? want : sca;
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
  a.B = B;
  a.HW = H * W;
  a.H = H;
  a.W = W;
  a.C = C;
  a.K = K;
  a.eps = eps;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), params, 0, stream);
}

}  // namespace

extern "C" long long irsde_naf_stack_workspace(int B, int H, int W, int C) {
  return workspace_floats(B, (long long)H * W, C);
}

extern "C" int irsde_naf_stack(const void* x, void* y, const void* tmod, const void* table,
                               void* ws, int B, int H, int W, int C, int K, float eps,
                               int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tm = static_cast<const float*>(tmod);
  const float* const* tab = static_cast<const float* const*>(table);
  float* w = static_cast<float*>(ws);
  cudaError_t err =
      dtype == IRSDE_BF16 ? launch<__nv_bfloat16>(x, y, tm, tab, w, B, H, W, C, K, eps, s)
      : dtype == IRSDE_F32 ? launch<float>(x, y, tm, tab, w, B, H, W, C, K, eps, s)
                           : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
