// Attention forward with an online softmax (flash attention) over
// (B, N, H, D) tensors, heads of D = 64 or 72:
//
//     s = q k^T (f32 sums) * scale;  running row max m and sum l in f32;
//     p = exp(s - m), rounded to v's dtype;  acc = acc * exp(m_old - m) + p v
//     (f32 sums);  out = acc / l, stored in q's dtype.
//
// Replaces the Pallas TPU kernel image_restoration_sde_tpu/ops/flash_attention.py
// (_fa_kernel, launched by _flash_forward): the same arithmetic, tile by
// tile, with p rounded before the p v product and l summed from the
// unrounded p, as there.
//
// Bound on the H100: operations.  4 B H N^2 D FLOP against 4 B N H D
// elements moved; at the DiT-L/2 operating point (N = 4096, D = 64) that is
// ~2000 FLOP per byte, far above the ~295 FLOP/byte bf16 ridge, and as
// many exponentials (B H N^2) as the tensor cores do 512-FLOP rows, so the
// exponential unit comes close to the bound too.  Design (bf16): one CTA of
// four warps per (64-query tile, head, batch); each warp holds its 16 query
// rows' fragments in registers, streams 64-key tiles of k and v through
// shared memory with cp.async (v's load overlaps q k^T, the next k's load
// overlaps p v), and runs both products on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 sums).  The score tile never leaves
// registers: its accumulator fragments are the A fragments of p v once
// rounded to bf16.  Key columns past N score -1e30 (finite, as the TPU
// kernel's _NEG_INF); rows past N load as zeros and are never stored; head
// dims pad with zeros to a multiple of 16 (72 -> 80) inside the kernel.
// float32 inputs run on the FMA units (TF32 stays off), 32x32 tiles.
// q, k and v take any batch and token stride (a multiple of 16 bytes), so
// the (B, N, 3, H, D) view of a packed qkv product goes in with no copy.
//
// Every tile is visited in the same order by one CTA, with no atomics and
// no split over keys, so results do not depend on scheduling.
//
// Left for later: wgmma and TMA, warp specialisation, double-buffered k/v,
// 16-byte output stores through shared memory.

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // finite: a -inf max would make 0 * inf = nan

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;  // contiguous (B, N, H, D)
  long long q_sb, q_sn, k_sb, k_sn, v_sb, v_sn;  // strides in elements; head stride is D
  int B, N, H, D;
  float scale;
};

// ------------------------------------------------------------------ bf16

constexpr int kBQ = 64;  // query rows per CTA, 16 per warp
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;
static_assert(kBQ == kBK, "q, k and v tiles share one loader");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16; c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<unsigned*>(&v);
}

// rows [row0, row0 + 64) of one head into a (64, LD) shared tile, DP columns
// (the D real ones, zeros past D and past N)
template <int DP, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* tile, const __nv_bfloat16* base, long long sn,
                                               int row0, int N, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool valid = row0 + r < N && col < D;
    const __nv_bfloat16* src = valid ? base + (long long)(row0 + r) * sn + col : base;
    cp_async16(tile + r * LD + col, src, valid);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  constexpr int LD = DP + 8;     // +16 bytes a row: conflict-free ldmatrix
  constexpr int KS = DP / 16;    // k-steps of q k^T
  constexpr int NT_O = DP / 8;   // 8-wide column tiles of the output
  constexpr int NT_S = kBK / 8;  // 8-wide column tiles of the scores
  __shared__ __align__(128) uint16_t smem[3 * kBK * LD];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBK * LD;
  __nv_bfloat16* sV = sK + kBK * LD;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, column pair
  const int N = p.N, D = p.D;
  const auto* Q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + (long long)h * D;
  const auto* K = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + (long long)h * D;
  const auto* V = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + (long long)h * D;

  load_tile_bf16<DP, LD>(sQ, Q, p.q_sn, q0, N, D);
  cp_async_commit();
  load_tile_bf16<DP, LD>(sK, K, p.k_sn, 0, N, D);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per k-step
  unsigned qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums

  const int n_tiles = (N + kBK - 1) / kBK;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();  // k tile j
    __syncthreads();     // ... for every warp; every warp is done with v tile j - 1
    load_tile_bf16<DP, LD>(sV, V, p.v_sn, j * kBK, N, D);
    cp_async_commit();

    float s[NT_S][4];
#pragma unroll
    for (int i = 0; i < NT_S; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        const int mat = lane >> 3;
        unsigned bk[4];
        ldmatrix_x4(bk, sK + (np * 16 + (lane & 7) + (mat >> 1) * 8) * LD + ks * 16 + (mat & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }

    // scale, mask the keys past N, running max
    const int key0 = j * kBK + tig * 2;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + (e & 1);
        s[nt][e] = key < N ? s[nt][e] * p.scale : kNegInf;
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
    }

    // p = exp(s - m): f32 into the row sums, bf16 into p v's A fragments
    unsigned pa[kBK / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      const float p0 = __expf(s[nt][0] - m[0]), p1 = __expf(s[nt][1] - m[0]);
      const float p2 = __expf(s[nt][2] - m[1]), p3 = __expf(s[nt][3] - m[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    cp_async_wait<0>();  // v tile j
    __syncthreads();     // ... for every warp; every warp is done with k tile j
    if (j + 1 < n_tiles) {
      load_tile_bf16<DP, LD>(sK, K, p.k_sn, (j + 1) * kBK, N, D);
      cp_async_commit();
    }

#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) {
#pragma unroll
      for (int dp = 0; dp < NT_O / 2; ++dp) {
        const int mat = lane >> 3;
        unsigned bv[4];
        ldmatrix_x4_trans(bv, sV + (t * 16 + (lane & 7) + (mat & 1) * 8) * LD + dp * 16 + (mat >> 1) * 8);
        mma_bf16(acc[2 * dp], pa[t], bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa[t], bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  auto* O = static_cast<__nv_bfloat16*>(p.o) + (long long)b * N * p.H * D + (long long)h * D;
  const long long o_sn = (long long)p.H * D;
  const int row = q0 + warp * 16 + g;
#pragma unroll
  for (int i = 0; i < NT_O; ++i) {
    const int d = i * 8 + tig * 2;
    if (d >= D) continue;
    if (row < N)
      *reinterpret_cast<unsigned*>(O + row * o_sn + d) = pack_bf16(acc[i][0] / l[0], acc[i][1] / l[0]);
    if (row + 8 < N)
      *reinterpret_cast<unsigned*>(O + (row + 8) * o_sn + d) = pack_bf16(acc[i][2] / l[1], acc[i][3] / l[1]);
  }
}

// ------------------------------------------------------------------ f32

constexpr int kF32Rows = 32;  // query rows per CTA: 8 thread rows x 4
constexpr int kF32Keys = 32;  // keys per tile: 16 thread columns x 2
constexpr int kF32Threads = 128;

// rows [row0, row0 + 32) of one head into a shared tile with row stride ld
template <int DP>
__device__ __forceinline__ void load_tile_f32(float* tile, int ld, const float* base, long long sn, int row0,
                                              int N, int D) {
  for (int i = threadIdx.x; i < kF32Rows * DP; i += kF32Threads) {
    const int r = i / DP, d = i % DP;
    tile[r * ld + d] = row0 + r < N && d < D ? base[(long long)(row0 + r) * sn + d] : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32(const Params p) {
  constexpr int LDK = DP + 1;  // odd row stride: the 16 column threads hit 16 banks
  constexpr int LDP = kF32Keys + 1;
  constexpr int ND = DP / 16;  // output columns per thread
  __shared__ float sQ[kF32Rows * LDK];
  __shared__ float sK[kF32Keys * LDK];
  __shared__ float sV[kF32Keys * DP];
  __shared__ float sP[kF32Rows * LDP];

  const int q0 = blockIdx.x * kF32Rows, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;  // rows ty*4 + i; keys and dims tx + 16*j
  const int N = p.N, D = p.D;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + (long long)h * D;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + (long long)h * D;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + (long long)h * D;

  load_tile_f32<DP>(sQ, LDK, Q, p.q_sn, q0, N, D);
  float acc[4][ND] = {};
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kF32Keys) {
    __syncthreads();  // every thread is done with the previous tiles
    load_tile_f32<DP>(sK, LDK, K, p.k_sn, k0, N, D);
    load_tile_f32<DP>(sV, DP, V, p.v_sn, k0, N, D);
    __syncthreads();

    float s[4][2] = {};
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LDK + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = sK[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = k0 + tx + 16 * j < N ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float corr = expf(m[i] - mx);
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pij = expf(s[i][j] - mx);
        rs += pij;
        sP[(ty * 4 + i) * LDP + tx + 16 * j] = pij;  // rounding to v's dtype: none in f32
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kF32Keys; ++c) {
      float pv[4], vv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) vv[j] = sV[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* O = static_cast<float*>(p.o) + (long long)b * N * p.H * D + (long long)h * D;
  const long long o_sn = (long long)p.H * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + 16 * j;
      if (d < D) O[row * o_sn + d] = acc[i][j] / l[i];
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == IRSDE_BF16) {
    const dim3 grid((unsigned)((p.N + kBQ - 1) / kBQ), (unsigned)p.H, (unsigned)p.B);
    flash_fwd_bf16<DP><<<grid, kThreads, 0, stream>>>(p);
  } else {
    const dim3 grid((unsigned)((p.N + kF32Rows - 1) / kF32Rows), (unsigned)p.H, (unsigned)p.B);
    flash_fwd_f32<DP><<<grid, kF32Threads, 0, stream>>>(p);
  }
  return cudaSuccess;
}

}  // namespace

// q, k, v: (B, N, H, D) with unit dim stride, head stride D and the given
// batch and token strides (elements); o: contiguous (B, N, H, D).
extern "C" int irsde_flash_attention(const void* q, const void* k, const void* v, void* o, long long q_sb,
                                     long long q_sn, long long k_sb, long long k_sn, long long v_sb,
                                     long long v_sn, int B, int N, int H, int D, float scale, int dtype,
                                     void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || H > 65535 || B > 65535 || (D != 64 && D != 72)) return (int)cudaErrorInvalidValue;
  if (dtype != IRSDE_BF16 && dtype != IRSDE_F32) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, B, N, H, D, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = D == 64 ? launch<64>(p, dtype, s) : launch<80>(p, dtype, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
