// Attention forward with an online softmax (flash attention) over
// (B, N, H, D) tensors, heads of D = 64 or 72:
//
//     s = q k^T (f32 sums) * scale;  running row max m and sum l in f32;
//     p = exp(s - m), rounded to v's dtype;  acc = acc * exp(m_old - m) + p v
//     (f32 sums);  out = acc / l, stored in q's dtype.
//
// Replaces the Pallas TPU kernel image_restoration_sde_tpu/ops/flash_attention.py
// (_fa_kernel, launched by _flash_forward): the same arithmetic, tile by
// tile, with p rounded at its key tile's running max before the p v
// product and l summed from the unrounded p, as there.
//
// Bound on the H100: operations.  4 B H N^2 D FLOP against 4 B N H D
// elements moved; at the DiT-L/2 operating point (N = 4096, D = 64) that is
// ~2000 FLOP per byte, far above the ~295 FLOP/byte bf16 ridge, and as many
// exponentials (B H N^2) as the tensor cores do 512-FLOP rows: at 16 ex2 per
// clock and SM the exponentials alone take about as long as the products
// at their peak, so the exponentials of one tile have to overlap the
// products of another.
//
// bf16, D = 64 (DiT-L/2) and D = 72 (DiT-XL/2): flash_fwd_wgmma<D>, built
// for Hopper.  One CTA of three warpgroups per (128-query tile, head, batch):
//   - warpgroup 0 is the producer: one thread loads the q tile and streams
//     128-key k and v tiles into a kStages-deep shared-memory ring with TMA
//     (cp.async.bulk.tensor, 4-D maps over (D, H, N, B) with the caller's
//     strides, rows past N zero-filled), each stage's k and v tracked by
//     their own "full" mbarrier and released by an "empty" one;
//   - a tile's row is columns 0..63 in the 128-byte swizzle (a 128-byte
//     box) and, at D = 72, columns 64..79 in the 32-byte swizzle (a 32-byte
//     box of a second map): 144-byte rows fit no one swizzle box.  Both maps
//     keep dims[0] = D, so TMA zero-fills columns 72..79 on load and clips
//     them on store; each part sits on its swizzle atom (1024 and 256
//     bytes), and a tile's two parts complete on one barrier;
//   - warpgroups 1 and 2 each own 64 query rows and run both products on
//     wgmma: S = Q K^T as m64n128k16 from shared memory (Q and K K-major;
//     four k16 steps on the 128-byte parts, at D = 72 a fifth on the 32-byte
//     parts, whose zero columns add nothing), O += P V as m64n64k16 (and at
//     D = 72 m64n16k16 on the 32-byte part, its 8 zero columns dropped at
//     the store) with P from registers (the S accumulator rounded to bf16
//     is the A fragment) and V read MN-major, so no transpose pass.  Tile
//     j's S product is issued together with tile j - 1's P V product, and
//     the two warpgroups take turns issuing them (named barriers), so one
//     warpgroup's softmax runs under the other's products;
//   - softmax: the row max is taken on the raw scores and p = exp2(s c -
//     m c) with c = scale log2(e) folded into one FFMA (scale must be > 0);
//   - epilogue: O / l in bf16 into the (dead) q tile in the swizzled
//     layouts, then one TMA store per part and warpgroup, which clips rows
//     past N.
// At D = 72 the products run 80 wide: q k^T does 25% and p v 25% more
// tensor-core work than at 64, 11% more than the function's own 72.
// Shared memory: a q, k or v tile is 16 KB (D = 64) or 20 KB (D = 72), so
// the three-stage ring takes 113 KB or 141 KB of the 227 KB; one CTA an SM
// either way (384 threads at up to 240 registers a consumer thread).  Of
// two and three stages, three was the faster at D = 72 on an NVIDIA H100
// 80GB HBM3 at 700 W (0.41-0.45 ms against 0.50 at (2, 4096, 16, 72)).
// The tensor maps are encoded on the host (the last kMapCache kept, by
// pointer, shape, strides and box); cuTensorMapEncodeTiled is reached
// through cudaGetDriverEntryPoint, so no -lcuda.  A failed encode or launch
// returns its error to the caller.
//
// float32, D = 64 and 72 (DiT training, tensor-parallel DiT ranks):
// tc::flash_fwd_f32, both products on the tensor cores at float32 accuracy
// by a three-way TF32 split ("3xTF32").  Each operand x is split as
// x_hi = cvt.rna.tf32(x), x_lo = cvt.rna.tf32(x - x_hi) (round to nearest,
// ties away: a float32 register fed to a TF32 mma unconverted would be
// truncated), and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi, the
// small terms first, into float32 accumulators; the dropped a_lo b_lo term
// and the halves' rounding leave ~2^-22 of each product, where one TF32
// product alone leaves ~2^-11 (1e-3 of the output, past the 1e-5 bound).
// Plain TF32 would change the function the JAX package computes.  The
// bound moves from 4 B H N^2 D FLOP on the FMA units (67 TFLOP/s) to three
// times that at the TF32 rate (494.7 TFLOP/s): 3.33 ms at the DiT-L/2 train
// shape (8, 4096, 16, 64), against 8.21 on FMA.  Choices:
//   - route: mma.sync m16n8k8 .tf32.  wgmma .tf32 wants both shared
//     operands K-major, and v's tile (keys x D, D contiguous) is MN-major
//     for p v, so it would need a transposed copy of every v tile;
//   - one CTA of four warps per 128-query tile (two 16-row m-tiles a warp,
//     so each k or v fragment split feeds two m-tiles), k/v tiles of 32
//     keys double-buffered by 16-byte cp.async (rows past N zero-filled),
//     one __syncthreads a tile; ~73 KB of dynamic shared memory and ~250
//     registers a thread (the tile's p halves and o): two CTAs an SM.  Of
//     one or two m-tiles a warp and 32 or 64 keys a tile, this was the
//     fastest that keeps D = 72 clear of the register limit;
//   - the split is done by each consumer warp on the fragments it loads,
//     not once by the loader into hi/lo tiles: a CTA's fragment loads read
//     96 KB of shared memory a 32-key tile (D = 64), 768 clocks at 128
//     bytes a clock, against 1536 m16n8k8 products, ~1536 clocks at the
//     TF32 peak; hi/lo tiles would double those bytes, while the warps'
//     conversions issue beside the products;
//   - p never leaves registers: the m16n8k8 accumulator holds columns
//     (2t, 2t + 1) of rows g, g + 8 and the A operand wants k-slots (t,
//     t + 4), so slot t takes key 2t and slot t + 4 key 2t + 1, and v's B
//     fragment rows are read in that order (q k^T permutes d the same way,
//     so its q and k fragments are single 8-byte loads);
//   - padded rows, no swizzle: q and k rows of 72 floats (8-byte fragment
//     loads conflict-free), v rows of D + 4 (4-byte loads conflict-free);
//   - softmax as the bf16 path's: the running max of the raw scores, p =
//     exp2(s c - m c) with c = scale log2(e), p in float32 into the row sums
//     and, split, into p v;
//   - each tile's p v goes into fresh accumulators, added to o by the
//     rescale's own FFMA (o = o corr + p v): the tensor cores' adds
//     truncate to the accumulator's exponent, and into o, summed over every
//     key so far, that is a bias growing with N (past the 1e-5 bound at
//     N = 4096); a tile's sum is small and the FFMA rounds to nearest.
// q, k and v take any batch and token stride (a multiple of 16 bytes), so
// the (B, N, 3, H, D) view of a packed qkv product goes in with no copy.
//
// Every tile is visited in the same order by one CTA, with no atomics and
// no split over keys, so results do not depend on scheduling.

#include <cuda.h>

#include <mutex>

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

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<unsigned*>(&v);
}

// ------------------------------------------------------------------ bf16: wgmma + TMA, D = 64 and 72

namespace wg {

constexpr int kBQ = 128;                     // query rows per CTA, 64 per consumer warpgroup
constexpr int kBK = 128;                     // keys per k/v tile
constexpr int kStages = 3;                   // k/v ring depth
constexpr int kThreads = 384;                // warpgroup 0 producer, 1 and 2 consumers
constexpr int kMainCols = 64;                // columns 0..63: 128-byte rows in the 128-byte swizzle
constexpr int kTailCols = 16;                // columns 64..79 (D = 72): 32-byte rows in the 32-byte swizzle
constexpr int kMainBytes = kBK * kMainCols * 2;  // 16 KB a tile
constexpr int kTailBytes = kBK * kTailCols * 2;  // 4 KB a tile
template <int D>
constexpr bool kTail = D > kMainCols;
// one q, k or v tile: its 128-byte part, then (D = 72) its 32-byte part;
// 20 KB keeps every tile and both parts on 1024-byte boundaries
template <int D>
constexpr int kTileBytes = kMainBytes + (kTail<D> ? kTailBytes : 0);
template <int D>
constexpr int kSmem = 1024 + kTileBytes<D> * (1 + 2 * kStages);  // + slack to align to 1024
constexpr int kBarTurn = 1;                  // named barriers 1, 2: whose turn to issue wgmma
constexpr int kBarStore = 3;                 // named barriers 3, 4: a warpgroup's output tile is staged
static_assert(kBQ == kBK, "q, k and v share one tensor-map box");

// the tensor maps of one launch: the 128-byte parts (box of 64 columns)
// and, at D = 72, the 32-byte parts (box of 16 columns from column 64 of
// maps whose dims[0] is 72: columns 72..79 zero-filled on load, clipped on
// store)
template <int D>
struct Maps {
  CUtensorMap q, k, v, o;
};
template <>
struct Maps<72> {
  CUtensorMap q, k, v, o, q2, k2, v2, o2;
};

struct Barriers {
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}
// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// the map's box at (col, h, row, b) -> dst; completion counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int h, int row,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// src -> the map's box at (col, h, row, b)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int col, int h, int row, int b) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(col), "r"(h), "r"(row), "r"(b)
               : "memory");
}
// returns once every store issued so far has read its shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the 128-byte
// swizzle (1024-byte atoms of 8 rows, 1024-byte aligned): start address,
// leading and stride byte offsets both 1024 (the next 8-row group; the
// leading offset is not read by a K-major operand, nor by an MN-major one
// 64 columns wide), layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// the same for a tile of 32-byte rows in the 32-byte swizzle (256-byte
// atoms of 8 rows, 256-byte aligned): leading and stride byte offsets both
// 256, layout type 3 (32B swizzle).  K-major (q and k, one k16 step: the 16
// columns are the atom's width) the stride offset steps 8 rows; MN-major
// (v, n16: one atom wide, so the leading offset is never followed) it steps
// 8 keys
__device__ __forceinline__ uint64_t sw32_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(256 >> 4) << 16) | (uint64_t(256 >> 4) << 32) | (uint64_t(3) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous issue and the wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, f32) = a (64 x 16) b (16 x 128) [+ d if accumulate]: a and b K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += a (64 x 16: bf16 fragments in registers) b (16 x 64: MN-major bf16 in shared memory)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16, f32) += a (64 x 16: bf16 fragments in registers) b (16 x 16: MN-major bf16 in shared memory)
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ Maps<D> maps, int N, float c) {  // c = scale * log2(e)
  constexpr int kTB = kTileBytes<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bar;
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  auto sK = [&](int s) { return base + kTB * (1 + s); };
  auto sV = [&](int s) { return base + kTB * (1 + kStages + s); };

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (N + kBK - 1) / kBK;
  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&bar.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.k_full[s], 1);
      mbar_init(&bar.v_full[s], 1);
      mbar_init(&bar.empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: one thread keeps the ring full (a tile's two parts on one
    // barrier); the warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar.q_full, kTB);
      tma_load(sQ, &maps.q, &bar.q_full, 0, h, q0, b);
      if constexpr (kTail<D>) tma_load(sQ + kMainBytes, &maps.q2, &bar.q_full, kMainCols, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&bar.empty[s], (j / kStages - 1) & 1);
        mbar_expect_tx(&bar.k_full[s], kTB);
        tma_load(sK(s), &maps.k, &bar.k_full[s], 0, h, j * kBK, b);
        if constexpr (kTail<D>) tma_load(sK(s) + kMainBytes, &maps.k2, &bar.k_full[s], kMainCols, h, j * kBK, b);
        mbar_expect_tx(&bar.v_full[s], kTB);
        tma_load(sV(s), &maps.v, &bar.v_full[s], 0, h, j * kBK, b);
        if constexpr (kTail<D>) tma_load(sV(s) + kMainBytes, &maps.v2, &bar.v_full[s], kMainCols, h, j * kBK, b);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wgi - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int tig = lane & 3;  // accumulator column pair; rows lane / 4 and lane / 4 + 8 of the warp's 16
  uint8_t* myQ = sQ + cw * 64 * 128;                     // this warpgroup's rows of the 128-byte part
  uint8_t* myQ2 = sQ + kMainBytes + cw * 64 * 32;        // ... and of the 32-byte part (D = 72)

  float o[32];   // output columns 0..63
  float o2[8];   // columns 64..79 (D = 72; 72..79 are v's zero columns)
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) o2[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores, rows g and g + 8
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums
  unsigned pa[kBK / 16][4];         // p of the previous tile, bf16 A fragments

  // tile j's scores sc -> p (into pa), the running max and sum, and o rescaled
  auto softmax = [&](int j, float (&sc)[64]) {
    // mask the keys past N (the last tile only), running max of the raw scores
    if ((j + 1) * kBK > N) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int key = j * kBK + (i / 4) * 8 + tig * 2 + (i & 1);
        if (key >= N) sc[i] = kNegInf;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    float corr[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m[r] - mx[r]) * c);
      m[r] = mx[r];
      mc[r] = mx[r] * c;
    }
    // p = exp2(s c - m c): f32 into the row sums, bf16 into p v's A fragments
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p0 = ex2(fmaf(sc[4 * i], c, -mc[0])), p1 = ex2(fmaf(sc[4 * i + 1], c, -mc[0]));
      const float p2 = ex2(fmaf(sc[4 * i + 2], c, -mc[1])), p3 = ex2(fmaf(sc[4 * i + 3], c, -mc[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[i / 2][(i & 1) * 2] = pack_bf16(p0, p1);
      pa[i / 2][(i & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[4 * i] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
    if constexpr (kTail<D>) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o2[4 * i] *= corr[0];
        o2[4 * i + 1] *= corr[0];
        o2[4 * i + 2] *= corr[1];
        o2[4 * i + 3] *= corr[1];
      }
    }
  };
  // S = Q K^T of the tile in stage s: four k16 steps on the 128-byte parts,
  // and (D = 72) one on the 32-byte parts, whose columns 72..79 are zeros
  auto qk = [&](float (&sc)[64], int s) {
#pragma unroll
    for (int kk = 0; kk < kMainCols / 16; ++kk)
      wgmma_m64n128k16_ss(sc, sw128_desc(myQ) + 2 * kk, sw128_desc(sK(s)) + 2 * kk, kk > 0);
    if constexpr (kTail<D>) wgmma_m64n128k16_ss(sc, sw32_desc(myQ2), sw32_desc(sK(s) + kMainBytes), 1);
  };
  // O += P V of the tile in stage s: n64 on the 128-byte part and (D = 72)
  // n16 on the 32-byte part, each of the tile's 8 k16 steps
  auto pv = [&](int s) {
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) wgmma_m64n64k16_rs(o, pa[t], sw128_desc(sV(s) + t * 16 * 128));
    if constexpr (kTail<D>) {
#pragma unroll
      for (int t = 0; t < kBK / 16; ++t) wgmma_m64n16k16_rs(o2, pa[t], sw32_desc(sV(s) + kMainBytes + t * 16 * 32));
    }
  };

  if (cw == 1) named_arrive(kBarTurn, 256);  // consumer 0 goes first
  mbar_wait(&bar.q_full, 0);

  // tile 0: q k^T only.  Then tile j's q k^T is issued with tile j - 1's
  // p v, in turns with the other warpgroup, and the softmax of tile j runs
  // while the other warpgroup's products do.  Every wgmma is issued on a
  // path all four warps of the warpgroup take.
  {
    float sc[64];
    mbar_wait(&bar.k_full[0], 0);
    named_sync(kBarTurn + cw, 256);
    wgmma_fence();
    qk(sc, 0);
    wgmma_commit();
    if (!(cw == 1 && n_tiles == 1)) named_arrive(kBarTurn + 1 - cw, 256);
    wgmma_wait_all();
    fence_regs(sc);
    softmax(0, sc);
  }
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(&bar.k_full[s], (j / kStages) & 1);
    mbar_wait(&bar.v_full[sp], ((j - 1) / kStages) & 1);

    float sc[64];
    named_sync(kBarTurn + cw, 256);
    wgmma_fence();
    qk(sc, s);
    pv(sp);
    wgmma_commit();
    if (!(cw == 1 && j == n_tiles - 1)) named_arrive(kBarTurn + 1 - cw, 256);
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(o);
    if constexpr (kTail<D>) fence_regs(o2);
    if (lane == 0) mbar_arrive(&bar.empty[sp]);  // k and v of tile j - 1 are read
    softmax(j, sc);
  }

  // the last tile's p v
  {
    const int sp = (n_tiles - 1) % kStages;
    mbar_wait(&bar.v_full[sp], ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    pv(sp);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if constexpr (kTail<D>) fence_regs(o2);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // out tile into this warpgroup's rows of the q tile, in the swizzles the
  // output maps expect: 16-byte chunk i of row r at i ^ (r % 8) in the
  // 128-byte part, at i ^ (r / 4 % 2) in the 32-byte part
  const int row = warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int chunk = (i ^ (row & 7)) * 16 + tig * 4;
    *reinterpret_cast<unsigned*>(myQ + row * 128 + chunk) = pack_bf16(o[4 * i] / l[0], o[4 * i + 1] / l[0]);
    *reinterpret_cast<unsigned*>(myQ + (row + 8) * 128 + chunk) = pack_bf16(o[4 * i + 2] / l[1], o[4 * i + 3] / l[1]);
  }
  if constexpr (kTail<D>) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int chunk = (i ^ ((row >> 2) & 1)) * 16 + tig * 4;  // rows row and row + 8 share row / 4 % 2
      *reinterpret_cast<unsigned*>(myQ2 + row * 32 + chunk) = pack_bf16(o2[4 * i] / l[0], o2[4 * i + 1] / l[0]);
      *reinterpret_cast<unsigned*>(myQ2 + (row + 8) * 32 + chunk) =
          pack_bf16(o2[4 * i + 2] / l[1], o2[4 * i + 3] / l[1]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(kBarStore + cw, 128);
  if (threadIdx.x % 128 == 0 && q0 + 64 * cw < N) {
    tma_store(&maps.o, myQ, 0, h, q0 + 64 * cw, b);
    if constexpr (kTail<D>) tma_store(&maps.o2, myQ2, kMainCols, h, q0 + 64 * cw, b);
    tma_store_wait();
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// 4-D map (D, H, N, B) of a bf16 tensor with unit dim stride, head stride
// D and the given token and batch strides (elements), box (cols, 1, rows,
// 1) in the 128-byte (cols 64) or 32-byte (cols 16) swizzle, zero fill
// past the edges.  The last kMapCache maps are kept by everything that
// goes into them: a sampler hands the kernel the same buffers step after
// step (at D = 72 eight maps a launch, a few buffers a step), and encoding
// costs host time on a path whose host already sets its pace.
constexpr int kMapCache = 64;

struct MapKey {
  const void* ptr;
  long long sb, sn;
  int B, N, H, D, rows, cols;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && sb == o.sb && sn == o.sn && B == o.B && N == o.N && H == o.H && D == o.D &&
           rows == o.rows && cols == o.cols;
  }
};

bool encode_map(CUtensorMap* map, const void* ptr, int B, int N, int H, int D, long long sb, long long sn, int rows,
                int cols) {
  // a stride of a dimension of size 1 is never followed; keep it valid
  if (N == 1) sn = (long long)H * D;
  if (B == 1) sb = sn * N;
  const MapKey key{ptr, sb, sn, B, N, H, D, rows, cols};
  static std::mutex mu;
  static MapKey keys[kMapCache];
  static CUtensorMap maps[kMapCache];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return true;
    }
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)sn * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == kMainCols ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, estride,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMapCache;
  used = used < kMapCache ? used + 1 : kMapCache;
  return true;
}

// q, k, v and o's maps for one part (box of cols columns)
bool encode_part(const Params& p, int cols, CUtensorMap& mq, CUtensorMap& mk, CUtensorMap& mv, CUtensorMap& mo) {
  const long long o_sn = (long long)p.H * p.D;
  return encode_map(&mq, p.q, p.B, p.N, p.H, p.D, p.q_sb, p.q_sn, kBQ, cols) &&
         encode_map(&mk, p.k, p.B, p.N, p.H, p.D, p.k_sb, p.k_sn, kBK, cols) &&
         encode_map(&mv, p.v, p.B, p.N, p.H, p.D, p.v_sb, p.v_sn, kBK, cols) &&
         encode_map(&mo, p.o, p.B, p.N, p.H, p.D, o_sn * p.N, o_sn, 64, cols);
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<D>);
  if (attr != cudaSuccess) return attr;
  Maps<D> maps;
  if (!encode_part(p, kMainCols, maps.q, maps.k, maps.v, maps.o)) return cudaErrorInvalidValue;
  if constexpr (kTail<D>) {
    if (!encode_part(p, kTailCols, maps.q2, maps.k2, maps.v2, maps.o2)) return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((p.N + kBQ - 1) / kBQ), (unsigned)p.H, (unsigned)p.B);
  flash_fwd_wgmma<D><<<grid, kThreads, kSmem<D>, stream>>>(maps, p.N, p.scale * 1.4426950408889634f);
  return cudaSuccess;
}

}  // namespace wg

// ------------------------------------------------------------------ f32: 3xTF32 on the tensor cores

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                  // 16-row m-tiles per warp
constexpr int kBQ = 16 * kMT * kWarps;  // query rows per CTA
constexpr int kBK = 32;                 // keys per k/v tile
// row stride (floats) of the q and k tiles: 72 = 8 (mod 32), so the 8-byte
// fragment loads of a half-warp (rows g, d pairs 2t) cover 32 banks
constexpr int kLDQK = 72;
// row stride of the v tile: D + 4 = 4 or 12 (mod 16), so the 4-byte loads
// of a warp (keys 2t, columns g) cover 32 banks
template <int D>
constexpr int kLDV = D + 4;
template <int D>
constexpr int kSmem = 4 * (kBQ * kLDQK + 2 * kBK * kLDQK + 2 * kBK * kLDV<D>);
constexpr int kMaxDevices = 16;

// rows [row0, row0 + R) of one head, D floats each, into a shared tile of
// row stride LD, 16 bytes a cp.async; rows past N are zero-filled
template <int D, int R, int LD>
__device__ __forceinline__ void load_rows(float* tile, const float* base, long long sn, int row0, int N) {
  constexpr int kChunks = D / 4;
#pragma unroll 4
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    const bool valid = row0 + r < N;
    cp_async16(tile + r * LD + col, valid ? base + (long long)(row0 + r) * sn + col : base, valid);
  }
}

// c += a b at float32 accuracy from TF32 halves, the small products first:
// a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p, float c) {  // c = scale * log2(e)
  constexpr int LDV = kLDV<D>;
  constexpr int KS = D / 8;    // k-steps of q k^T; 8-column tiles of the output
  constexpr int NS = kBK / 8;  // 8-key tiles of the scores; k-steps of p v
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;                // kBQ x kLDQK
  float* sK = sQ + kBQ * kLDQK;        // 2 stages of kBK x kLDQK
  float* sV = sK + 2 * kBK * kLDQK;    // 2 stages of kBK x LDV

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and k-slot / column pair
  const int N = p.N;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + (long long)h * D;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + (long long)h * D;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + (long long)h * D;

  load_rows<D, kBQ, kLDQK>(sQ, Q, p.q_sn, q0, N);
  load_rows<D, kBK, kLDQK>(sK, K, p.k_sn, 0, N);
  load_rows<D, kBK, LDV>(sV, V, p.v_sn, 0, N);
  cp_async_commit();

  float o[kMT][KS][4];
  float m[kMT][2], l[kMT][2];  // rows g and g + 8 of each m-tile: running max of the raw scores, this thread's sums
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < KS; ++nt) o[mt][nt][0] = o[mt][nt][1] = o[mt][nt][2] = o[mt][nt][3] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }
  // this thread's q fragment: row g of the warp's first m-tile, d pair 2t
  const float* qf = sQ + (warp * 16 * kMT + g) * kLDQK + 2 * t;

  const int n_tiles = (N + kBK - 1) / kBK;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j is in for every thread, and every thread is done with tile j - 1
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      load_rows<D, kBK, kLDQK>(sK + st * kBK * kLDQK, K, p.k_sn, (j + 1) * kBK, N);
      load_rows<D, kBK, LDV>(sV + st * kBK * LDV, V, p.v_sn, (j + 1) * kBK, N);
      cp_async_commit();
    }
    const float* kf = sK + (j & 1) * kBK * kLDQK + g * kLDQK + 2 * t;  // key g, d pair 2t
    const float* vf = sV + (j & 1) * kBK * LDV + 2 * t * LDV + g;      // key 2t, column g

    // s = q k^T: k-slots t and t + 4 of each 8-wide step hold d = 2t and
    // 2t + 1 (a permutation of the sum), so one 8-byte load gives both
    float s[kMT][NS][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float2 r0 = *reinterpret_cast<const float2*>(qf + mt * 16 * kLDQK + ks * 8);
        const float2 r1 = *reinterpret_cast<const float2*>(qf + (mt * 16 + 8) * kLDQK + ks * 8);
        split_tf32(r0.x, ah[mt][0], al[mt][0]);
        split_tf32(r1.x, ah[mt][1], al[mt][1]);
        split_tf32(r0.y, ah[mt][2], al[mt][2]);
        split_tf32(r1.y, ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float2 kv = *reinterpret_cast<const float2*>(kf + nt * 8 * kLDQK + ks * 8);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kv.x, bh0, bl0);
        split_tf32(kv.y, bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3(s[mt][nt], ah[mt], al[mt], bh0, bh1, bl0, bl1);
      }
    }

    // mask the keys past N (the last tile only); running max of the raw
    // scores; p = exp2(s c - m c) in float32 into the row sums, in place
    const bool edge = (j + 1) * kBK > N;
    float corr[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (edge) {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * kBK + nt * 8 + 2 * t + (e & 1) >= N) s[mt][nt][e] = kNegInf;
      }
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][nt][0], s[mt][nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][nt][2], s[mt][nt][3]));
      }
      float mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[mt][r] = wg::ex2((m[mt][r] - mx[r]) * c);
        m[mt][r] = mx[r];
        mc[r] = mx[r] * c;
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][nt][e] = wg::ex2(fmaf(s[mt][nt][e], c, -mc[e >> 1]));
          rs[e >> 1] += s[mt][nt][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * corr[mt][r] + rs[r];
    }

    // o = o corr + p v.  k-slot t of 8-key step kk is key 8kk + 2t and slot
    // t + 4 key 8kk + 2t + 1, so p's A fragment is the score tile's own
    // registers (c0, c2, c1, c3), and v's B fragment rows are read in that
    // order.  Each 8-column tile of the output sums the tile's keys into a
    // fresh accumulator, added to o by one FFMA: the tensor cores' adds
    // truncate to the accumulator's exponent, and o's magnitude, summed
    // over every key so far, would make that a bias growing with N
    uint32_t ph[kMT][NS][4], pl[kMT][NS][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        split_tf32(s[mt][kk][0], ph[mt][kk][0], pl[mt][kk][0]);
        split_tf32(s[mt][kk][2], ph[mt][kk][1], pl[mt][kk][1]);
        split_tf32(s[mt][kk][1], ph[mt][kk][2], pl[mt][kk][2]);
        split_tf32(s[mt][kk][3], ph[mt][kk][3], pl[mt][kk][3]);
      }
#pragma unroll
    for (int nt = 0; nt < KS; ++nt) {
      float pv[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) pv[mt][0] = pv[mt][1] = pv[mt][2] = pv[mt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const float* vp = vf + kk * 8 * LDV + nt * 8;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vp[0], bh0, bl0);    // key 8kk + 2t, column 8nt + g
        split_tf32(vp[LDV], bh1, bl1);  // key 8kk + 2t + 1
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3(pv[mt], ph[mt][kk], pl[mt][kk], bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        o[mt][nt][0] = fmaf(o[mt][nt][0], corr[mt][0], pv[mt][0]);
        o[mt][nt][1] = fmaf(o[mt][nt][1], corr[mt][0], pv[mt][1]);
        o[mt][nt][2] = fmaf(o[mt][nt][2], corr[mt][1], pv[mt][2]);
        o[mt][nt][3] = fmaf(o[mt][nt][3], corr[mt][1], pv[mt][3]);
      }
    }
  }

  float* O = static_cast<float*>(p.o) + (long long)b * N * p.H * D + (long long)h * D;
  const long long o_sn = (long long)p.H * D;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
    }
    const int row = q0 + warp * 16 * kMT + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < KS; ++nt) {
      const int d = nt * 8 + 2 * t;
      if (row < N)
        *reinterpret_cast<float2*>(O + row * o_sn + d) = make_float2(o[mt][nt][0] / l[mt][0], o[mt][nt][1] / l[mt][0]);
      if (row + 8 < N)
        *reinterpret_cast<float2*>(O + (row + 8) * o_sn + d) =
            make_float2(o[mt][nt][2] / l[mt][1], o[mt][nt][3] / l[mt][1]);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // the shared-memory attributes, once per device (launches hold the
  // package's launch lock)
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev]) {
    if ((err = cudaFuncSetAttribute(flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<D>)) !=
        cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(flash_fwd_f32<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
      return err;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  const dim3 grid((unsigned)((p.N + kBQ - 1) / kBQ), (unsigned)p.H, (unsigned)p.B);
  flash_fwd_f32<D><<<grid, kThreads, kSmem<D>, stream>>>(p, p.scale * 1.4426950408889634f);
  return cudaSuccess;
}

}  // namespace tc

template <int D>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  return dtype == IRSDE_BF16 ? wg::launch<D>(p, stream) : tc::launch<D>(p, stream);
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
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;  // the bf16 kernel takes the max of the raw scores
  const Params p{q, k, v, o, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, B, N, H, D, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = D == 64 ? launch<64>(p, dtype, s) : launch<72>(p, dtype, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
