// Pieces shared by the two linear-attention kernels (linear_attention.cu,
// K2; linear_attention_bh.cu, K5): the 16-byte cp.async ring, 8-element
// shared loads and global stores, and the resident-CTA capacity of a
// cooperative kernel.  The TF32 hi/lo split and the mma.sync m16n8k8 TF32
// product are common.cuh's (K4's float32 path takes them too).
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxDevices = 16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 fills zeros (rows past the end)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lds(const float* p) { return *p; }
__device__ __forceinline__ float lds(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// 8 contiguous elements from shared memory, 16-byte aligned
__device__ __forceinline__ void lds8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 8 contiguous outputs to global memory, 16-byte stores
__device__ __forceinline__ void stg8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void stg8(__nv_bfloat16* p, const float* x) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

// CTAs per SM that can be resident (at most per_sm_max) times the SMs, for
// `threads`-thread CTAs with `smem` bytes of dynamic shared memory; the
// kernel's shared-memory attributes are set on the first call per device,
// and the answer is kept in `cache` (one per kernel instantiation).
template <typename Kernel>
cudaError_t capacity(Kernel kernel, int threads, int smem, int per_sm_max, int* cache, int* cap) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *cap = cache[dev];
    return cudaSuccess;
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *cap = (per_sm < per_sm_max ? per_sm : per_sm_max) * sms;
  if (dev < kMaxDevices) cache[dev] = *cap;
  return cudaSuccess;
}

}  // namespace
