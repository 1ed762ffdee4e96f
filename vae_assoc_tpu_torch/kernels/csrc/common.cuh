// Device helpers shared by the kernels (mlp_fwd.cu, mlp_bwd.cu, mega.cu,
// sampling.cu, loss.cu, conv.cu, conv_mega.cu and dense_tile.cuh): the
// activations, a fixed-order warp sum, the Philox draw, the tensor-core and
// cp.async building blocks, and the host side's once-per-process launch
// bookkeeping.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace vae {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may opt into

__device__ __forceinline__ float softplus(float a) {
  return fmaxf(a, 0.f) + log1pf(expf(-fabsf(a)));
}

__device__ __forceinline__ float sigmoid(float a) {
  return 1.f / (1.f + expf(-a));
}

// Sum of f(0) .. f(n - 1) by one warp in a fixed order: each lane adds its
// strided share in sequence, then a shuffle tree. The same inputs give the
// same bits. Every lane of the warp must call it.
template <class F>
__device__ __forceinline__ float warp_sum_of(int n, F f) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int j = lane; j < n; j += 32) s += f(j);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Philox4x32-10 (Salmon et al., SC'11) keyed by the 64-bit seed, counter
// (row, col, 0, 0), and the reference's Box-Muller on two words of its
// output: 24 high bits each, u1 kept off zero by 1e-7
// (vae_assoc_tpu/kernels/sampling.py::_normal_bits). The draw depends on the
// element's position only, not on the tile that computes it; the plain twin
// (ops/sampling.py::philox_normal) computes the same integers in torch.
__device__ __forceinline__ float philox_normal(uint64_t seed, uint32_t row,
                                               uint32_t col) {
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  uint32_t c0 = row, c1 = col, c2 = 0u, c3 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  const float u1 = (float)(c0 >> 8) * (1.f / 16777216.f) + 1e-7f;
  const float u2 = (float)(c1 >> 8) * (1.f / 16777216.f);
  return sqrtf(-2.f * logf(u1)) * cosf(6.283185307179586f * u2);
}

// Host bookkeeping of a kernel, done once per (device, kernel) and process
// instead of on every launch: its dynamic shared-memory cap raised to
// kSmemLimit less its static shared memory (a cap: each launch still asks
// for its own size), and the blocks of kThreads threads an SM holds at
// `smem` bytes, cached per size.
inline cudaError_t launch_info(const void* fn, int smem, int* per_sm) {
  struct Entry {
    int dev;
    const void* fn;
    int smem;
    int per_sm;
  };
  static std::mutex mu;
  static Entry seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  bool capped = false;
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].dev != dev || seen[i].fn != fn) continue;
    capped = true;
    if (seen[i].smem == smem) {
      *per_sm = seen[i].per_sm;
      return cudaSuccess;
    }
  }
  if (!capped) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, fn);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit - (int)attr.sharedSizeBytes);
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (n_seen < 64) seen[n_seen++] = Entry{dev, fn, smem, *per_sm};
  return cudaSuccess;
}

// Tensor-core building blocks (mma.sync, sm_80 and later): bf16 operands,
// fp32 accumulators. Fragment layouts are PTX's for m16n8k16 (row.col):
// lane l holds A rows l/4 and l/4 + 8, B column l/4, C rows l/4 and
// l/4 + 8 at columns 2 (l%4) and 2 (l%4) + 1.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the 16-byte rows of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, each matrix transposed on the way (operands stored MN-major).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a (16x16) . b (16x8).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Asynchronous copies to shared memory (cp.async, sm_80 and later), grouped
// per pipeline stage: 16 bytes (src 16-byte aligned) or 4, zero-filled when
// !valid (src must still be a valid address: nothing is read from it).
// The 16-byte copy streams through L2 only: each value is read once.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// The same through L1, for values that neighbouring copies read again.
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies 4 consecutive values of row b of src [.., ld] from column c into
// dst, zeros at columns >= lim or when !in: one 16-byte cp.async when
// `vec` (ld, lim and src 16-byte aligned), else four of 4 bytes.
__device__ __forceinline__ void copy4(float* dst, const float* src, int ld,
                                      int b, int c, int lim, bool vec,
                                      bool in) {
  const float* p = src + (size_t)b * ld + c;
  if (vec) {
    const bool ok = in && c < lim;
    vae::cp_async16(dst, ok ? p : src, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = in && c + e < lim;
      vae::cp_async4(dst + e, ok ? p + e : src, ok);
    }
  }
}

// Four floats rounded to bf16 (to nearest even, as torch's .bfloat16()),
// packed in order into 8 bytes.
__device__ __forceinline__ uint2 pack_bf16x4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

}  // namespace vae
