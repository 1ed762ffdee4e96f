// Device helpers shared by the training kernels (mega.cu, mlp_bwd.cu,
// sampling.cu, loss.cu, conv.cu), and the host side's once-per-process
// launch bookkeeping.
//
// The building block of mega.cu's forward is one dense layer over a tile of
// TM rows whose activations sit in shared memory: y[r, j] = act[r, :] .
// W[:, j] (+ b[j]), handed to an epilogue functor as epi(r, j, y). Weights
// stream from global memory (L2-resident at these sizes) in coalesced rows
// of W[k, :], each weight feeding the R rows a thread group owns. This is
// mlp_fwd.cu's inner loop, with the store replaced by the epilogue. The
// backward kernels run on dense_tile.cuh's block-tiled product instead.
//
// Precision: with BF16, every operand is rounded to bf16 and the product
// accumulates in fp32; activations are rounded when stored to shared
// memory, weights as they are loaded (the reference's bf16 policy).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace vae {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may opt into

template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float softplus(float a) {
  return fmaxf(a, 0.f) + log1pf(expf(-fabsf(a)));
}

__device__ __forceinline__ float sigmoid(float a) {
  return 1.f / (1.f + expf(-a));
}

// acc[r] = sum_k a0[r * stride + k] * W[k * ldw] for the column W points at.
// a0 + r * stride must be 16-byte aligned (stride a multiple of 4).
template <int R, bool BF16>
__device__ __forceinline__ void dot_col(const float* __restrict__ a0,
                                        int stride,
                                        const float* __restrict__ wj, int ldw,
                                        int n_in, float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  const int k4 = n_in & ~3;
  for (int k = 0; k < k4; k += 4) {
    const float w0 = operand<BF16>(__ldg(wj + (size_t)(k + 0) * ldw));
    const float w1 = operand<BF16>(__ldg(wj + (size_t)(k + 1) * ldw));
    const float w2 = operand<BF16>(__ldg(wj + (size_t)(k + 2) * ldw));
    const float w3 = operand<BF16>(__ldg(wj + (size_t)(k + 3) * ldw));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(a0 + r * stride + k);
      acc[r] = fmaf(a.x, w0, acc[r]);
      acc[r] = fmaf(a.y, w1, acc[r]);
      acc[r] = fmaf(a.z, w2, acc[r]);
      acc[r] = fmaf(a.w, w3, acc[r]);
    }
  }
  for (int k = k4; k < n_in; ++k) {
    const float w = operand<BF16>(__ldg(wj + (size_t)k * ldw));
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(a0[r * stride + k], w, acc[r]);
  }
}

// `colthreads` threads walk the columns, `groups` groups split the rows,
// R rows each.
template <int R, bool BF16, class Epi>
__device__ void layer_rows(const float* act, int stride, const float* W,
                           int ldw, const float* bias, int n_in, int n_out,
                           int colthreads, int groups, Epi& epi) {
  const int g = threadIdx.x / colthreads;
  if (g >= groups) return;
  const int r0 = g * R;
  for (int j = threadIdx.x % colthreads; j < n_out; j += colthreads) {
    float acc[R];
    dot_col<R, BF16>(act + r0 * stride, stride, W + j, ldw, n_in, acc);
    const float bj = bias != nullptr ? __ldg(bias + j) : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) epi(r0 + r, j, acc[r] + bj);
  }
}

// One layer over the block's TM rows: act [TM, stride] in shared memory
// times W [n_in, n_out] (row stride ldw) plus bias (or none). Narrow layers
// (the n_z-wide heads) split the rows between thread groups instead of
// leaving most threads idle.
template <int TM, bool BF16, class Epi>
__device__ void layer(const float* act, int stride, const float* W, int ldw,
                      const float* bias, int n_in, int n_out, Epi& epi) {
  int colthreads = kThreads;
  while (colthreads > 32 && colthreads / 2 >= n_out) colthreads /= 2;
  int groups = kThreads / colthreads;
  if (groups > TM) groups = TM;
  // groups is a power of two <= min(8, TM), so it divides TM.
  switch (groups) {
    case 1:
      layer_rows<TM, BF16>(act, stride, W, ldw, bias, n_in, n_out, colthreads,
                           1, epi);
      break;
    case 2:
      if constexpr (TM >= 2)
        layer_rows<TM / 2, BF16>(act, stride, W, ldw, bias, n_in, n_out,
                                 colthreads, 2, epi);
      break;
    case 4:
      if constexpr (TM >= 4)
        layer_rows<TM / 4, BF16>(act, stride, W, ldw, bias, n_in, n_out,
                                 colthreads, 4, epi);
      break;
    default:
      if constexpr (TM >= 8)
        layer_rows<TM / 8, BF16>(act, stride, W, ldw, bias, n_in, n_out,
                                 colthreads, 8, epi);
      break;
  }
}

// Load rows [row0, row0 + TM) of src [batch, n] (row stride ld) into
// dst [TM, stride], rounded as matmul operands; rows past `valid` are zero.
template <int TM, bool BF16>
__device__ void load_tile(float* dst, int stride, const float* __restrict__ src,
                          int ld, int n, int row0, int valid) {
  for (int i = threadIdx.x; i < TM * n; i += kThreads) {
    const int r = i / n;
    const int k = i - r * n;
    dst[r * stride + k] =
        r < valid ? operand<BF16>(src[(size_t)(row0 + r) * ld + k]) : 0.f;
  }
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

// Sum of v[0..n) by one warp (warp_sum_of over the array).
__device__ __forceinline__ float warp_sum(const float* v, int n) {
  return warp_sum_of(n, [&](int j) { return v[j]; });
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

template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
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

// Switch over the tile heights a kernel is built for; `CALL(TM)` launches.
#define VAE_TM_SWITCH(tile_rows, CALL)     \
  switch (tile_rows) {                     \
    case 1: return CALL(1);                \
    case 2: return CALL(2);                \
    case 4: return CALL(4);                \
    case 8: return CALL(8);                \
    case 16: return CALL(16);              \
    case 32: return CALL(32);              \
    default: return cudaErrorInvalidValue; \
  }
