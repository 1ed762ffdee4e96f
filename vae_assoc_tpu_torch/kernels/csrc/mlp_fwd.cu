// Fused MLP stack forward for the VAE's encoder and decoder towers, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels vae_assoc_tpu/kernels/mlp.py::_enc_fwd_kernel
// (x -> L x softplus(h.W+b) -> mu, logvar heads) and ::_dec_fwd_kernel
// (z -> L x softplus -> linear output). One kernel serves both: a stack is a
// table of layers, the first n_hidden apply bias + softplus and stay on chip,
// the last n_heads are linear and write to device memory (two heads for the
// encoder, one for the decoder).
//
// What bounds it on this card. At config 3 the image encoder holds 0.66 M
// weights (2.6 MB fp32) and does 0.66 M FMAs per row, so arithmetic
// intensity is TM FMAs per weight read, TM being the rows a block owns. The
// weights fit the 50 MB L2, so weight reads are L2 traffic; activations are
// the other stream a naive chain of matmuls sends through device memory
// (the [B, 500] hidden layers, written and read once per layer).
//
// What the design does about it.
// - Each block owns TM rows and keeps their activations in shared memory,
//   ping-ponging between two [TM, stride] buffers across layers, so hidden
//   activations never touch device memory; only x is read and mu/logvar or
//   the output written.
// - Weights stream from global memory (L2-resident) once per block, in
//   coalesced rows of W[k, :]; each weight feeds TM FMAs.
// - TM (1..32, a power of two) is picked by the wrapper from the widest
//   on-chip layer, so 2 * TM * stride * 4 B fits the 227 KB of dynamic
//   shared memory, and from the batch, so that small batches still spread
//   over the SMs. TM = 1 fits any width up to 29,056.
// - Narrow layers (the n_z = 20 heads) split the block's rows between
//   thread groups instead of leaving most threads idle.
// - Depth and widths come from a device-side layer table, so there is no
//   depth limit. The last row tile is ragged: rows past the batch read
//   zeros and are never stored.
// - fp32 uses true fp32 FMAs. bf16 rounds each operand to bf16 and
//   accumulates in fp32 (activations are rounded once, when stored to
//   shared memory; weights when loaded), as the reference's bf16 policy.
// Tensor cores (wgmma), TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// One row of the layer table; written by vae_assoc_tpu_torch/kernels/mlp.py
// as four int64 values.
struct Layer {
  long long w;      // const float*, [n_in, n_out] row-major
  long long b;      // const float*, [n_out]
  long long n_in;
  long long n_out;
};

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

// One layer for R rows per thread group: y[r, j] = act[r, :] . W[:, j] + b[j].
// `colthreads` threads walk the columns, `groups` groups split the rows.
// Hidden layers (smem_out != nullptr) store softplus(y) to shared memory;
// heads store y to `gout` (row stride n_out) for the first `valid` rows.
template <int R, bool BF16>
__device__ void layer_rows(const float* __restrict__ act, int stride,
                           const float* __restrict__ W,
                           const float* __restrict__ bias, int n_in, int n_out,
                           int colthreads, int groups,
                           float* __restrict__ smem_out,
                           float* __restrict__ gout, int valid) {
  const int g = threadIdx.x / colthreads;
  if (g >= groups) return;
  const int r0 = g * R;
  const float* a0 = act + r0 * stride;
  const int k4 = n_in & ~3;
  for (int j = threadIdx.x % colthreads; j < n_out; j += colthreads) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    const float* wj = W + j;
    for (int k = 0; k < k4; k += 4) {
      const float w0 = operand<BF16>(__ldg(wj + (size_t)(k + 0) * n_out));
      const float w1 = operand<BF16>(__ldg(wj + (size_t)(k + 1) * n_out));
      const float w2 = operand<BF16>(__ldg(wj + (size_t)(k + 2) * n_out));
      const float w3 = operand<BF16>(__ldg(wj + (size_t)(k + 3) * n_out));
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
      const float w = operand<BF16>(__ldg(wj + (size_t)k * n_out));
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(a0[r * stride + k], w, acc[r]);
    }
    const float bj = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float y = acc[r] + bj;
      if (smem_out != nullptr) {
        smem_out[(r0 + r) * stride + j] = operand<BF16>(softplus(y));
      } else if (r0 + r < valid) {
        gout[(size_t)(r0 + r) * n_out + j] = y;
      }
    }
  }
}

template <int TM, bool BF16>
__device__ void run_layer(const float* act, int stride, const Layer& L,
                          float* smem_out, float* gout, int valid) {
  const int n_in = (int)L.n_in;
  const int n_out = (int)L.n_out;
  int colthreads = kThreads;
  while (colthreads > 32 && colthreads / 2 >= n_out) colthreads /= 2;
  int groups = kThreads / colthreads;
  if (groups > TM) groups = TM;
  const float* W = reinterpret_cast<const float*>(L.w);
  const float* b = reinterpret_cast<const float*>(L.b);
  // groups is a power of two <= min(8, TM), so it divides TM.
  switch (groups) {
    case 1:
      layer_rows<TM, BF16>(act, stride, W, b, n_in, n_out, colthreads, 1,
                           smem_out, gout, valid);
      break;
    case 2:
      if constexpr (TM >= 2)
        layer_rows<TM / 2, BF16>(act, stride, W, b, n_in, n_out, colthreads, 2,
                                 smem_out, gout, valid);
      break;
    case 4:
      if constexpr (TM >= 4)
        layer_rows<TM / 4, BF16>(act, stride, W, b, n_in, n_out, colthreads, 4,
                                 smem_out, gout, valid);
      break;
    default:
      if constexpr (TM >= 8)
        layer_rows<TM / 8, BF16>(act, stride, W, b, n_in, n_out, colthreads, 8,
                                 smem_out, gout, valid);
      break;
  }
}

template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads)
    mlp_stack_fwd(const float* __restrict__ x, int batch, int n_in,
                  const Layer* __restrict__ layers, int n_hidden, int n_heads,
                  float* out0, float* out1, int stride) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                // this layer's input
  float* next = smem + TM * stride;  // its output, for hidden layers
  const int row0 = blockIdx.x * TM;
  const int valid = min(TM, batch - row0);

  for (int i = threadIdx.x; i < TM * n_in; i += kThreads) {
    const int r = i / n_in;
    const int k = i - r * n_in;
    act[r * stride + k] =
        r < valid ? operand<BF16>(x[(size_t)(row0 + r) * n_in + k]) : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < n_hidden; ++l) {
    const Layer L = layers[l];
    run_layer<TM, BF16>(act, stride, L, next, nullptr, valid);
    __syncthreads();
    float* t = act;
    act = next;
    next = t;
  }
  for (int h = 0; h < n_heads; ++h) {
    const Layer L = layers[n_hidden + h];
    float* out = (h == 0 ? out0 : out1) + (size_t)row0 * L.n_out;
    run_layer<TM, BF16>(act, stride, L, nullptr, out, valid);
  }
}

template <int TM, bool BF16>
cudaError_t launch(const float* x, int batch, int n_in, const Layer* layers,
                   int n_hidden, int n_heads, float* out0, float* out1,
                   int stride, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)TM * stride * sizeof(float);
  auto kernel = mlp_stack_fwd<TM, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + TM - 1) / TM;
  kernel<<<grid, kThreads, smem, stream>>>(x, batch, n_in, layers, n_hidden,
                                           n_heads, out0, out1, stride);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch(int tile_rows, const float* x, int batch, int n_in,
                     const Layer* layers, int n_hidden, int n_heads,
                     float* out0, float* out1, int stride,
                     cudaStream_t stream) {
#define VAE_TM_CASE(TM)                                                     \
  case TM:                                                                  \
    return launch<TM, BF16>(x, batch, n_in, layers, n_hidden, n_heads, out0, \
                            out1, stride, stream);
  switch (tile_rows) {
    VAE_TM_CASE(1)
    VAE_TM_CASE(2)
    VAE_TM_CASE(4)
    VAE_TM_CASE(8)
    VAE_TM_CASE(16)
    VAE_TM_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef VAE_TM_CASE
}

}  // namespace

// Run one MLP stack over `batch` rows of x [batch, n_in] (fp32, row-major).
// `layers` is a device pointer to n_hidden + n_heads Layer rows; out0 (and
// out1 when n_heads == 2) are fp32 [batch, n_out of that head]. `stride` is
// the shared-memory row length (a multiple of 4, at least every on-chip
// width); `tile_rows` is TM. Launches on `stream` without synchronising and
// returns cudaGetLastError().
extern "C" int vae_mlp_stack_fwd(const void* x, int batch, int n_in,
                                 const void* layers, int n_hidden,
                                 int n_heads, void* out0, void* out1,
                                 int stride, int tile_rows, int bf16,
                                 void* stream) {
  if (batch <= 0 || n_heads < 1 || n_heads > 2 || stride % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* xs = static_cast<const float*>(x);
  const auto* ls = static_cast<const Layer*>(layers);
  auto* o0 = static_cast<float*>(out0);
  auto* o1 = static_cast<float*>(out1);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? dispatch<true>(tile_rows, xs, batch, n_in, ls, n_hidden, n_heads,
                            o0, o1, stride, s)
           : dispatch<false>(tile_rows, xs, batch, n_in, ls, n_hidden, n_heads,
                             o0, o1, stride, s);
  return (int)err;
}

extern "C" const char* vae_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
