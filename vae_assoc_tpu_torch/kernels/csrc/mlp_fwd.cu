// Fused MLP stack forward for the VAE's encoder and decoder towers, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels vae_assoc_tpu/kernels/mlp.py::_enc_fwd_kernel
// (x -> L x softplus(h.W+b) -> mu, logvar heads) and ::_dec_fwd_kernel
// (z -> L x softplus -> linear output). One kernel serves both: a stack is a
// table of layers, the first n_hidden apply bias + softplus, the last
// n_heads are linear and write to device memory (two heads for the
// encoder, one for the decoder).
//
// What bounds it on this card. At config 3 the image encoder does 0.66 M
// multiply-adds a row against 3.1 KB of input, on 2.6 MB of fp32 weights
// that stay in L2: arithmetic, and the rows that share each weight byte a
// block reads are what a tile saves. In bf16 the tensor cores finish a
// slice long before the next arrives, so each block streaming its weight
// slices from L2 bounds it.
//
// What the design does about it: it runs on dense_tile.cuh's block-tiled
// product, as stack_bwd does (mlp_bwd.cu).
// - A block owns TM = 16, 32 or 64 rows (from the batch; kernels/mlp.py::
//   stack_fwd_plan) and runs its products in turn, each over the whole
//   width: the hidden layers through softplus_stack (epilogue: + b,
//   softplus, store h to a workspace), then each head (epilogue: + b,
//   store). Every weight byte a block reads serves all its rows: fp32 on
//   register tiles, bf16 on mma.sync with fp32 accumulation.
// - Each product's A streams back from device memory (x, or the rows of
//   the workspace this block wrote before the barrier that ends the last
//   product): two ping-pong buffers of row stride ldh that the wrapper
//   allocates per call. No row lives in shared memory, so no width bounds
//   the tile.
// - Where 16-row tiles leave SMs idle, `parts` blocks (a cluster) share
//   each tile, each taking every parts-th column tile of every product,
//   with a cluster barrier between products: more blocks stream a share of
//   the weights each.
// - Depth and widths come from a device-side layer table, so there is no
//   depth limit. The last row tile is ragged: rows past the batch read
//   zeros and are never stored.
// - bf16 rounds each operand to bf16 as it is staged (the reference's bf16
//   policy); the products add in fp32.

#include "common.cuh"
#include "dense_tile.cuh"

namespace {

using vae::kThreads;

// One row of the layer table; written by vae_assoc_tpu_torch/kernels/mlp.py
// as four int64 values.
struct Layer {
  long long w;      // const float*, [n_in, n_out] row-major
  long long b;      // const float*, [n_out]
  long long n_in;
  long long n_out;
};

// Shared memory of a launch (kernels/mlp.py::stack_fwd_plan): the ring of
// its one product mode, W as stored with A streamed.
__host__ __device__ constexpr int stack_fwd_smem(int tm, bool bf16) {
  return dense_ring_bytes(tm, false, true, bf16);
}

// `parts` blocks (a cluster, consecutive in x) own TM rows; see the top of
// this file. ws: two buffers [batch, ldh] (one for a single hidden layer).
// At 64 rows two blocks share an SM (at most 128 registers a thread).
template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads, TM == 64 ? 2 : 1)
    mlp_stack_fwd(const float* __restrict__ x, int batch, int n_in,
                  const Layer* __restrict__ layers, int n_hidden, int n_heads,
                  float* __restrict__ out0, float* __restrict__ out1, float* ws, int ldh,
                  int parts) {
  extern __shared__ __align__(16) float ring[];
  const int part = blockIdx.x % parts;
  const int row0 = blockIdx.x / parts * TM;
  const int valid = min(TM, batch - row0);
  const size_t plane = (size_t)batch * ldh;

  softplus_stack<TM, BF16>(
      x + (size_t)row0 * n_in, n_in, n_in, n_hidden,
      [&](int i) {
        const Layer L = layers[i];
        return StackLayer{reinterpret_cast<const float*>(L.w),
                          reinterpret_cast<const float*>(L.b),
                          ws + (i & 1) * plane + (size_t)row0 * ldh, (int)L.n_out, ldh};
      },
      valid, ring, part, parts);
  const float* a = x + (size_t)row0 * n_in;
  int lda = n_in, k = n_in;
  if (n_hidden > 0) {
    a = ws + ((n_hidden - 1) & 1) * plane + (size_t)row0 * ldh;
    lda = ldh;
    k = (int)layers[n_hidden - 1].n_out;
    if (parts > 1) cluster_sync();  // the other parts' rows of the last layer
  }
  for (int h = 0; h < n_heads; ++h) {
    const Layer L = layers[n_hidden + h];
    const int n = (int)L.n_out;
    const float* b = reinterpret_cast<const float*>(L.b);
    float* out = (h == 0 ? out0 : out1) + (size_t)row0 * n;
    auto epi = [&](int r, int j, float y) {
      if (r < valid) out[(size_t)r * n + j] = y + __ldg(b + j);
    };
    dense_rows<TM, BF16, false, true>(a, nullptr, lda, valid,
                                      reinterpret_cast<const float*>(L.w), k, n, ring, epi,
                                      part, parts);
  }
}

template <bool BF16>
const void* stack_fwd_kernel(int tm) {
  return tm == 16   ? (const void*)mlp_stack_fwd<16, BF16>
         : tm == 32 ? (const void*)mlp_stack_fwd<32, BF16>
                    : (const void*)mlp_stack_fwd<64, BF16>;
}

}  // namespace

// Run one MLP stack over `batch` rows of x [batch, n_in] (fp32, row-major).
// `layers` is a device pointer to n_hidden + n_heads Layer rows; out0 (and
// out1 when n_heads == 2) are fp32 [batch, n_out of that head]. ws is the
// hidden layers' workspace: two buffers [batch, ldh] (one when n_hidden is
// 1), ldh a multiple of 4 and at least every hidden width. `tile_rows`
// (16, 32 or 64), `smem` and `parts` (1, 2, 4 or 8 blocks, a cluster, per
// row tile) are kernels/mlp.py::stack_fwd_plan's. Launches on `stream`
// without synchronising and returns the launch's CUDA error.
extern "C" int vae_mlp_stack_fwd(const void* x, int batch, int n_in,
                                 const void* layers, int n_hidden,
                                 int n_heads, void* out0, void* out1, void* ws, int ldh,
                                 int tile_rows, int smem, int parts, int bf16,
                                 void* stream) {
  if (batch <= 0 || n_in <= 0 || n_hidden < 0 || n_heads < 1 || n_heads > 2 ||
      ldh % 4 != 0 || (n_hidden > 0 && (ws == nullptr || ldh <= 0)) ||
      (n_heads == 2) != (out1 != nullptr) ||
      (tile_rows != 16 && tile_rows != 32 && tile_rows != 64) ||
      (parts != 1 && parts != 2 && parts != 4 && parts != 8) ||
      smem != stack_fwd_smem(tile_rows, bf16 != 0) || smem > vae::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const void* fn = bf16 ? stack_fwd_kernel<true>(tile_rows) : stack_fwd_kernel<false>(tile_rows);
  int per_sm = 0;
  cudaError_t e = vae::launch_info(fn, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const auto* xs = static_cast<const float*>(x);
  const auto* ls = static_cast<const Layer*>(layers);
  auto* o0 = static_cast<float*>(out0);
  auto* o1 = static_cast<float*>(out1);
  auto* w = static_cast<float*>(ws);
  void* args[] = {&xs, &batch, &n_in, &ls, &n_hidden, &n_heads, &o0, &o1, &w, &ldh, &parts};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((batch + tile_rows - 1) / tile_rows * parts);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = parts;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = parts > 1 ? 1 : 0;
  e = cudaLaunchKernelExC(&cfg, fn, args);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(e != cudaSuccess ? e : last);
}

extern "C" const char* vae_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
