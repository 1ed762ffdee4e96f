// Backward of the fused MLP encoder and decoder stacks, and the
// weight-gradient kernel that the training backward passes share, on
// Hopper (sm_90a).
//
// stack_bwd is the per-row half of two Pallas TPU kernels:
// vae_assoc_tpu/kernels/mlp.py::_enc_bwd_kernel (launched as enc_bwd, two
// heads: mu and logvar) and mlp.py::_dec_bwd_kernel (launched as dec_bwd,
// one head: the decoder output, 784 wide for images). Per tile of TM rows
// it rematerializes the softplus stack from its input (x -> h1 -> ... ->
// hL), then backprops the heads' cotangents through the stack to the input
// gradient (dx, or dz over the decoder input [z, cond]). It writes that
// gradient and, for the weight gradients, each layer's activation h_i and
// cotangent da_i to scratch in device memory. The TPU kernels sum the
// weight gradients over row tiles in place because their grid runs in
// order; GPU blocks run at once, so wgrad below sums them instead. Rows
// past the batch (a ragged last tile) write nothing, so they add nothing.
// Depth comes from the layer table (up to kMaxHidden hidden layers), passed
// by value: no device-side table, nothing to copy per call.
//
// wgrad computes dW = A^T D and db = sum of the rows of D over all B rows,
// A [B, M], D [B, N]: the in-kernel `ref[:] += aT @ d` of
// mlp.py::_enc_bwd_kernel / _dec_bwd_kernel /
// megakernel.py::_dec_loss_bwd_kernel, done deterministically. Each block
// owns one 64 x 64 tile of dW (or 64 columns of db) and walks its rows in a
// fixed order; when the tiles alone cannot fill the card, the rows are
// split into `chunks` whose partial tiles a second kernel adds in chunk
// order. No atomics, so a gradient has the same bits on every run. In bf16
// both operands of the product are rounded to bf16 (fp32 accumulation), as
// the reference's _mm_tn does; db sums D unrounded, as jnp.sum does.
//
// What bounds them. stack_bwd does three products per layer and row (the
// rematerialized forward and the backward chain) on weights streamed from
// L2, as mlp_fwd.cu does: fp32 FMA throughput (about 1.6 M multiply-adds
// per row for the image decoder with its weight grads, 48 us at the fp32
// peak for 1024 rows); its shared memory holds two TM-row buffers as wide
// as the widest of the input, the hidden layers and the stacked head
// cotangents (784 floats for the image decoder: TM = 32 still fits).
// wgrad at B = 16384 does 6.5 GFMA for the image encoder's first layer
// alone: fp32 FMA throughput, with operands staged through shared memory
// in 16-row slices, each loaded value feeding 4 FMAs per thread. Tensor
// cores (wgmma) for bf16 are later work.

#include "common.cuh"

namespace {

using vae::kThreads;

constexpr int kMaxHidden = 16;

struct EncLayer {
  const float* w;   // [n_in, n_out]
  const float* b;   // [n_out]
  const float* wt;  // [n_out, n_in], the transpose of w
  float* act;       // scratch [B, n_out]: softplus(pre-activation)
  float* sig;       // scratch [B, n_out]: sigmoid(pre-activation)
  float* da;        // scratch [B, n_out]: cotangent of the pre-activation
  int n_in;
  int n_out;
};

struct EncTable {
  EncLayer l[kMaxHidden];
};

// Heads: n_heads (1 or 2) of n_g columns each; their cotangents g0 (and g1)
// are [batch, n_g], stacked as [g0, g1] against head_t = [W0^T; W1^T].
template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads)
    stack_bwd(const float* __restrict__ x, int batch, int n_in, EncTable t,
              int n_hidden, const float* __restrict__ head_t, int n_g,
              int n_heads, const float* __restrict__ g0,
              const float* __restrict__ g1, float* __restrict__ dx,
              int stride) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;
  float* nxt = smem + TM * stride;
  const int row0 = blockIdx.x * TM;
  const int valid = min(TM, batch - row0);

  // Rematerialize the forward; keep h_i and sigmoid(pre_i) for the backward.
  vae::load_tile<TM, BF16>(cur, stride, x, n_in, n_in, row0, valid);
  __syncthreads();
  for (int i = 0; i < n_hidden; ++i) {
    const EncLayer L = t.l[i];
    auto fwd = [&](int r, int j, float y) {
      const float g = vae::softplus(y);
      nxt[r * stride + j] = vae::operand<BF16>(g);
      if (r < valid) {
        L.act[(size_t)(row0 + r) * L.n_out + j] = g;
        L.sig[(size_t)(row0 + r) * L.n_out + j] = vae::sigmoid(y);
      }
    };
    vae::layer<TM, BF16>(cur, stride, L.w, L.n_out, L.b, L.n_in, L.n_out, fwd);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // Heads: dh = [g0, g1] [W0; W1]^T, one product over the stacked heads.
  const int n2 = n_heads * n_g;
  for (int i = threadIdx.x; i < TM * n2; i += kThreads) {
    const int r = i / n2;
    const int k = i - r * n2;
    float v = 0.f;
    if (r < valid) {
      v = k < n_g ? g0[(size_t)(row0 + r) * n_g + k]
                  : g1[(size_t)(row0 + r) * n_g + (k - n_g)];
    }
    cur[r * stride + k] = vae::operand<BF16>(v);
  }
  __syncthreads();

  // da_i = (da_{i+1} W_{i+1}^T) * sigmoid(pre_i), from the top layer down;
  // the sigmoids were written by this block above (plain loads, not __ldg).
  const float* in_w = head_t;
  int in_k = n2;
  for (int i = n_hidden - 1; i >= 0; --i) {
    const EncLayer L = t.l[i];
    auto bwd = [&](int r, int j, float y) {
      float v = 0.f;
      if (r < valid) {
        const size_t at = (size_t)(row0 + r) * L.n_out + j;
        v = y * L.sig[at];
        L.da[at] = v;
      }
      nxt[r * stride + j] = vae::operand<BF16>(v);
    };
    vae::layer<TM, BF16>(cur, stride, in_w, L.n_out, nullptr, in_k, L.n_out,
                         bwd);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    in_w = L.wt;
    in_k = L.n_out;
  }
  auto edx = [&](int r, int j, float y) {
    if (r < valid) dx[(size_t)(row0 + r) * n_in + j] = y;
  };
  vae::layer<TM, BF16>(cur, stride, in_w, n_in, nullptr, in_k, n_in, edx);
}

constexpr int kTile = 64;  // dW tile edge
constexpr int kSlice = 16;  // rows staged per step

// Grid: x over N tiles, y over M tiles plus one row of db blocks, z over
// row chunks. Chunk c covers rows [c * rows_per_chunk, ...).
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    wgrad(const float* __restrict__ a, int lda, const float* __restrict__ d,
          int ldd, int batch, int m, int n, int rows_per_chunk, float* dw,
          float* db, float* partial) {
  __shared__ __align__(16) float as[kSlice][kTile];
  __shared__ __align__(16) float ds[kSlice][kTile];
  const int n0 = blockIdx.x * kTile;
  const int m_tiles = gridDim.y - 1;
  const int b_begin = blockIdx.z * rows_per_chunk;
  const int b_end = min(batch, b_begin + rows_per_chunk);
  const bool split = gridDim.z > 1;

  if ((int)blockIdx.y == m_tiles) {
    // db: 4 row groups per column, each in row order, then added in order.
    const int c = threadIdx.x % kTile;
    const int q = threadIdx.x / kTile;
    float s = 0.f;
    if (n0 + c < n) {
      for (int b = b_begin + q; b < b_end; b += kThreads / kTile)
        s += d[(size_t)b * ldd + n0 + c];
    }
    as[q][c] = s;
    __syncthreads();
    if (threadIdx.x < kTile && n0 + c < n) {
      float t = as[0][c];
      for (int g = 1; g < kThreads / kTile; ++g) t += as[g][c];
      if (split)
        partial[((size_t)blockIdx.z * (m + 1) + m) * n + n0 + c] = t;
      else
        db[n0 + c] = t;
    }
    return;
  }

  const int m0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16;  // 4 columns of the tile each
  const int ty = threadIdx.x / 16;  // 4 rows of the tile each
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int b0 = b_begin; b0 < b_end; b0 += kSlice) {
    for (int i = threadIdx.x; i < kSlice * kTile; i += kThreads) {
      const int kk = i / kTile;
      const int c = i - kk * kTile;
      const int b = b0 + kk;
      const bool row = b < b_end;
      as[kk][c] = row && m0 + c < m
                      ? vae::operand<BF16>(a[(size_t)b * lda + m0 + c])
                      : 0.f;
      ds[kk][c] = row && n0 + c < n
                      ? vae::operand<BF16>(d[(size_t)b * ldd + n0 + c])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlice; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 dv = *reinterpret_cast<const float4*>(&ds[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], dr[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = m0 + ty * 4 + i;
    if (mm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (nn >= n) continue;
      if (split)
        partial[((size_t)blockIdx.z * (m + 1) + mm) * n + nn] = acc[i][j];
      else
        dw[(size_t)mm * n + nn] = acc[i][j];
    }
  }
}

// Adds the chunks' partial [m + 1, n] tiles in chunk order.
__global__ void __launch_bounds__(kThreads)
    wgrad_reduce(const float* __restrict__ partial, int chunks, int m, int n,
                 float* dw, float* db) {
  const size_t total = (size_t)(m + 1) * n;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    float s = partial[i];
    for (int c = 1; c < chunks; ++c) s += partial[(size_t)c * total + i];
    if (i < (size_t)m * n)
      dw[i] = s;
    else
      db[i - (size_t)m * n] = s;
  }
}

}  // namespace

namespace {

// Launches stack_bwd on a layer table of n_hidden rows of 8 int64 values
// (w, b, wT, act, sig, da, n_in, n_out) as EncLayer.
int run_stack_bwd(const void* x, int batch, int n_in, const long long* layers,
                  int n_hidden, const void* head_t, int n_g, int n_heads,
                  const void* g0, const void* g1, void* dx, int stride,
                  int tile_rows, int bf16, void* stream) {
  if (batch <= 0 || n_hidden < 1 || n_hidden > kMaxHidden || stride % 4 != 0 ||
      stride < n_heads * n_g)
    return (int)cudaErrorInvalidValue;
  EncTable t;
  for (int i = 0; i < n_hidden; ++i) {
    const long long* row = layers + 8 * i;
    t.l[i].w = reinterpret_cast<const float*>(row[0]);
    t.l[i].b = reinterpret_cast<const float*>(row[1]);
    t.l[i].wt = reinterpret_cast<const float*>(row[2]);
    t.l[i].act = reinterpret_cast<float*>(row[3]);
    t.l[i].sig = reinterpret_cast<float*>(row[4]);
    t.l[i].da = reinterpret_cast<float*>(row[5]);
    t.l[i].n_in = (int)row[6];
    t.l[i].n_out = (int)row[7];
  }
  const auto* xs = static_cast<const float*>(x);
  const auto* ht = static_cast<const float*>(head_t);
  const auto* c0 = static_cast<const float*>(g0);
  const auto* c1 = static_cast<const float*>(g1);
  auto* o_dx = static_cast<float*>(dx);
  auto st = static_cast<cudaStream_t>(stream);
#define VAE_STACK_BWD(TM)                                                    \
  [&]() -> cudaError_t {                                                     \
    auto k = bf16 ? stack_bwd<TM, true> : stack_bwd<TM, false>;              \
    const size_t smem = 2 * (size_t)TM * stride * sizeof(float);             \
    cudaError_t e = vae::set_smem(k, smem);                                  \
    if (e != cudaSuccess) return e;                                          \
    k<<<(batch + TM - 1) / TM, kThreads, smem, st>>>(                        \
        xs, batch, n_in, t, n_hidden, ht, n_g, n_heads, c0, c1, o_dx,        \
        stride);                                                             \
    return cudaGetLastError();                                               \
  }()
  auto run = [&]() -> cudaError_t { VAE_TM_SWITCH(tile_rows, VAE_STACK_BWD) };
#undef VAE_STACK_BWD
  return (int)run();
}

}  // namespace

// Per-row half of the encoder backward. x [batch, n_in]; `layers` as
// run_stack_bwd; head_t [2 n_z, width of the last hidden layer] is
// [Wm^T; Wl^T]; dmu, dlv [batch, n_z]. Writes dx [batch, n_in] and the
// act/sig/da scratch. `stride` is the shared-memory row length (a multiple
// of 4, at least n_in, 2 n_z and every hidden width).
extern "C" int vae_mlp_enc_bwd(const void* x, int batch, int n_in,
                               const long long* layers, int n_hidden,
                               const void* head_t, int n_z, const void* dmu,
                               const void* dlv, void* dx, int stride,
                               int tile_rows, int bf16, void* stream) {
  return run_stack_bwd(x, batch, n_in, layers, n_hidden, head_t, n_z, 2, dmu,
                       dlv, dx, stride, tile_rows, bf16, stream);
}

// Per-row half of the decoder backward. z [batch, n_in] is the decoder
// input ([z, cond] for a conditional model); `layers` as run_stack_bwd;
// head_t [n_out, width of the last hidden layer] is Wo^T; dout
// [batch, n_out]. Writes dz [batch, n_in] and the act/sig/da scratch.
// `stride`: a multiple of 4, at least n_in, n_out and every hidden width.
extern "C" int vae_mlp_dec_bwd(const void* z, int batch, int n_in,
                               const long long* layers, int n_hidden,
                               const void* head_t, int n_out,
                               const void* dout, void* dz, int stride,
                               int tile_rows, int bf16, void* stream) {
  return run_stack_bwd(z, batch, n_in, layers, n_hidden, head_t, n_out, 1,
                       dout, nullptr, dz, stride, tile_rows, bf16, stream);
}

// dw [m, n] = A^T D and db [n] = the column sums of D over `batch` rows;
// A [batch, m] (row stride lda), D [batch, n] (row stride ldd). With
// chunks > 1, `partial` holds chunks * (m + 1) * n floats of scratch and a
// second launch adds them; rows_per_chunk * chunks must cover the batch.
extern "C" int vae_wgrad(const void* a, int lda, const void* d, int ldd,
                         int batch, int m, int n, int rows_per_chunk,
                         int chunks, void* dw, void* db, void* partial,
                         int bf16, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || chunks < 1 ||
      (long long)rows_per_chunk * chunks < batch ||
      (chunks > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile + 1,
                  chunks);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* as = static_cast<const float*>(a);
  const auto* ds = static_cast<const float*>(d);
  auto* o_w = static_cast<float*>(dw);
  auto* o_b = static_cast<float*>(db);
  auto* part = static_cast<float*>(partial);
  if (bf16)
    wgrad<true><<<grid, kThreads, 0, st>>>(as, lda, ds, ldd, batch, m, n,
                                           rows_per_chunk, o_w, o_b, part);
  else
    wgrad<false><<<grid, kThreads, 0, st>>>(as, lda, ds, ldd, batch, m, n,
                                            rows_per_chunk, o_w, o_b, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return (int)e;
  const size_t total = (size_t)(m + 1) * n;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  wgrad_reduce<<<blocks < 1024 ? blocks : 1024, kThreads, 0, st>>>(
      part, chunks, m, n, o_w, o_b);
  return (int)cudaGetLastError();
}
