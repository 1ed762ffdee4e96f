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
// owns one 128 x 128 tile of dW and walks its rows in a fixed order, in
// slices of 32; the blocks of the first row of tiles also sum db from the
// same staged slices of D. When the tiles alone cannot fill the card, the
// rows are split into `chunks` whose partial tiles a second kernel adds in
// chunk order. No atomics, so a gradient has the same bits on every run.
// In bf16 both operands of the product are rounded to bf16 (fp32
// accumulation), as the reference's _mm_tn does; db sums D unrounded, as
// jnp.sum does.
//
// What bounds them. stack_bwd does three products per layer and row (the
// rematerialized forward and the backward chain) on weights streamed from
// L2, as mlp_fwd.cu does: fp32 FMA throughput (about 1.6 M multiply-adds
// per row for the image decoder with its weight grads, 48 us at the fp32
// peak for 1024 rows); its shared memory holds two TM-row buffers as wide
// as the widest of the input, the hidden layers and the stacked head
// cotangents (784 floats for the image decoder: TM = 32 still fits).
// wgrad at B = 16384 on the image encoder's first layer (M = 784, N = 500)
// does 6.4 GFMA over 84 MB of fp32 operands. In fp32 that is FMA
// throughput (0.19 ms at 67 TFLOP/s): each thread owns 8 x 8 of the tile
// and reads its fragments as 16-byte shared loads, 64 FMAs per 4 loads.
// In bf16 the tensor cores need 13 us and the bytes 25 us: mma.sync.m16n8k16
// (8 warps of 64 x 32) fed by ldmatrix.trans, since both operands are
// stored M- and N-major. Both precisions stream 32-row slices through a
// ring of 4 shared-memory stages filled by cp.async (16-byte copies where
// the widths allow), so 3 slices are in flight while one multiplies; in
// bf16 each thread rounds the values it copied into a bf16 stage.

#include <type_traits>

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

constexpr int kTile = 128;       // dW tile edge
constexpr int kSlice = 32;       // rows per staged slice
constexpr int kWStages = 4;      // slices in the cp.async ring
constexpr int kLdF = kTile + 4;  // fp32 slice row
constexpr int kLdH = kTile + 8;  // bf16 slice row: 272 B, ldmatrix conflict-free
constexpr int kRing = 2 * kSlice * kLdF;  // one ring stage: the A and D slices
constexpr int kHalf = 2 * kSlice * kLdH;  // one bf16 stage

// The output rows: dW [m, n] and db [n], or chunk z's partial [m + 1, n].
__device__ __forceinline__ float* wgrad_out(float* dw, float* partial, int m,
                                            int n, int row) {
  return gridDim.z > 1
             ? partial + ((size_t)blockIdx.z * (m + 1) + row) * n
             : dw + (size_t)row * n;
}

// fp32: thread (tm, tn) owns rows 4 tm ... and 64 + 4 tm ..., columns
// 4 tn ... and 64 + 4 tn ... of the tile.
__device__ __forceinline__ void mac_f32(const float* as, const float* ds,
                                        float (&acc)[8][8]) {
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < kSlice; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + k * kLdF + 4 * tm);
    const float4 a1 = *reinterpret_cast<const float4*>(as + k * kLdF + 64 + 4 * tm);
    const float4 d0 = *reinterpret_cast<const float4*>(ds + k * kLdF + 4 * tn);
    const float4 d1 = *reinterpret_cast<const float4*>(ds + k * kLdF + 64 + 4 * tn);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
  }
}

// bf16: warp (wm, wn) owns rows 64 wm ... and columns 32 wn ...: 4 x 4
// mma tiles per 16 staged rows. Both slices are stored [row][column], so
// the fragments of A^T (M x K) and of D (K x N) come from ldmatrix.trans.
__device__ __forceinline__ void mac_bf16(const __nv_bfloat16* as,
                                         const __nv_bfloat16* ds,
                                         float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int ks = 0; ks < kSlice; ks += 16) {
    uint32_t af[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      vae::ldmatrix_x4_trans(
          af[mt], as + (ks + (lane >> 4) * 8 + (lane & 7)) * kLdH + 64 * wm +
                      16 * mt + ((lane >> 3) & 1) * 8);
    uint32_t bf[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      vae::ldmatrix_x4_trans(
          r, ds + (ks + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLdH + 32 * wn +
                 16 * np + (lane >> 4) * 8);
      bf[2 * np][0] = r[0], bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2], bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        vae::mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
  }
}

// A thread's share of the tile: 4 x 4 mma tiles (bf16) or 8 x 8 values.
template <bool BF16>
struct WgradAcc {
  float v[8][8];
};
template <>
struct WgradAcc<true> {
  float v[4][4][4];
};

// Grid: x over N tiles, y over M tiles, z over row chunks. Chunk c covers
// rows [c * rows_per_chunk, ...). Blocks with blockIdx.y == 0 also write
// db (or row m of the partial). The slices of the chunk stream through a
// ring of kWStages fp32 stages filled by cp.async (thread t copies rows
// t / 32 + 8 i, columns 4 (t % 32) ... of both operands); in bf16 each
// thread rounds the slots it copied into a double-buffered bf16 stage.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
    wgrad(const float* __restrict__ a, int lda, const float* __restrict__ d,
          int ldd, int batch, int m, int n, int rows_per_chunk, float* dw,
          float* db, float* partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* ring = reinterpret_cast<float*>(smem_raw);  // [kWStages][A, D][kSlice][kLdF]
  auto* half = reinterpret_cast<__nv_bfloat16*>(ring + kWStages * kRing);  // [2][A, D][kSlice][kLdH]
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int b_begin = blockIdx.z * rows_per_chunk;
  const int b_end = min(batch, b_begin + rows_per_chunk);
  const int nslices = b_end > b_begin ? (b_end - b_begin + kSlice - 1) / kSlice : 0;
  const bool with_db = blockIdx.y == 0;
  const bool vec_a = lda % 4 == 0 && m % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_d = ldd % 4 == 0 && n % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(d) % 16 == 0;
  const int col = 4 * (threadIdx.x & 31);
  auto issue = [&](int j) {
    if (j < nslices) {
      float* st = ring + (j % kWStages) * kRing;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (threadIdx.x >> 5) + 8 * i;
        const int b = b_begin + j * kSlice + r;
        vae::copy4(st + r * kLdF + col, a, lda, b, m0 + col, m, vec_a, b < b_end);
        vae::copy4(st + (kSlice + r) * kLdF + col, d, ldd, b, n0 + col, n, vec_d,
              b < b_end);
      }
    }
    vae::cp_async_commit();  // empty past the last slice: uniform counts
  };

  for (int j = 0; j < kWStages - 1; ++j) issue(j);
  WgradAcc<BF16> acc{};
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < nslices; ++j) {
    vae::cp_async_wait<kWStages - 2>();
    const float* st = ring + (j % kWStages) * kRing;
    __nv_bfloat16* hs = half + (j & 1) * kHalf;
    if (BF16 || with_db) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (threadIdx.x >> 5) + 8 * i;
        const float4 dv = *reinterpret_cast<const float4*>(st + (kSlice + r) * kLdF + col);
        if (with_db) {  // unrounded D; rows past the chunk are zero
          dsum[0] += dv.x, dsum[1] += dv.y, dsum[2] += dv.z, dsum[3] += dv.w;
        }
        if constexpr (BF16) {
          *reinterpret_cast<uint2*>(hs + r * kLdH + col) = vae::pack_bf16x4(
              *reinterpret_cast<const float4*>(st + r * kLdF + col));
          *reinterpret_cast<uint2*>(hs + (kSlice + r) * kLdH + col) =
              vae::pack_bf16x4(dv);
        }
      }
    }
    __syncthreads();  // slice j is whole; slice j - 1 is consumed
    issue(j + kWStages - 1);
    if constexpr (BF16)
      mac_bf16(hs, hs + kSlice * kLdH, acc.v);
    else
      mac_f32(st, st + kSlice * kLdF, acc.v);
  }
  vae::cp_async_wait<0>();

  if constexpr (BF16) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, cq = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + 64 * (warp >> 2) + 16 * mt + g + 8 * hh;
        if (row >= m) continue;
        float* out = wgrad_out(dw, partial, m, n, row);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = n0 + 32 * (warp & 3) + 8 * nt + 2 * cq;
          if (c < n) out[c] = acc.v[mt][nt][2 * hh];
          if (c + 1 < n) out[c + 1] = acc.v[mt][nt][2 * hh + 1];
        }
      }
  } else {
    const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + (i < 4 ? 4 * tm + i : 64 + 4 * tm + i - 4);
      if (row >= m) continue;
      float* out = wgrad_out(dw, partial, m, n, row);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + 64 * h + 4 * tn;
        if (n % 4 == 0) {
          if (c < n)
            *reinterpret_cast<float4*>(out + c) =
                make_float4(acc.v[i][4 * h], acc.v[i][4 * h + 1],
                            acc.v[i][4 * h + 2], acc.v[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < n) out[c + j] = acc.v[i][4 * h + j];
        }
      }
    }
  }

  if (with_db) {
    // 8 row groups per column, each in row order, then added in order.
    __syncthreads();  // the ring is free
    float* red = ring;  // [8][kTile]
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(threadIdx.x >> 5) * kTile + col + j] = dsum[j];
    __syncthreads();
    const int c = threadIdx.x;
    if (c < kTile && n0 + c < n) {
      float t = red[c];
      for (int g = 1; g < kThreads / 32; ++g) t += red[g * kTile + c];
      if (gridDim.z > 1)
        partial[((size_t)blockIdx.z * (m + 1) + m) * n + n0 + c] = t;
      else
        db[n0 + c] = t;
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
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, chunks);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* as = static_cast<const float*>(a);
  const auto* ds = static_cast<const float*>(d);
  auto* o_w = static_cast<float*>(dw);
  auto* o_b = static_cast<float*>(db);
  auto* part = static_cast<float*>(partial);
  const int smem = kWStages * kRing * (int)sizeof(float) +
                   (bf16 ? 2 * kHalf * (int)sizeof(__nv_bfloat16) : 0);
  auto k = bf16 ? wgrad<true> : wgrad<false>;
  int per_sm = 0;
  cudaError_t e = vae::launch_info((const void*)k, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  k<<<grid, kThreads, smem, st>>>(as, lda, ds, ldd, batch, m, n,
                                  rows_per_chunk, o_w, o_b, part);
  e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return (int)e;
  const size_t total = (size_t)(m + 1) * n;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  wgrad_reduce<<<blocks < 1024 ? blocks : 1024, kThreads, 0, st>>>(
      part, chunks, m, n, o_w, o_b);
  return (int)cudaGetLastError();
}
