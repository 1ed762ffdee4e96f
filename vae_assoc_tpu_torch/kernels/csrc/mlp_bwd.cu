// Backward of the fused MLP encoder and decoder stacks, and the
// weight-gradient kernel that the training backward passes share, on
// Hopper (sm_90a).
//
// stack_bwd is the per-row half of two Pallas TPU kernels:
// vae_assoc_tpu/kernels/mlp.py::_enc_bwd_kernel (launched as enc_bwd, two
// heads: mu and logvar) and mlp.py::_dec_bwd_kernel (launched as dec_bwd,
// one head: the decoder output, 784 wide for images). Per tile of rows it
// rematerializes the softplus stack from its input (x -> h1 -> ... -> hL),
// backprops the heads' cotangents through the stack and, where the caller
// reads it, on to the input gradient (dx, or dz over the decoder input
// [z, cond]). For the weight gradients it writes each layer's activation
// h_i and cotangent da_i to scratch in device memory. The TPU kernels sum
// the weight gradients over row tiles in place because their grid runs in
// order; GPU blocks run at once, so wgrad below sums them instead. Rows
// past the batch (a ragged last tile) write nothing, so they add nothing.
// Depth comes from the layer table (up to kMaxHidden hidden layers), passed
// by value: no device-side table, nothing to copy per call. A stack with no
// hidden layer (a linear layer, as tensor parallelism's column-split output
// layer runs one) has only dx to compute.
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
// What bounds them. stack_bwd: per row the image encoder does about 1.30 M
// multiply-adds with dx and 0.91 M without it, against 3 KB of input and
// cotangents, on 1.6 MB of weights that stay in L2: arithmetic, and the
// rows that share each weight byte a block reads are what a tile saves. It
// is mega.cu's mega_dec_loss_bwd with a layer table in place of a fixed
// depth, on the same block-tiled product (dense_tile.cuh): a block owns
// TM = 16, 32 or 64 rows (from the batch) and runs its products in turn,
// each over the whole width,
//   - the forward h_i W_i (epilogue: + b_i, softplus, store h_{i+1}),
//   - the heads' g W^T (the encoder's second head adds to what its first
//     wrote, in the same thread, so the sum has one order),
//   - the chain da_{i+1} W_{i+1}^T (epilogue: times sigmoid(pre_i), taken
//     from the saved h as -expm1(-h); store da_i),
//   - and dx = da_1 W_1^T only when asked: no training path reads it, and
//     it is 30 % of the image encoder's products.
// Each A streams back from device memory (x, the cotangents, or what these
// blocks just wrote), each W^T is read from the forward's tensor as it
// lies, fp32 on register tiles and bf16 on mma.sync. No row lives in
// shared memory, so no width bounds the tile. Where 16-row tiles would
// leave half the SMs idle, two blocks (a cluster) share each tile, each
// taking every other column tile, with a cluster barrier between products.
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

#include "common.cuh"
#include "dense_tile.cuh"

namespace {

using vae::kThreads;

constexpr int kMaxHidden = 16;

struct EncLayer {
  const float* w;  // [n_in, n_out]
  const float* b;  // [n_out]
  float* act;      // scratch [B, n_out]: softplus(pre-activation)
  float* da;       // scratch [B, n_out]: cotangent of the pre-activation
  int n_in;
  int n_out;
};

struct EncTable {
  EncLayer l[kMaxHidden];
};

// Shared memory of a launch (kernels/mlp.py::stack_bwd_plan): the ring of
// its largest product mode, W^T with A streamed.
__host__ __device__ constexpr int stack_smem(int tm, bool bf16) {
  return dense_ring_bytes(tm, true, true, bf16);
}

// `parts` blocks (a cluster, consecutive in x) own TM rows; see the top of
// this file. Heads: w0 [width of hL, n_g] with cotangent g0 [batch, n_g],
// and, for the encoder, w1 and g1 (null for the decoder). dx is null when
// the caller does not read it. At 64 rows two blocks share an SM (at most
// 128 registers a thread), so one block's barriers and waits overlap the
// other's products.
template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads, TM == 64 ? 2 : 1)
    stack_bwd(const float* __restrict__ x, int batch, int n_in,
              const __grid_constant__ EncTable t, int n_hidden,
              const float* __restrict__ w0, const float* __restrict__ w1, int n_g,
              const float* __restrict__ g0, const float* __restrict__ g1,
              float* __restrict__ dx, int parts) {
  extern __shared__ __align__(16) float ring[];
  const int part = blockIdx.x % parts;
  const int row0 = blockIdx.x / parts * TM;
  const int valid = min(TM, batch - row0);
  auto shared_rows = [&]() {  // the other part's writes of the last product
    if (parts > 1) cluster_sync();
  };

  // The rematerialized forward: h_{i+1} = softplus(h_i W_i + b_i), h_0 = x.
  softplus_stack<TM, BF16>(
      x + (size_t)row0 * n_in, n_in, n_in, n_hidden,
      [&](int i) {
        const EncLayer& L = t.l[i];
        return StackLayer{L.w, L.b, L.act + (size_t)row0 * L.n_out, L.n_out, L.n_out};
      },
      valid, ring, part, parts);

  // A cotangent product: out = A W^T for W [N, K] (plus what out holds,
  // where `add`), times sigmoid(pre) from the saved activation `act` where
  // one is given. The same (row, column) of out belongs to the same thread
  // in every product of N columns, and act's to the same block.
  auto back = [&](const float* A, int K, const float* W, int N, float* out,
                  const float* act, bool add) {
    auto epi = [&](int r, int j, float y) {
      if (r < valid) {
        const size_t at = (size_t)r * N + j;
        if (add) y += out[at];
        out[at] = act != nullptr ? y * dsoftplus(act[at]) : y;
      }
    };
    shared_rows();
    dense_rows<TM, BF16, true, true>(A, nullptr, K, valid, W, K, N, ring, epi, part, parts);
  };
  // No hidden layer: the stack is its heads, linear layers on x, and the
  // only per-row product is dx = g0 W0^T [+ g1 W1^T] (the wrapper launches
  // this only when dx is read).
  if (n_hidden == 0) {
    if (dx != nullptr) {
      float* o = dx + (size_t)row0 * n_in;
      back(g0 + (size_t)row0 * n_g, n_g, w0, n_in, o, nullptr, false);
      if (g1 != nullptr) back(g1 + (size_t)row0 * n_g, n_g, w1, n_in, o, nullptr, true);
    }
    return;
  }
  // The heads: da_L = (g0 W0^T [+ g1 W1^T]) * sigmoid(pre_L).
  const EncLayer& top = t.l[n_hidden - 1];
  float* da = top.da + (size_t)row0 * top.n_out;
  const float* h = top.act + (size_t)row0 * top.n_out;
  back(g0 + (size_t)row0 * n_g, n_g, w0, top.n_out, da, g1 == nullptr ? h : nullptr, false);
  if (g1 != nullptr) back(g1 + (size_t)row0 * n_g, n_g, w1, top.n_out, da, h, true);
  // The chain: da_i = (da_{i+1} W_{i+1}^T) * sigmoid(pre_i), then dx.
  for (int i = n_hidden - 2; i >= 0; --i) {
    const EncLayer& L = t.l[i];
    const EncLayer& U = t.l[i + 1];
    back(U.da + (size_t)row0 * U.n_out, U.n_out, U.w, L.n_out,
         L.da + (size_t)row0 * L.n_out, L.act + (size_t)row0 * L.n_out, false);
  }
  if (dx != nullptr) {
    const EncLayer& L = t.l[0];
    back(L.da + (size_t)row0 * L.n_out, L.n_out, L.w, n_in, dx + (size_t)row0 * n_in,
         nullptr, false);
  }
}

template <bool BF16>
const void* stack_kernel(int tm) {
  return tm == 16   ? (const void*)stack_bwd<16, BF16>
         : tm == 32 ? (const void*)stack_bwd<32, BF16>
                    : (const void*)stack_bwd<64, BF16>;
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

// Launches stack_bwd on a layer table of n_hidden rows of 6 int64 values
// (w, b, act, da, n_in, n_out) as EncLayer; w1 and g1 are null for one
// head, dx for no input gradient.
int run_stack_bwd(const void* x, int batch, int n_in, const long long* layers,
                  int n_hidden, const void* w0, const void* w1, int n_g,
                  const void* g0, const void* g1, void* dx, int tile_rows,
                  int smem, int parts, int bf16, void* stream) {
  if (batch <= 0 || n_in <= 0 || n_g <= 0 || n_hidden < 0 || n_hidden > kMaxHidden ||
      (tile_rows != 16 && tile_rows != 32 && tile_rows != 64) ||
      (parts != 1 && parts != 2) || smem != stack_smem(tile_rows, bf16 != 0) ||
      smem > vae::kSmemLimit || (w1 == nullptr) != (g1 == nullptr))
    return (int)cudaErrorInvalidValue;
  EncTable t{};
  int width = n_in;
  for (int i = 0; i < n_hidden; ++i) {
    const long long* row = layers + 6 * i;
    t.l[i] = EncLayer{reinterpret_cast<const float*>(row[0]),
                      reinterpret_cast<const float*>(row[1]),
                      reinterpret_cast<float*>(row[2]), reinterpret_cast<float*>(row[3]),
                      (int)row[4], (int)row[5]};
    if (t.l[i].n_in != width || t.l[i].n_out <= 0) return (int)cudaErrorInvalidValue;
    width = t.l[i].n_out;
  }
  const void* fn = bf16 ? stack_kernel<true>(tile_rows) : stack_kernel<false>(tile_rows);
  int per_sm = 0;
  cudaError_t e = vae::launch_info(fn, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const auto* xs = static_cast<const float*>(x);
  const auto* ws0 = static_cast<const float*>(w0);
  const auto* ws1 = static_cast<const float*>(w1);
  const auto* c0 = static_cast<const float*>(g0);
  const auto* c1 = static_cast<const float*>(g1);
  auto* o_dx = static_cast<float*>(dx);
  void* args[] = {&xs, &batch, &n_in, &t, &n_hidden, &ws0, &ws1, &n_g, &c0, &c1, &o_dx, &parts};
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

}  // namespace

// Per-row half of the encoder backward. x [batch, n_in]; `layers` as
// run_stack_bwd; wm, wl [width of the last hidden layer, n_z] the heads'
// weights as the forward has them; dmu, dlv [batch, n_z]. Writes the
// act/da scratch and, unless dx is null, dx [batch, n_in]. `tile_rows` (16,
// 32 or 64), `smem` and `parts` (1 or 2 blocks, a cluster, per row tile)
// are kernels/mlp.py::stack_bwd_plan's. Launches on `stream` without
// synchronising and returns the launch's CUDA error.
extern "C" int vae_mlp_enc_bwd(const void* x, int batch, int n_in,
                               const long long* layers, int n_hidden,
                               const void* wm, const void* wl, int n_z,
                               const void* dmu, const void* dlv, void* dx,
                               int tile_rows, int smem, int parts, int bf16,
                               void* stream) {
  if (wl == nullptr || dlv == nullptr) return (int)cudaErrorInvalidValue;
  return run_stack_bwd(x, batch, n_in, layers, n_hidden, wm, wl, n_z, dmu, dlv, dx,
                       tile_rows, smem, parts, bf16, stream);
}

// Per-row half of the decoder backward. z [batch, n_in] is the decoder
// input ([z, cond] for a conditional model); `layers` as run_stack_bwd;
// wo [width of the last hidden layer, n_out] the output layer's weight;
// dout [batch, n_out]. Writes the act/da scratch and, unless dz is null,
// dz [batch, n_in]. The plan arguments as vae_mlp_enc_bwd's.
extern "C" int vae_mlp_dec_bwd(const void* z, int batch, int n_in,
                               const long long* layers, int n_hidden,
                               const void* wo, int n_out, const void* dout,
                               void* dz, int tile_rows, int smem, int parts,
                               int bf16, void* stream) {
  return run_stack_bwd(z, batch, n_in, layers, n_hidden, wo, nullptr, n_out, dout,
                       nullptr, dz, tile_rows, smem, parts, bf16, stream);
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
