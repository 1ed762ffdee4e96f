// One time step of an LSTM layer, forward (lstm_fwd) and backward
// (lstm_bwd), for kernels/lstm.py: Sketch-RNN's encoder (two directions in
// one launch) and decoder (models/sketch_rnn.py).
//
// The cell (sketch_rnn rnn.LSTMCell, forget bias 1):
//   [i, j, f, o] = x W_x + h W_h + b     (x W_x + b hoisted over all steps)
//   c' = c sigma(f + 1) + sigma(i) tanh(j),  h' = tanh(c') sigma(o)
// A row whose length is at most t keeps its state at step t
// (bidirectional_dynamic_rnn's sequence_length).
//
// lstm_fwd, step t: the recurrent product h_t W_h on dense_tile.cuh's
// block-tiled product (A = h_t streamed from device memory, W as stored),
// one block per (row tile, 128-column tile, direction). W_h comes in with
// its columns interleaved (kernels/lstm.py::interleave: column 128 c + 4 u
// + g is gate g of unit 32 c + u), so a column tile holds all four gates of
// 32 units; the epilogue parks the product in shared memory, and the block
// then adds the hoisted input product (and the decoder's per-row addend,
// z W_x[5:] + b), keeps the gate pre-activations for the backward, and
// writes c_{t+1} and h_{t+1}.
//
// lstm_bwd, step t: dh_t's recurrent part dgates_{t+1} W_h^T, split by gate
// over the four blocks of a cluster, one cluster per (row tile, 128-unit
// tile, direction): block g streams gate g's columns of dgates_{t+1} and
// multiplies them by that gate's quarter of W_h^T (W_h split by gate into
// [4][H][H], kernels/lstm.py::split_gates) on dense_tile.cuh, parking its
// partial tile in shared memory. Each block then takes a quarter of the
// tile's rows: it adds the four partials in gate order through distributed
// shared memory, the cotangent of h_{t+1} from above and the passed-through
// gradient of a row that held its state, computes the gate gradients of
// step t from the kept pre-activations and c_t, c_{t+1}, and carries dc.
// Each (row, unit) belongs to one thread of one block, which reads and
// writes its dh and dc in place. Step t = -1
// writes dh of the initial state. dgates has T + 1 slots, the last zero.
// The weight gradients are one wgrad each over all T B rows afterwards
// (kernels/mlp.py::weight_grads).
//
// Deterministic: no atomics; each output adds its k in one fixed order.

#include <cooperative_groups.h>

#include "dense_tile.cuh"

namespace cg = cooperative_groups;

namespace {

struct LstmDir {
  const float* xproj;  // [T, B, 4H]: x W_x (+ b), gates in [i, j, f, o] order
  const float* w;      // forward: W_h interleaved [H, 4H]; backward: split by gate [4][H][H]
  float* hs;           // [T + 1, B, H], hs[0] the initial state
  float* cs;           // [T + 1, B, H]
  float* gates;        // [T, B, 4H] pre-activations
  float* dgates;       // [T + 1, B, 4H], slot T zero (backward)
  const float* dh_seq; // [T + 1, B, H]: cotangent of hs (backward; may be null)
  float* dh_acc;       // [B, H]: dh of the last step's output (backward)
  float* dc_acc;       // [B, H]: dc carried (backward)
  float* dh0;          // [B, H]: dh of the initial state (backward, step -1)
};

struct LstmArgs {
  LstmDir d[2];
  const float* xrow;   // [B, 4H] added at every step (direction 0), or null
  const int* lengths;  // [B] steps each row runs, or null: all T
  int t, T, B, H;
};

constexpr int kUnits = kDN / 4;  // units per column tile of the forward

__device__ __forceinline__ float sig(float a) { return 1.f / (1.f + expf(-a)); }

template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads) lstm_fwd(const __grid_constant__ LstmArgs a) {
  extern __shared__ __align__(16) float smem[];
  const LstmDir& d = a.d[blockIdx.z];
  const int row0 = blockIdx.x * TM, rows = min(TM, a.B - row0);
  const int H = a.H, N = 4 * H, t = a.t, B = a.B;
  float* tile = smem;              // [TM][kDN]: this block's product
  float* ring = smem + TM * kDN;
  const int n0 = blockIdx.y * kDN;
  auto epi = [&](int r, int n, float y) { tile[r * kDN + (n - n0)] = y; };
  dense_rows<TM, BF16, false, true>(d.hs + ((size_t)t * B + row0) * H, nullptr, H, rows, d.w,
                                    H, N, ring, epi, blockIdx.y, gridDim.y);
  const float* xrow = blockIdx.z == 0 ? a.xrow : nullptr;
  for (int e = threadIdx.x; e < TM * kUnits; e += kThreads) {
    const int r = e / kUnits, uu = e % kUnits;
    if (r >= rows) continue;
    const int b = row0 + r, u = blockIdx.y * kUnits + uu;
    const size_t bh = (size_t)b * H + u, bn = (size_t)b * N + u;
    float pre[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float v = tile[r * kDN + 4 * uu + g] + d.xproj[(size_t)t * B * N + bn + g * H];
      if (xrow != nullptr) v += xrow[bn + g * H];
      pre[g] = v;
      d.gates[(size_t)t * B * N + bn + g * H] = v;
    }
    float c = d.cs[(size_t)t * B * H + bh], h = d.hs[(size_t)t * B * H + bh];
    if (a.lengths == nullptr || t < a.lengths[b]) {
      c = c * sig(pre[2] + 1.f) + sig(pre[0]) * tanhf(pre[1]);
      h = tanhf(c) * sig(pre[3]);
    }
    d.cs[(size_t)(t + 1) * B * H + bh] = c;
    d.hs[(size_t)(t + 1) * B * H + bh] = h;
  }
}

template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads) lstm_bwd(const __grid_constant__ LstmArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = (int)cluster.block_rank();  // this block's gate: its quarter of the product's k
  const LstmDir& d = a.d[blockIdx.z / 4];
  const int row0 = blockIdx.x * TM, rows = min(TM, a.B - row0);
  const int H = a.H, N = 4 * H, t = a.t, B = a.B, T = a.T;
  const int* len = a.lengths;
  float* tile = smem;  // [TM][kDN]: this block's partial product
  float* ring = smem + TM * kDN;
  const int n0 = blockIdx.y * kDN;
  auto park = [&](int r, int u, float y) { tile[r * kDN + (u - n0)] = y; };
  dense_rows<TM, BF16, true, true>(d.dgates + ((size_t)(t + 1) * B + row0) * N + g * H, nullptr, N,
                                   rows, d.w + (size_t)g * H * H, H, H, ring, park, blockIdx.y,
                                   gridDim.y);
  cluster.sync();  // the four partials are whole
  {
    const float* part[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) part[k] = cluster.map_shared_rank(tile, k);
    constexpr int kRows = TM / 4;  // each block of the cluster finishes a quarter of the rows
    for (int e = threadIdx.x; e < kRows * kDN; e += kThreads) {
      const int r = g * kRows + e / kDN, u = n0 + e % kDN;
      if (r >= rows || u >= H) continue;
      const int b = row0 + r;
      const size_t bh = (size_t)b * H + u, bn = (size_t)b * N + u;
      const int at = r * kDN + (u - n0);
      const float p = ((part[0][at] + part[1][at]) + part[2][at]) + part[3][at];
      const bool next = t + 1 < T && (len == nullptr || t + 1 < len[b]);
      const float carry = p + (next ? 0.f : d.dh_acc[bh]);
      if (t < 0) {
        d.dh0[bh] = carry;
        continue;
      }
      const float dh =
          (d.dh_seq != nullptr ? d.dh_seq[(size_t)(t + 1) * B * H + bh] : 0.f) + carry;
      float* dg = d.dgates + (size_t)t * B * N + bn;
      d.dh_acc[bh] = dh;
      if (len != nullptr && t >= len[b]) {  // the state was held: pass through
#pragma unroll
        for (int k = 0; k < 4; ++k) dg[k * H] = 0.f;
        continue;
      }
      const float* pre = d.gates + (size_t)t * B * N + bn;
      const float i = sig(pre[0]), j = tanhf(pre[H]), f = sig(pre[2 * H] + 1.f);
      const float o = sig(pre[3 * H]);
      const float tc = tanhf(d.cs[(size_t)(t + 1) * B * H + bh]);
      const float dc = d.dc_acc[bh] + dh * o * (1.f - tc * tc);
      dg[0] = dc * j * (i * (1.f - i));
      dg[H] = dc * i * (1.f - j * j);
      dg[2 * H] = dc * d.cs[(size_t)t * B * H + bh] * (f * (1.f - f));
      dg[3 * H] = dh * tc * (o * (1.f - o));
      d.dc_acc[bh] = dc * f;
    }
  }
  cluster.sync();  // every block's tile outlives the others' reads
}

template <bool FWD, bool BF16>
const void* lstm_kernel(int tm) {
  if constexpr (FWD)
    return tm == 16 ? (const void*)lstm_fwd<16, BF16>
           : tm == 32 ? (const void*)lstm_fwd<32, BF16> : (const void*)lstm_fwd<64, BF16>;
  else
    return tm == 16 ? (const void*)lstm_bwd<16, BF16>
           : tm == 32 ? (const void*)lstm_bwd<32, BF16> : (const void*)lstm_bwd<64, BF16>;
}

// Shared memory of a launch (kernels/lstm.py::step_plan computes the same).
int lstm_smem(bool fwd, int tm, bool bf16) {
  return 4 * tm * kDN + dense_ring_bytes(tm, !fwd, true, bf16);
}

int run_lstm(bool fwd, const LstmDir* dirs, int n_dirs, const void* xrow, const void* lengths,
             int t, int T, int B, int H, int tile_rows, int smem, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || n_dirs < 1 || n_dirs > 2 || t >= T || t < (fwd ? 0 : -1) ||
      (fwd && H % kUnits != 0) || (tile_rows != 16 && tile_rows != 32 && tile_rows != 64) ||
      smem != lstm_smem(fwd, tile_rows, bf16 != 0) || smem > vae::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const void* fn = bf16 ? lstm_kernel<true, true>(tile_rows) : lstm_kernel<true, false>(tile_rows);
  if (!fwd) fn = bf16 ? lstm_kernel<false, true>(tile_rows) : lstm_kernel<false, false>(tile_rows);
  int per_sm = 0;
  cudaError_t e = vae::launch_info(fn, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  LstmArgs args = {};
  for (int k = 0; k < n_dirs; ++k) args.d[k] = dirs[k];
  args.xrow = static_cast<const float*>(xrow);
  args.lengths = static_cast<const int*>(lengths);
  args.t = t, args.T = T, args.B = B, args.H = H;
  const int cols = fwd ? 4 * H : H;
  const dim3 grid((B + tile_rows - 1) / tile_rows, (cols + kDN - 1) / kDN,
                  fwd ? n_dirs : 4 * n_dirs);
  void* kargs[] = {&args};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;  // backward: the four gates of a tile
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 4;
  cfg.attrs = &cluster;
  cfg.numAttrs = fwd ? 0 : 1;
  e = cudaLaunchKernelExC(&cfg, fn, kargs);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

// Step t of `n_dirs` LSTM directions (their LstmDir rows at `dirs`, a host
// array) over B rows of width H: lstm_fwd (t in [0, T)) or lstm_bwd (t in
// [-1, T)). `xrow` (direction 0's per-row addend) and `lengths` (int32 [B])
// may be null. `tile_rows` (16, 32 or 64) and `smem` are
// kernels/lstm.py::step_plan's. Launches on `stream` without synchronising
// and returns the launch's CUDA error.
extern "C" int vae_lstm_fwd(const void* dirs, int n_dirs, const void* xrow, const void* lengths,
                            int t, int T, int B, int H, int tile_rows, int smem, int bf16,
                            void* stream) {
  return run_lstm(true, static_cast<const LstmDir*>(dirs), n_dirs, xrow, lengths, t, T, B, H,
                  tile_rows, smem, bf16, stream);
}

extern "C" int vae_lstm_bwd(const void* dirs, int n_dirs, const void* lengths, int t, int T,
                            int B, int H, int tile_rows, int smem, int bf16, void* stream) {
  return run_lstm(false, static_cast<const LstmDir*>(dirs), n_dirs, nullptr, lengths, t, T, B, H,
                  tile_rows, smem, bf16, stream);
}
