// The block-tiled dense product of the megakernels and the stacks
// (conv_mega.cu's conv_enc and conv_dec, mega.cu's mega_fwd and
// mega_dec_loss_bwd, mlp_fwd.cu's mlp_stack_fwd, mlp_bwd.cu's stack_bwd):
// y = A . B over the TM rows a block owns (TM = 16, 32 or 64, multiples of
// the mma m16), handed to an epilogue functor as epi(row, column, y) for
// columns < N; and softplus_stack, the forward of a softplus stack over
// the block's rows on that product (the forward kernels' hidden layers and
// the backward kernels' rematerialized forward).
//
// What bounds it. The weights (up to 6.27 MB) stream from L2, so the weight
// bytes read per row are what a row tile saves: every weight byte a block
// reads serves all TM rows. fp32: FFMA throughput (TM / 8 x 4 register
// tiles, conflict-free 16-byte shared loads). bf16: mma.sync.m16n8k16 fed
// by ldmatrix finishes a slice long before the next arrives, so the weight
// slices each block streams from L2 bound it; where a small batch leaves
// SMs idle, blocks that share rows (a cluster) split the column tiles
// (kernels/mlp.py::dense_parts).
//
// - Tiles of TM rows x 128 columns, in order; each over slices of KD k
//   (dense_kd), streamed through a ring of 3 shared-memory stages by
//   cp.async (through L2), so two slices are in flight while one multiplies.
// - B is the weight W [K, N] (row-major, the forward) or, with TRANS, W^T
//   for a W [N, K] (the backward's da . W^T reads the forward's tensor as
//   it is: no transposed copy). The slice is staged as it lies: [k][n] or
//   [n][k]. fp32 reads [n][k] with 16-byte loads along k (columns cg + 32 q,
//   conflict-free); bf16 reads it with ldmatrix without .trans.
// - A is resident in shared memory ([TM][lda], columns past K zero; fp32
//   or bf16), or, with STREAM, streamed from device memory slice by slice
//   beside the weight: the rows of a saved output this block wrote before a
//   barrier (cp.async reads L2, where those writes are). Rows past `rows`
//   and columns past K are zero-filled. A 64-row A is up to 3136 wide
//   (803 KB in fp32): it does not fit in shared memory.
// - bf16: each thread rounds the values it copied into a double-buffered
//   bf16 slice (the reference's operand rounding); the products add in
//   fp32. Each output adds its k in order, one slice after the other, so the
//   same inputs give the same bits.

#pragma once

#include "common.cuh"

namespace {

using vae::kThreads;

constexpr int kDN = 128;       // output columns per tile
constexpr int kDStages = 3;    // slices in the cp.async ring
constexpr int kLdB = kDN + 4;  // fp32 [k][n] weight row
constexpr int kLdBh = kDN + 8; // bf16 [k][n] row: 272 B, ldmatrix conflict-free

__host__ __device__ constexpr int pad32(int n) { return (n + 31) / 32 * 32; }

// k per staged slice: 32 at 64 rows (the ring then fits two blocks an SM),
// 64 at 16 and 32 rows, where a slice multiplies too briefly to cover the
// fixed latency of its wait, barrier and rounding: half as many slices.
__host__ __device__ constexpr int dense_kd(int tm) { return tm == 64 ? 32 : 64; }

// Floats of one ring stage (the weight slice, then the A slice) and bf16
// values of one rounded slice; rows of a k-contiguous slice ([row][k],
// [n][k]) are kd + 4 floats (kd + 8 bf16: 16 B times an odd number, so
// ldmatrix is conflict-free).
__host__ __device__ constexpr int dense_stage_w(int kd, bool trans) {
  return trans ? kDN * (kd + 4) : kd * kLdB;
}
__host__ __device__ constexpr int dense_stage_a(int tm, int kd, bool stream) {
  return stream ? tm * (kd + 4) : 0;
}
__host__ __device__ constexpr int dense_half_w(int kd, bool trans) {
  return trans ? kDN * (kd + 8) : kd * kLdBh;
}
__host__ __device__ constexpr int dense_half_a(int tm, int kd, bool stream) {
  return stream ? tm * (kd + 8) : 0;
}

// Shared memory of the ring (and, in bf16, the two rounded slices) for a
// product mode (kernels/mlp.py::dense_ring_bytes).
__host__ __device__ constexpr int dense_ring_bytes(int tm, bool trans, bool stream, bool bf16) {
  return 4 * kDStages * (dense_stage_w(dense_kd(tm), trans) +
                         dense_stage_a(tm, dense_kd(tm), stream)) +
         (bf16 ? 2 * 2 * (dense_half_w(dense_kd(tm), trans) +
                          dense_half_a(tm, dense_kd(tm), stream))
               : 0);
}

// The accumulators of a thread's share of a TM x 128 tile. fp32: rows
// rg + 8 i (i < TM / 8) by 4 columns (4 cg ...; with TRANS cg + 32 q),
// rg = lane % 8, cg = 4 warp + lane / 8, so a warp's loads of A cover 8
// rows and its loads of B 4 column groups, each on distinct banks: 4 + TM /
// 8 16-byte loads per 16 TM / 8 FMAs. bf16: warp (wm, wn) owns MT x NT mma
// tiles, rows 16 MT wm ..., columns 8 NT wn ...
template <int TM, bool BF16>
struct DenseAcc {
  static constexpr int RT = TM / 8;
  float v[RT][4];
};
template <int TM>
struct DenseAcc<TM, true> {
  static constexpr int MT = TM >= 32 ? 2 : 1;  // 16-row mma tiles per warp
  static constexpr int WM = TM / (16 * MT);    // warps along the rows
  static constexpr int WN = 8 / WM;            // warps along the columns
  static constexpr int NT = kDN / WN / 8;      // 8-column mma tiles per warp
  float v[MT][NT][4];
};

// This thread's index among the threads whose epilogue calls see a given
// row, the same for every row it sees (< 32; fewer threads share a row in
// bf16 at 64 rows): fp32 its column group cg, bf16 4 wn + lane % 4. A sum
// over a row's columns (mega_fwd's loss) keeps one partial per (row, peer)
// and adds them in peer order: one order, the same bits on every call.
template <int TM, bool BF16>
__device__ __forceinline__ int dense_row_peer() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (BF16)
    return 4 * (warp % DenseAcc<TM, true>::WN) + (lane & 3);
  else
    return 4 * warp + (lane >> 3);
}

// softplus'(pre) = sigmoid(pre) from the post-activation g = softplus(pre):
// 1 - e^{-g}, as -expm1(-g) (exact where g is small). The backward kernels
// keep g for the weight gradients and no pre-activation.
__device__ __forceinline__ float dsoftplus(float g) { return -expm1f(-g); }

// The blocks of a cluster wait for each other's writes (release, then
// acquire at cluster scope); the barrier also spans each block's threads.
// Blocks that share a row tile (each taking every other column tile) meet
// here between products.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The product over the block's TM rows; see the top of this file. a, lda:
// the resident fp32 A (or ah, the resident bf16 A) in shared memory; with
// STREAM, a is this block's first row of A in device memory (row stride
// lda) and `rows` its valid rows. W: [K, N], or [N, K] with TRANS. `ring`
// holds dense_ring_bytes(TM, TRANS, STREAM, BF16). The block computes the
// column tiles part, part + parts, ... (blocks that share rows split the
// tiles). Ends with a barrier.
template <int TM, bool BF16, bool TRANS, bool STREAM, class Epi>
__device__ void dense_rows(const float* a, const __nv_bfloat16* ah, int lda, int rows,
                           const float* __restrict__ W, int K, int N, float* ring,
                           Epi& epi, int part = 0, int parts = 1) {
  static_assert(TM == 16 || TM == 32 || TM == 64, "rows per block");
  constexpr int S = kDStages, KD = dense_kd(TM);
  constexpr int kLdK = KD + 4, kLdKh = KD + 8;  // k-contiguous rows, fp32 and bf16
  constexpr int kW = dense_stage_w(KD, TRANS), kStage = kW + dense_stage_a(TM, KD, STREAM);
  constexpr int kWh = dense_half_w(KD, TRANS), kHalf = kWh + dense_half_a(TM, KD, STREAM);
  constexpr int TPR = KD / 4, kRowsPass = kThreads / TPR;  // threads a k-contiguous row
  auto* half = reinterpret_cast<__nv_bfloat16*>(ring + S * kStage);  // [2][kHalf]
  const int ks = (K + KD - 1) / KD;
  const int total = ks * (((N + kDN - 1) / kDN - part + parts - 1) / parts);
  const int wld = TRANS ? K : N;  // W's row length
  const bool wvec = wld % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  const bool avec = STREAM && lda % 4 == 0 && K % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Copy slots: [k][n] rows t / 32 + 8 i, columns 4 (t % 32); [n][k] and
  // A rows t / TPR + kRowsPass i, k 4 (t % TPR).
  const int col = 4 * lane, kc = 4 * (threadIdx.x % TPR), r0 = threadIdx.x / TPR;
  auto issue = [&](int j) {
    if (j < total) {
      const int n0 = (part + parts * (j / ks)) * kDN, k0 = (j % ks) * KD;
      float* st = ring + (j % S) * kStage;
      if constexpr (TRANS) {
#pragma unroll
        for (int i = 0; i < kDN / kRowsPass; ++i) {
          const int n = r0 + kRowsPass * i;
          vae::copy4(st + n * kLdK + kc, W, K, n0 + n, k0 + kc, K, wvec, n0 + n < N);
        }
      } else {
#pragma unroll
        for (int i = 0; i < KD / 8; ++i) {
          const int r = warp + 8 * i;
          vae::copy4(st + r * kLdB + col, W, N, k0 + r, n0 + col, N, wvec, k0 + r < K);
        }
      }
      if constexpr (STREAM) {
#pragma unroll
        for (int i = 0; i < (TM + kRowsPass - 1) / kRowsPass; ++i) {
          const int r = r0 + kRowsPass * i;
          if (r < TM)
            vae::copy4(st + kW + r * kLdK + kc, a, lda, r, k0 + kc, K, avec, r < rows);
        }
      }
    }
    vae::cp_async_commit();  // empty past the last slice: uniform counts
  };
  for (int j = 0; j < S - 1; ++j) issue(j);
  DenseAcc<TM, BF16> acc;
  for (int j = 0; j < total; ++j) {
    vae::cp_async_wait<S - 2>();
    const float* st = ring + (j % S) * kStage;
    __nv_bfloat16* hs = half + (j & 1) * kHalf;
    if constexpr (BF16) {  // the values this thread copied, rounded
      if constexpr (TRANS) {
#pragma unroll
        for (int i = 0; i < kDN / kRowsPass; ++i) {
          const int n = r0 + kRowsPass * i;
          *reinterpret_cast<uint2*>(hs + n * kLdKh + kc) =
              vae::pack_bf16x4(*reinterpret_cast<const float4*>(st + n * kLdK + kc));
        }
      } else {
#pragma unroll
        for (int i = 0; i < KD / 8; ++i) {
          const int r = warp + 8 * i;
          *reinterpret_cast<uint2*>(hs + r * kLdBh + col) =
              vae::pack_bf16x4(*reinterpret_cast<const float4*>(st + r * kLdB + col));
        }
      }
      if constexpr (STREAM) {
#pragma unroll
        for (int i = 0; i < (TM + kRowsPass - 1) / kRowsPass; ++i) {
          const int r = r0 + kRowsPass * i;
          if (r < TM)
            *reinterpret_cast<uint2*>(hs + kWh + r * kLdKh + kc) =
                vae::pack_bf16x4(*reinterpret_cast<const float4*>(st + kW + r * kLdK + kc));
        }
      }
    }
    __syncthreads();  // slice j is whole; slice j - 1 is consumed
    issue(j + S - 1);
    const int kk = j % ks, k0 = kk * KD, n0 = (part + parts * (j / ks)) * kDN;
    if (kk == 0) acc = DenseAcc<TM, BF16>{};
    if constexpr (BF16) {
      using Acc = DenseAcc<TM, true>;
      constexpr int MT = Acc::MT, NT = Acc::NT, WN = Acc::WN;
      const int wm = warp / WN, wn = warp % WN;
      const __nv_bfloat16* A = STREAM ? hs + kWh : ah;
      const int ldA = STREAM ? kLdKh : lda, ak = STREAM ? 0 : k0;
#pragma unroll
      for (int k16 = 0; k16 < KD; k16 += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          vae::ldmatrix_x4(af[mt], A + (16 * MT * wm + 16 * mt + (lane & 15)) * ldA + ak +
                                       k16 + (lane >> 4) * 8);
        uint32_t bf[NT][2];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          if constexpr (TRANS)
            vae::ldmatrix_x4(r, hs + (8 * NT * wn + 16 * np + (lane & 7) + (lane >> 4) * 8) *
                                         kLdKh + k16 + ((lane >> 3) & 1) * 8);
          else
            vae::ldmatrix_x4_trans(r, hs + (k16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLdBh +
                                          8 * NT * wn + 16 * np + (lane >> 4) * 8);
          bf[2 * np][0] = r[0], bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2], bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            vae::mma_bf16(acc.v[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
      }
      if (kk == ks - 1) {
        const int g = lane >> 2, cq = lane & 3;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = n0 + 8 * NT * wn + 8 * nt + 2 * cq + e;
                if (n < N) epi(16 * MT * wm + 16 * mt + g + 8 * hh, n, acc.v[mt][nt][2 * hh + e]);
              }
      }
    } else {
      constexpr int RT = TM / 8;
      const int rg = lane & 7, cg = 4 * warp + (lane >> 3);
      const float* A = STREAM ? st + kW : a;
      const int ldA = STREAM ? kLdK : lda, ak = STREAM ? 0 : k0;
#pragma unroll 2
      for (int k = 0; k < KD; k += 4) {
        float4 av[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          av[i] = *reinterpret_cast<const float4*>(A + (rg + 8 * i) * ldA + ak + k);
        if constexpr (TRANS) {
          float4 bq[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bq[q] = *reinterpret_cast<const float4*>(st + (cg + 32 * q) * kLdK + k);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int i = 0; i < RT; ++i)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc.v[i][q] = fmaf(lane_of(av[i], jj), lane_of(bq[q], jj), acc.v[i][q]);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 b = *reinterpret_cast<const float4*>(st + (k + jj) * kLdB + 4 * cg);
#pragma unroll
            for (int i = 0; i < RT; ++i)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc.v[i][q] = fmaf(lane_of(av[i], jj), lane_of(b, q), acc.v[i][q]);
          }
        }
      }
      if (kk == ks - 1) {
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int n = n0 + (TRANS ? cg + 32 * q : 4 * cg + q);
            if (n < N) epi(rg + 8 * i, n, acc.v[i][q]);
          }
      }
    }
  }
  vae::cp_async_wait<0>();
  __syncthreads();
}

// Where a softplus layer's output goes: W [k, n] (row-major), b [n], and
// the block's first row of the output (row stride ld).
struct StackLayer {
  const float* w;
  const float* b;
  float* out;
  int n;
  int ld;
};

// The forward of a softplus stack over the block's rows: h_{i+1} =
// softplus(h_i W_i + b_i) for i < n_layers, h_0 = a (the block's first
// row, row stride lda, k wide), layer(i) giving layer i's StackLayer. Each
// product streams its A from what the last one wrote (or from a); blocks
// that share the rows meet at a cluster barrier before each layer but the
// first (a caller whose a another part wrote meets them before the call).
template <int TM, bool BF16, class Layers>
__device__ void softplus_stack(const float* a, int lda, int k, int n_layers, Layers layer,
                               int rows, float* ring, int part, int parts) {
  for (int i = 0; i < n_layers; ++i) {
    const StackLayer L = layer(i);
    auto epi = [&](int r, int j, float y) {
      if (r < rows) L.out[(size_t)r * L.ld + j] = vae::softplus(y + __ldg(L.b + j));
    };
    if (i > 0 && parts > 1) cluster_sync();
    dense_rows<TM, BF16, false, true>(a, nullptr, lda, rows, L.w, k, L.n, ring, epi, part,
                                      parts);
    a = L.out;
    lda = L.ld;
    k = L.n;
  }
}

}  // namespace
