// The conv image tower's forward megakernels, on Hopper (sm_90a): the whole
// encoder, and the whole decoder with its per-row loss, one launch each.
//
// conv_enc replaces the Pallas TPU kernel
// vae_assoc_tpu/kernels/conv_mega.py::_enc_kernel: per row tile,
//   x [28, 28] -> conv1 3x3 s2 + b -> softplus -> a1 [14, 14, 32]
//   -> conv2 3x3 s2 + b -> softplus -> a2 [7, 7, 64] -> flatten (h, w, c)
//   -> dense + b -> softplus -> h [hr] -> heads mu, logvar [n_z].
// conv_dec replaces ::_dec_kernel:
//   z -> dense1 + softplus -> g1 [hg] -> dense2 + softplus -> g2 [7, 7, 64]
//   -> transposed conv 3x3 s2 + b -> softplus -> d1p [14, 14, 32]
//   -> transposed conv 3x3 s2 + b -> logits r [28, 28]
//   -> recon = sum of the per-element Bernoulli logit CE or Gaussian SSE.
// Both write the activations the backward needs (a1, a2, h; g1, g2, d1p, r)
// in NHWC, as the reference saves them; rows past the batch write nothing.
// The backward is torch and the two kernels of conv.cu, as the reference's
// is XLA (kernels/conv_mega.py).
//
// What bounds them on this card. Per row each direction does about 2.55 M
// multiply-adds (the 3136 x 500 dense layer 1.57 M, the 32 -> 64 channel
// conv 0.9 M) against 3-13 KB of input and 42-48 KB of saved activations:
// fp32 FMAs bound them (1.24 ms at B = 16384 and 67 TFLOP/s); in bf16 on
// tensor cores the bytes do (0.23 ms for conv_dec). The dense weights
// (6.27 MB each) stream from L2, so weight reuse per L2 read is the rows a
// block owns.
//
// conv_enc, one thread per output and 8-row tiles.
// - A block owns TM <= 8 rows (kernels/conv_mega.py sizes TM with
//   kernels/mlp.py::rows_plan). a1, a saved output anyway, is staged
//   through device memory (written, then read back from L1/L2 by the same
//   block after a barrier); shared memory holds x, a2 and h.
// - Convs: one thread per output (channel fastest, so a warp shares one
//   pixel: its activation reads broadcast and its weight reads coalesce).
// - Dense layers: one thread per output column for all TM rows; weights
//   read once per block from L2 (mlp_fwd.cu's inner loop with runtime TM).
// - With bf16 both operands of every product are rounded to bf16 and the
//   products add in fp32.
//
// conv_dec. A block owns 64 rows (kDecTM) and runs the stages in turn.
// - dense1 and dense2 are block-tiled products (dense_rows): 64 rows x 128
//   columns at a time, the weight streamed in slices of 32 rows through a
//   3-stage cp.async ring in shared memory, so each weight byte serves all
//   64 rows (1.6 GB of L2 reads at B = 16384, where 8-row tiles read
//   12.8). fp32: 4 x 8 register tiles; bf16: mma.sync fed by
//   ldmatrix (activations) and ldmatrix.trans (the weight slice). g1 stays
//   in shared memory as dense2's operand.
// - g2 for 64 rows (803 KB) does not fit in shared memory, so it goes to
//   device memory (a saved output anyway) and convt1 reads it back, as
//   convt2 does d1p: the phase plan's 4 parity classes of the undilated
//   g2, each class's weight rows staged in shared memory, conv_fwd's tile
//   products (conv_tile.cuh: fp32 register tiles, bf16 mma.sync) fed by a
//   cp.async ring, with a bias + softplus epilogue.
// - convt2 (cout = 1) and the loss, image by image (convt2_loss): the 9
//   tap dots of each d1p pixel, then each logit as the sum of its class's
//   taps, its loss element into the row's sum; no second pass over r.
// - Geometry is fixed (28 x 28, 32 and 64 channels); hg and n_z are
//   runtime arguments (z and g1 padded to 32 columns).

#include <algorithm>
#include <type_traits>

#include "conv_tile.cuh"

namespace {

constexpr int kImg = 28, kMid = 14, kSmall = 7, kC1 = 32, kC2 = 64;
constexpr int kPix = kImg * kImg;                // 784
constexpr int kMidFlat = kMid * kMid * kC1;      // 6272
constexpr int kFlat = kSmall * kSmall * kC2;     // 3136
constexpr int kMaxTM = 8;

// y[r, j] = act[r, :] . W[:, j] + b[j] for r < tm rows of act [tm, stride]
// in shared memory (16-byte aligned rows); W [n_in, n_out] row-major from
// device memory. Hands y to epi(r, j, y).
template <class Epi>
__device__ void dense(const float* act, int stride, const float* __restrict__ W,
                      const float* __restrict__ b, int n_in, int n_out, int tm,
                      int bf16, Epi& epi) {
  const int k4 = n_in & ~3;
  for (int j = threadIdx.x; j < n_out; j += kThreads) {
    float acc[kMaxTM];
#pragma unroll
    for (int r = 0; r < kMaxTM; ++r) acc[r] = 0.f;
    const float* wj = W + j;
    for (int k = 0; k < k4; k += 4) {
      const float w0 = rnd(__ldg(wj + (size_t)(k + 0) * n_out), bf16);
      const float w1 = rnd(__ldg(wj + (size_t)(k + 1) * n_out), bf16);
      const float w2 = rnd(__ldg(wj + (size_t)(k + 2) * n_out), bf16);
      const float w3 = rnd(__ldg(wj + (size_t)(k + 3) * n_out), bf16);
#pragma unroll
      for (int r = 0; r < kMaxTM; ++r) {
        if (r < tm) {
          const float4 a = *reinterpret_cast<const float4*>(act + r * stride + k);
          acc[r] = fmaf(a.x, w0, acc[r]);
          acc[r] = fmaf(a.y, w1, acc[r]);
          acc[r] = fmaf(a.z, w2, acc[r]);
          acc[r] = fmaf(a.w, w3, acc[r]);
        }
      }
    }
    for (int k = k4; k < n_in; ++k) {
      const float w = rnd(__ldg(wj + (size_t)k * n_out), bf16);
#pragma unroll
      for (int r = 0; r < kMaxTM; ++r)
        if (r < tm) acc[r] = fmaf(act[r * stride + k], w, acc[r]);
    }
    const float bj = __ldg(b + j);
#pragma unroll
    for (int r = 0; r < kMaxTM; ++r)
      if (r < tm) epi(r, j, acc[r] + bj);
  }
}

struct EncWeights {
  const float *w1, *b1, *w2, *b2, *wd, *bd, *wm, *bm, *wl, *bl;
};

// a1 is written and read back by the same block: a plain pointer, so its
// reads go through the coherent path after the barrier.
__global__ void __launch_bounds__(kThreads)
    conv_enc(const float* __restrict__ x, int batch, EncWeights wt, int hr,
             int n_z, int tm, int hstride, int bf16, float* __restrict__ mu,
             float* __restrict__ lv, float* a1, float* __restrict__ a2,
             float* __restrict__ h) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [tm, 784], rounded
  float* a2s = xs + tm * kPix;    // [tm, 3136], rounded
  float* hs = a2s + tm * kFlat;   // [tm, hstride], rounded
  const int row0 = blockIdx.x * tm;
  const int valid = min(tm, batch - row0);

  for (int i = threadIdx.x; i < tm * kPix; i += kThreads) {
    const int r = i / kPix;
    xs[i] = r < valid ? rnd(x[(size_t)row0 * kPix + i], bf16) : 0.f;
  }
  __syncthreads();

  // conv1: pads (0, 1), so taps at row or column 28 are zero.
  for (int o = threadIdx.x; o < valid * kMidFlat; o += kThreads) {
    const int co = o % kC1;
    const int pix = o / kC1;
    const int r = pix / (kMid * kMid);
    const int p = pix - r * kMid * kMid;
    const int oy = p / kMid, ox = p - (p / kMid) * kMid;
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int iy = 2 * oy + ky;
      if (iy >= kImg) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int ix = 2 * ox + kx;
        if (ix >= kImg) continue;
        acc = fmaf(xs[r * kPix + iy * kImg + ix],
                   rnd(__ldg(wt.w1 + (ky * 3 + kx) * kC1 + co), bf16), acc);
      }
    }
    a1[(size_t)row0 * kMidFlat + o] = vae::softplus(acc + __ldg(wt.b1 + co));
  }
  __syncthreads();

  // conv2 over a1 (device memory, written above by this block).
  for (int o = threadIdx.x; o < tm * kFlat; o += kThreads) {
    const int co = o % kC2;
    const int pix = o / kC2;
    const int r = pix / (kSmall * kSmall);
    const int p = pix - r * kSmall * kSmall;
    float v = 0.f;
    if (r < valid) {
      const int oy = p / kSmall, ox = p - (p / kSmall) * kSmall;
      const float* src = a1 + (size_t)(row0 + r) * kMidFlat;
      float acc = 0.f;
      for (int ky = 0; ky < 3; ++ky) {
        const int iy = 2 * oy + ky;
        if (iy >= kMid) continue;
        for (int kx = 0; kx < 3; ++kx) {
          const int ix = 2 * ox + kx;
          if (ix >= kMid) continue;
          const float* a = src + (iy * kMid + ix) * kC1;
          const float* wk = wt.w2 + (ky * 3 + kx) * kC1 * kC2 + co;
#pragma unroll 8
          for (int c = 0; c < kC1; ++c)
            acc = fmaf(rnd(a[c], bf16), rnd(__ldg(wk + c * kC2), bf16), acc);
        }
      }
      v = vae::softplus(acc + __ldg(wt.b2 + co));
      a2[(size_t)row0 * kFlat + o] = v;
    }
    a2s[o] = rnd(v, bf16);
  }
  __syncthreads();

  auto to_h = [&](int r, int j, float y) {
    const float v = vae::softplus(y);
    hs[r * hstride + j] = rnd(v, bf16);
    if (r < valid) h[(size_t)(row0 + r) * hr + j] = v;
  };
  dense(a2s, kFlat, wt.wd, wt.bd, kFlat, hr, tm, bf16, to_h);
  __syncthreads();
  auto to_mu = [&](int r, int j, float y) {
    if (r < valid) mu[(size_t)(row0 + r) * n_z + j] = y;
  };
  dense(hs, hstride, wt.wm, wt.bm, hr, n_z, tm, bf16, to_mu);
  auto to_lv = [&](int r, int j, float y) {
    if (r < valid) lv[(size_t)(row0 + r) * n_z + j] = y;
  };
  dense(hs, hstride, wt.wl, wt.bl, hr, n_z, tm, bf16, to_lv);
}

struct DecWeights {
  const float *d1, *c1, *d2, *c2, *wt1, *bt1, *wt2, *bt2;
};

// ---- conv_dec ----

constexpr int kDecTM = 64;             // rows per block
constexpr int kDK = 32;                // weight rows per staged slice
constexpr int kDN = 128;               // output columns per tile
constexpr int kDStages = 3;            // slices in the cp.async ring
constexpr int kLdB = kDN + 4;          // fp32 ring row
constexpr int kLdBh = kDN + 8;         // bf16 slice row: 272 B, ldmatrix conflict-free
constexpr int kLdAT = kDecTM + 4;      // fp32 activations, transposed [k][row]
constexpr int kRingF = kDStages * kDK * kLdB;  // floats
constexpr int kHalfH = 2 * kDK * kLdBh;        // bf16 values

__host__ __device__ constexpr int pad32(int n) { return (n + 31) / 32 * 32; }

// Shared memory of the dense stages (kernels/conv_mega.py::dec_plan): the
// staged z and g1 (fp32 transposed [k][row]; bf16 [row][k + 8]), the
// weight ring and, in bf16, the rounded slices. The convs reuse it.
__host__ __device__ constexpr int dec_dense_smem(int n_z, int hg, bool bf16) {
  return bf16 ? 2 * kDecTM * (pad32(n_z) + 8 + pad32(hg) + 8) + 4 * kRingF + 2 * kHalfH
              : 4 * kLdAT * (pad32(n_z) + pad32(hg)) + 4 * kRingF;
}

// The fp32 product's share of a 64 x 128 tile: thread (tm, tn) owns rows
// 4 tm ... and columns 4 tn ... and 64 + 4 tn ...; the bf16 one's warp
// (wm, wn) rows 32 wm ... and columns 32 wn ... (2 x 4 mma tiles).
template <bool BF16>
struct DenseAcc {
  float v[4][8];
};
template <>
struct DenseAcc<true> {
  float v[2][4][4];
};

// One dense layer over the block's rows, act [64, K] . W [K, N] from
// device memory: tiles of 128 columns in order, each over slices of 32
// weight rows streamed through a ring of kDStages shared-memory stages by
// cp.async (thread t copies rows t / 32 + 8 i, columns 4 (t % 32) ...), so
// each weight byte is read once a block and serves all 64 rows. fp32:
// actT [pad32(K)][kLdAT], rows past K zero; register-tiled FFMA. bf16:
// act [64][lda], columns past K zero; each thread rounds the values it
// copied into a double-buffered bf16 slice and the product runs on
// mma.sync (A by ldmatrix, the weight slice by ldmatrix.trans). Hands each
// sum to epi(row, column, y) for columns < N; ends with a barrier.
template <bool BF16, class Epi>
__device__ void dense_rows(const float* actT, const __nv_bfloat16* act, int lda,
                           const float* __restrict__ W, int K, int N,
                           float* ring, __nv_bfloat16* half, Epi& epi) {
  constexpr int S = kDStages;
  const int ks = (K + kDK - 1) / kDK;
  const int total = ks * ((N + kDN - 1) / kDN);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  const int col = 4 * (threadIdx.x & 31);
  auto issue = [&](int j) {
    if (j < total) {
      const int n0 = (j / ks) * kDN, k0 = (j % ks) * kDK;
      float* st = ring + (j % S) * kDK * kLdB;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (threadIdx.x >> 5) + 8 * i;
        vae::copy4(st + r * kLdB + col, W, N, k0 + r, n0 + col, N, vec, k0 + r < K);
      }
    }
    vae::cp_async_commit();  // empty past the last slice: uniform counts
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < S - 1; ++j) issue(j);
  DenseAcc<BF16> acc;
  for (int j = 0; j < total; ++j) {
    vae::cp_async_wait<S - 2>();
    const float* st = ring + (j % S) * kDK * kLdB;
    __nv_bfloat16* hs = half + (j & 1) * kDK * kLdBh;
    if constexpr (BF16) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (threadIdx.x >> 5) + 8 * i;
        *reinterpret_cast<uint2*>(hs + r * kLdBh + col) =
            vae::pack_bf16x4(*reinterpret_cast<const float4*>(st + r * kLdB + col));
      }
    }
    __syncthreads();  // slice j is whole; slice j - 1 is consumed
    issue(j + S - 1);
    const int kk = j % ks, k0 = kk * kDK, n0 = (j / ks) * kDN;
    if (kk == 0) acc = DenseAcc<BF16>{};
    if constexpr (BF16) {
      const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
      for (int k16 = 0; k16 < kDK; k16 += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          vae::ldmatrix_x4(af[mt], act + (32 * wm + 16 * mt + (lane & 15)) * lda +
                                       k0 + k16 + (lane >> 4) * 8);
        uint32_t bf[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          vae::ldmatrix_x4_trans(
              r, hs + (k16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLdBh + 32 * wn +
                     16 * np + (lane >> 4) * 8);
          bf[2 * np][0] = r[0], bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2], bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            vae::mma_bf16(acc.v[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
      }
      if (kk == ks - 1) {
        const int g = lane >> 2, cq = lane & 3;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = n0 + 32 * wn + 8 * nt + 2 * cq + e;
                if (n < N) epi(32 * wm + 16 * mt + g + 8 * hh, n, acc.v[mt][nt][2 * hh + e]);
              }
      }
    } else {
      const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll 4
      for (int k = 0; k < kDK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(actT + (k0 + k) * kLdAT + 4 * tm);
        const float4 b0 = *reinterpret_cast<const float4*>(st + k * kLdB + 4 * tn);
        const float4 b1 = *reinterpret_cast<const float4*>(st + k * kLdB + 64 + 4 * tn);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc.v[i][q] = fmaf(av[i], bv[q], acc.v[i][q]);
      }
      if (kk == ks - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int n = n0 + (q < 4 ? 4 * tn + q : 64 + 4 * tn + q - 4);
            if (n < N) epi(4 * tm + i, n, acc.v[i][q]);
          }
      }
    }
  }
  vae::cp_async_wait<0>();
  __syncthreads();
}

// convt1's epilogue: bias, softplus, into d1p.
struct SoftplusOut {
  float* y;
  const float* b;
  __device__ void operator()(int4 r, int c, float4 v) const {
    *reinterpret_cast<float4*>(y + r.w + c) =
        make_float4(vae::softplus(v.x + __ldg(b + c)), vae::softplus(v.y + __ldg(b + c + 1)),
                    vae::softplus(v.z + __ldg(b + c + 2)), vae::softplus(v.w + __ldg(b + c + 3)));
  }
  __device__ void operator()(int4 r, int c, float2 v) const {
    *reinterpret_cast<float2*>(y + r.w + c) =
        make_float2(vae::softplus(v.x + __ldg(b + c)), vae::softplus(v.y + __ldg(b + c + 1)));
  }
};

constexpr int kCStages = 3;  // slices in convt1's cp.async ring

// Shared memory of convt1 (convt1_class) for its largest class, 4 taps x
// 64 channels: the ring, the tile's pixel rows per tile parity and the
// class's weight rows (bf16: [32][256 + 8], and two rounded slices).
__host__ __device__ constexpr int dec_conv_smem(bool bf16) {
  return bf16 ? 4 * kCStages * kMmaTile * kLdF + 2 * 16 * kMmaTile +
                    2 * kC1 * (4 * kC2 + 8) + 2 * 2 * kMmaTile * kLdH
              : 4 * kCStages * kFfmaTile * kLdF + 2 * 16 * kFfmaTile + 4 * 4 * kC2 * kC1;
}

// convt1 (g2 [7, 7, 64] -> d1p [14, 14, 32]) over parity class k of the
// block's rows: conv_fwd's tiled product (the class's weight rows staged
// once; tiles of 256 pixels in fp32, 128 in bf16; slices of 32 patch
// columns, one tap and 32 channels, multiplied by conv_tile.cuh's mac_ffma
// or mac_mma), but its slices stream through a ring of kCStages stages
// filled by cp.async through L2, where this block's g2 is: thread t copies
// pixels t / 8 + 32 i, channels 4 (t % 8) ... of the slice's tap (one
// address and bounds check per (pixel, tap), zero-filled outside the
// image), so two slices are in
// flight while one multiplies, where registers held one; in bf16 each
// thread rounds what it copied into a double-buffered bf16 slice. A
// tile's pixel rows are computed when its first slice is issued, kept per
// tile parity. Hands the tile's sums to epi as ffma_class / mma_class do.
template <bool BF16, class Epi>
__device__ void convt1_class(const Fwd& f, const PhasePlan& p, const Cls& k,
                             unsigned char* smem, Epi& epi) {
  constexpr int T = BF16 ? kMmaTile : kFfmaTile;
  constexpr int NV = T / 32;
  constexpr int kSlot = T * kLdF;
  const int K = k.nt * f.cin;
  const int nst = K / kStageK;  // >= 2: 64 channels a tap
  const int total = ((k.mc + T - 1) / T) * nst;
  auto* ring = reinterpret_cast<float*>(smem);          // [kCStages][T][kLdF]
  int4* rows = reinterpret_cast<int4*>(ring + kCStages * kSlot);  // [2][T]
  float* ws = reinterpret_cast<float*>(rows + 2 * T);   // fp32: [K][32]
  auto* wt = reinterpret_cast<__nv_bfloat16*>(rows + 2 * T);  // bf16: [32][K + 8]
  __nv_bfloat16* half = wt + kC1 * (K + 8);             // bf16: [2][T][kLdH]
  const int ldw = K + 8;
  for (int i = threadIdx.x; i < K * kC1; i += kThreads) {
    const int kk = i / kC1, n = i - kk * kC1;
    const float v = weight_row(f, p, k.t0 * f.cin + kk)[n];
    if constexpr (BF16)
      wt[n * ldw + kk] = __float2bfloat16(v);
    else
      ws[i] = v;
  }
  const int c4 = 4 * (threadIdx.x & 7);
  auto issue = [&](int j) {
    if (j < total) {
      const int tile = j / nst, s = j - tile * nst;
      int4* rw = rows + (tile & 1) * T;
      if (s == 0) {  // uniform: every thread issues the same j
        for (int i = threadIdx.x; i < T; i += kThreads)
          rw[i] = pixel_row(f, p, k, tile * T + i);
        __syncthreads();
      }
      const int per_tap = f.cin / kStageK;
      const int t = s / per_tap, cb = (s - t * per_tap) * kStageK + c4;
      float* st = ring + (j % kCStages) * kSlot;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int px = (threadIdx.x >> 3) + 32 * i;
        const float* xp = tap_ptr(f, p, rw[px], k.t0 + t);
        vae::cp_async16(st + px * kLdF + c4, xp != nullptr ? xp + cb : f.x,
                        xp != nullptr);
      }
    }
    vae::cp_async_commit();  // empty past the last slice: uniform counts
  };
  __syncthreads();  // the weight is staged
  for (int j = 0; j < kCStages - 1; ++j) issue(j);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tn = threadIdx.x & 7, tm = threadIdx.x >> 3;
  std::conditional_t<BF16, float[2][kC1 / 16][4], float[8][kC1 / 8]> acc;
  for (int j = 0; j < total; ++j) {
    const int tile = j / nst, s = j - tile * nst;
    vae::cp_async_wait<kCStages - 2>();
    const float* st = ring + (j % kCStages) * kSlot;
    __nv_bfloat16* hs = half + (j & 1) * T * kLdH;
    if constexpr (BF16) {  // the values this thread copied, rounded
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int px = (threadIdx.x >> 3) + 32 * i;
        *reinterpret_cast<uint2*>(hs + px * kLdH + c4) =
            vae::pack_bf16x4(*reinterpret_cast<const float4*>(st + px * kLdF + c4));
      }
    }
    __syncthreads();  // slice j is whole; slice j - 1 is consumed
    issue(j + kCStages - 1);
    if (s == 0) {
      if constexpr (BF16) {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < kC1 / 16; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
      } else {
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < kC1 / 8; ++b) acc[a][b] = 0.f;
      }
    }
    if constexpr (BF16)
      mac_mma<kC1>(hs, wt, ldw, s * kStageK, acc);
    else
      mac_ffma<kC1 / 8>(st, ws + s * kStageK * kC1, tm, tn, acc);
    if (s == nst - 1) {
      const int4* rw = rows + (tile & 1) * T;
      if constexpr (BF16) {
        const int g = lane >> 2, cq = lane & 3, wm = warp & 3, wn = warp >> 2;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int4 r = rw[32 * wm + 16 * mt + g + 8 * hh];
            if (r.x < 0) continue;
#pragma unroll
            for (int nt = 0; nt < kC1 / 16; ++nt)
              epi(r, wn * (kC1 / 2) + 8 * nt + 2 * cq,
                  make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]));
          }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int4 r = rw[tm + 32 * i];
          if (r.x >= 0)
            epi(r, 4 * tn, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
        }
      }
    }
  }
  vae::cp_async_wait<0>();
  __syncthreads();  // smem is free again
}

// convt2 (d1p [14, 14, 32] -> logits [28, 28]) and the loss, image by
// image, warp w taking images w, w + 8, ... First, per input pixel, the dot
// of its 32 channels with each of the 9 taps' weights, s[pixel][tap] (8
// lanes a pixel, each 4 channels read as one float4, so a warp's load
// covers whole 128-byte pixel rows; the lanes' partials meet in a fixed
// shuffle order); then each logit is the bias plus the s of the taps of
// its parity class at the pixels they meet (the phase plan), and its loss
// element is added to the lane's running sum; the warp adds the lanes' sums
// in a fixed order. Reads d1p with plain loads (this block wrote it).
template <bool BF16>
__device__ void convt2_loss(const PhasePlan& p, const float* d1p, const float* __restrict__ x,
                            const float* __restrict__ wt2, float bt2, int valid,
                            int bernoulli, float* smem, float* r_out,
                            float* __restrict__ rec) {
  constexpr int kIn = kMid * kMid;  // 196 input pixels
  float* ws = smem;                 // [9][32], rounded
  for (int i = threadIdx.x; i < 9 * kC1; i += kThreads) ws[i] = rnd<BF16>(__ldg(wt2 + i));
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* s = smem + 9 * kC1 + warp * kIn * 9;  // [196][9]
  const int l8 = lane & 7, c0 = 4 * l8;
  for (int r = warp; r < valid; r += kThreads / 32) {
    const float* img = d1p + (size_t)r * kMidFlat;
    for (int p0 = 0; p0 < kIn; p0 += 28) {  // 7 steps of 4 pixels, loads first
      float4 v[7];
#pragma unroll
      for (int u = 0; u < 7; ++u) {
        const float4 a = *reinterpret_cast<const float4*>(
            img + (p0 + 4 * u + (lane >> 3)) * kC1 + c0);
        v[u] = make_float4(rnd<BF16>(a.x), rnd<BF16>(a.y), rnd<BF16>(a.z), rnd<BF16>(a.w));
      }
#pragma unroll
      for (int u = 0; u < 7; ++u) {
        float acc[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float4 w = *reinterpret_cast<const float4*>(ws + t * kC1 + c0);
          acc[t] = fmaf(v[u].x, w.x, fmaf(v[u].y, w.y, fmaf(v[u].z, w.z, v[u].w * w.w)));
        }
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
        if (l8 == 0)
#pragma unroll
          for (int t = 0; t < 9; ++t) s[(p0 + 4 * u + (lane >> 3)) * 9 + t] = acc[t];
      }
    }
    __syncwarp();
    float lsum = 0.f;
#pragma unroll 5
    for (int o = lane; o < kPix; o += 32) {
      const float xv = __ldg(x + (size_t)r * kPix + o);
      const int oy = o / kImg, ox = o - (o / kImg) * kImg;
      const int c = 2 * (oy & 1) + (ox & 1);  // the plan's classes in parity order
      const int qy = oy >> 1, qx = ox >> 1;
      float y = bt2;
      for (int t = c ? p.tap_end[c - 1] : 0; t < p.tap_end[c]; ++t) {
        const int iy = qy + p.dy[t], ix = qx + p.dx[t];
        if (iy >= 0 && ix >= 0 && iy < kMid && ix < kMid) y += s[(iy * kMid + ix) * 9 + p.wrow[t]];
      }
      r_out[(size_t)r * kPix + o] = y;
      if (bernoulli) {
        lsum += fmaxf(y, 0.f) - y * xv + log1pf(expf(-fabsf(y)));
      } else {
        const float d = xv - y;
        lsum += d * d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    if (lane == 0) rec[r] = lsum;
    __syncwarp();  // s is free for the next image
  }
}

// A block owns 64 rows and runs the stages in turn, each over all of them:
// dense1 and dense2 as tiled products with their weights staged through
// shared memory (g1 stays there, rounded as dense2's operand; g1 and g2 go
// to device memory as saved outputs), convt1 over g2 class after class
// (convt1_class), then convt2 and the loss image by image (convt2_loss).
// The convs read back from device memory what this block wrote there,
// after a barrier: cp.async through L2, or plain loads.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
    conv_dec(const float* __restrict__ z, const float* __restrict__ x,
             int batch, DecWeights wt, int hg, int n_z, int bernoulli,
             PhasePlan plan1, PhasePlan plan2, float* __restrict__ rec,
             float* __restrict__ g1, float* g2, float* d1p, float* r_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ PhasePlan p;
  const int row0 = blockIdx.x * kDecTM;
  const int valid = min(kDecTM, batch - row0);
  const int kz = pad32(n_z), kg = pad32(hg);
  float* ring;
  __nv_bfloat16 *half = nullptr, *zh = nullptr, *g1h = nullptr;
  float *zT = nullptr, *g1T = nullptr;
  if constexpr (BF16) {
    zh = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][kz + 8]
    g1h = zh + kDecTM * (kz + 8);                     // [64][kg + 8]
    ring = reinterpret_cast<float*>(g1h + kDecTM * (kg + 8));
    half = reinterpret_cast<__nv_bfloat16*>(ring + kRingF);
    for (int i = threadIdx.x; i < kDecTM * kz; i += kThreads) {
      const int r = i / kz, k = i - r * kz;
      zh[r * (kz + 8) + k] = __float2bfloat16(
          r < valid && k < n_z ? z[(size_t)(row0 + r) * n_z + k] : 0.f);
    }
    for (int i = threadIdx.x; i < kDecTM * (kg - hg); i += kThreads) {
      const int r = i / (kg - hg);
      g1h[r * (kg + 8) + hg + i - r * (kg - hg)] = __float2bfloat16(0.f);
    }
  } else {
    zT = reinterpret_cast<float*>(smem_raw);  // [kz][kLdAT]
    g1T = zT + kz * kLdAT;                    // [kg][kLdAT]
    ring = g1T + kg * kLdAT;
    for (int i = threadIdx.x; i < kz * kDecTM; i += kThreads) {
      const int k = i / kDecTM, r = i - k * kDecTM;
      zT[k * kLdAT + r] = r < valid && k < n_z ? z[(size_t)(row0 + r) * n_z + k] : 0.f;
    }
    for (int i = threadIdx.x; i < (kg - hg) * kDecTM; i += kThreads)
      g1T[hg * kLdAT + i / kDecTM * kLdAT + i % kDecTM] = 0.f;
  }
  __syncthreads();

  auto to_g1 = [&](int r, int j, float y) {
    const float v = vae::softplus(y + __ldg(wt.c1 + j));
    if constexpr (BF16)
      g1h[r * (kg + 8) + j] = __float2bfloat16(v);
    else
      g1T[j * kLdAT + r] = v;
    if (r < valid) g1[(size_t)(row0 + r) * hg + j] = v;
  };
  dense_rows<BF16>(zT, zh, kz + 8, wt.d1, n_z, hg, ring, half, to_g1);
  auto to_g2 = [&](int r, int j, float y) {
    if (r < valid) g2[(size_t)(row0 + r) * kFlat + j] = vae::softplus(y + __ldg(wt.c2 + j));
  };
  dense_rows<BF16>(g1T, g1h, kg + 8, wt.d2, hg, kFlat, ring, half, to_g2);

  // convt1: g2 [7, 7, 64] -> d1p [14, 14, 32], class after class.
  load_plan(plan1, p);
  {
    const Fwd f{g2 + (size_t)row0 * kFlat, wt.wt1, d1p + (size_t)row0 * kMidFlat,
                valid, kSmall, kSmall, kC2, kC1, kMid};
    SoftplusOut epi{f.y, wt.bt1};
    for (int c = 0; c < p.ncls; ++c) convt1_class<BF16>(f, p, Cls(f, p, c), smem_raw, epi);
  }
  // convt2 and the loss: d1p [14, 14, 32] -> logits [28, 28] -> rec.
  load_plan(plan2, p);
  convt2_loss<BF16>(p, d1p + (size_t)row0 * kMidFlat, x + (size_t)row0 * kPix, wt.wt2,
                    __ldg(wt.bt2), valid, bernoulli, reinterpret_cast<float*>(smem_raw),
                    r_out + (size_t)row0 * kPix, rec + row0);
}

}  // namespace


// Encoder forward over x [batch, 784] (fp32). `weights`: the 10 device
// pointers w1 [3,3,1,32] b1 w2 [3,3,32,64] b2 wd [3136, hr] bd wm [hr, n_z]
// bm wl bl. Outputs: mu, lv [batch, n_z]; a1 [batch, 14, 14, 32];
// a2 [batch, 7, 7, 64]; h [batch, hr]. `tile_rows` is TM (1..8). Launches
// on `stream` without synchronising and returns cudaGetLastError().
extern "C" int vae_conv_enc(const void* x, int batch, const void* const* weights,
                            int hr, int n_z, void* mu, void* lv, void* a1,
                            void* a2, void* h, int tile_rows, int bf16,
                            void* stream) {
  if (batch <= 0 || hr <= 0 || n_z <= 0 || tile_rows < 1 || tile_rows > kMaxTM)
    return (int)cudaErrorInvalidValue;
  const float* const* p = reinterpret_cast<const float* const*>(weights);
  const EncWeights wt{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9]};
  const int hstride = (hr + 3) & ~3;
  const size_t smem = sizeof(float) * tile_rows * ((size_t)kPix + kFlat + hstride);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = vae::set_smem(conv_enc, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (batch + tile_rows - 1) / tile_rows;
  conv_enc<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), batch, wt, hr, n_z, tile_rows, hstride,
      bf16, static_cast<float*>(mu), static_cast<float*>(lv),
      static_cast<float*>(a1), static_cast<float*>(a2), static_cast<float*>(h));
  return (int)cudaGetLastError();
}

// Decoder forward and per-row loss over z [batch, n_z] against x [batch,
// 784]. `weights`: the 8 device pointers d1 [n_z, hg] c1 d2 [hg, 3136] c2
// wt1 [3,3,64,32] bt1 wt2 [3,3,32,1] bt2. Outputs: rec [batch]; g1 [batch,
// hg]; g2 [batch, 7, 7, 64]; d1p [batch, 14, 14, 32]; r [batch, 28, 28]
// (the logits). plan1 and plan2 are the phase plans of the two transposed
// convs (kernels/conv.py::_plan_table); `smem` is kernels/conv_mega.py::
// dec_plan's.
extern "C" int vae_conv_dec(const void* z, const void* x, int batch,
                            const void* const* weights, int hg, int n_z,
                            int bernoulli, void* rec, void* g1, void* g2,
                            void* d1p, void* r, const int* plan1,
                            const int* plan2, int smem, int bf16,
                            void* stream) {
  PhasePlan p1, p2;
  if (batch <= 0 || hg <= 0 || n_z <= 0 || !read_plan(plan1, kMid, &p1) ||
      !read_plan(plan2, kImg, &p2) ||
      smem != std::max(dec_dense_smem(n_z, hg, bf16 != 0), dec_conv_smem(bf16 != 0)) ||
      smem + (int)sizeof(PhasePlan) > vae::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  // The convs take the transposed conv's plan: 4 parity classes (in the
  // order (0, 0), (0, 1), (1, 0), (1, 1)) of at most 4 taps over the
  // undilated input.
  for (const PhasePlan* q : {&p1, &p2}) {
    if (q->ncls != 4 || q->istep != 1 || q->ostep != 2) return (int)cudaErrorInvalidValue;
    for (int c = 0, t0 = 0; c < q->ncls; t0 = q->tap_end[c++])
      if (q->tap_end[c] - t0 > 4 || q->oy0[c] != c / 2 || q->ox0[c] != c % 2)
        return (int)cudaErrorInvalidValue;
  }
  const float* const* p = reinterpret_cast<const float* const*>(weights);
  DecWeights wt{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
  const void* fn = bf16 ? (const void*)conv_dec<true> : (const void*)conv_dec<false>;
  int per_sm = 0;
  cudaError_t e = vae::launch_info(fn, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const float* zp = static_cast<const float*>(z);
  const float* xp = static_cast<const float*>(x);
  float *o_rec = static_cast<float*>(rec), *o_g1 = static_cast<float*>(g1),
        *o_g2 = static_cast<float*>(g2), *o_d1p = static_cast<float*>(d1p),
        *o_r = static_cast<float*>(r);
  void* args[] = {&zp, &xp, &batch, &wt, &hg, &n_z, &bernoulli,
                  &p1, &p2, &o_rec, &o_g1, &o_g2, &o_d1p, &o_r};
  e = cudaLaunchKernel(fn, dim3((batch + kDecTM - 1) / kDecTM), dim3(kThreads), args, smem,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(e != cudaSuccess ? e : last);
}
