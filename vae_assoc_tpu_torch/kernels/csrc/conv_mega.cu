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
// tensor cores the bytes do (0.23 ms). The dense weights (6.27 MB each)
// stream from L2, so weight reuse per L2 read is the rows a block owns: a
// TPU-shaped 8-row tile (one thread per output, a weight load per FMA) read
// 12.8 GB of L2 at B = 16384. Both kernels therefore run the stages in turn
// over a block of many rows, each stage as a tiled product.
//
// conv_enc. A block owns TM = 16, 32 or 64 rows (kernels/conv_mega.py::
// enc_plan, from the batch, so that a small batch still fills the SMs).
// - conv1 (cin = 1): thin and byte-bound; a thread owns 8 channels of a
//   pixel (its 9 taps once), a1 (saved) goes to device memory.
// - conv2: conv_fwd's stride-2 plan (one class of 9 taps) as tiled slice
//   products (conv_tile.cuh: fp32 register tiles, bf16 mma.sync), fed by a
//   cp.async ring from a1, as conv_dec's convt1 is fed from g2 (conv_class);
//   bias + softplus into a2 (saved).
// - dense 3136 -> hr: dense_tile.cuh's product with A streamed from a2
//   (64 rows of a2 are 803 KB: they do not fit in shared memory); bias +
//   softplus into h (saved).
// - heads: one hr -> 2 n_z pass over h, a thread per output.
//
// conv_dec. A block owns 64 rows (kDecTM) and runs the stages in turn.
// - dense1 and dense2: dense_tile.cuh's product with z and g1 resident in
//   shared memory (g1 rounded as dense2's operand). g2 for 64 rows (803 KB)
//   does not fit there, so it goes to device memory (a saved output anyway)
//   and convt1 reads it back, as convt2 does d1p.
// - convt1: the phase plan's 4 parity classes of the undilated g2, each
//   through conv_class, with a bias + softplus epilogue.
// - convt2 (cout = 1) and the loss, image by image (convt2_loss): the 9
//   tap dots of each d1p pixel, then each logit as the sum of its class's
//   taps, its loss element into the row's sum; no second pass over r.
// Geometry is fixed (28 x 28, 32 and 64 channels); hr, hg and n_z are
// runtime arguments. With bf16 both operands of every product are rounded to
// bf16 and the products add in fp32.

#include <algorithm>
#include <type_traits>

#include "conv_tile.cuh"
#include "dense_tile.cuh"

namespace {

constexpr int kImg = 28, kMid = 14, kSmall = 7, kC1 = 32, kC2 = 64;
constexpr int kPix = kImg * kImg;                // 784
constexpr int kMidFlat = kMid * kMid * kC1;      // 6272
constexpr int kFlat = kSmall * kSmall * kC2;     // 3136
constexpr int kDecTM = 64;                       // conv_dec's rows per block
constexpr int kCStages = 3;                      // slices in conv_class's cp.async ring

// conv_class's epilogue: bias, softplus, into the layer's output.
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

// Shared memory of conv_class for a class of K patch columns into COUT
// channels: the ring, the tile's pixel rows per tile parity and the class's
// weight rows (bf16: [COUT][K + 8], and two rounded slices).
__host__ __device__ constexpr int conv_class_smem(bool bf16, int k, int cout) {
  return bf16 ? 4 * kCStages * kMmaTile * kLdF + 2 * 16 * kMmaTile + 2 * cout * (k + 8) +
                    2 * 2 * kMmaTile * kLdH
              : 4 * kCStages * kFfmaTile * kLdF + 2 * 16 * kFfmaTile + 4 * k * cout;
}

// One parity class k of a conv over the block's rows (f.batch of them) into
// COUT channels: conv_fwd's tiled product (the class's weight rows staged
// once; tiles of 256 pixels in fp32, 128 in bf16; slices of 32 patch
// columns, one tap and 32 channels, multiplied by conv_tile.cuh's mac_ffma
// or mac_mma), but its slices stream through a ring of kCStages stages
// filled by cp.async through L2, where this block wrote f.x: thread t copies
// pixels t / 8 + 32 i, channels 4 (t % 8) ... of the slice's tap (one
// address and bounds check per (pixel, tap), zero-filled outside the
// image), so two slices are in flight while one multiplies; in bf16 each
// thread rounds what it copied into a double-buffered bf16 slice. A tile's
// pixel rows are computed when its first slice is issued, kept per tile
// parity. Hands the tile's sums to epi as conv.cu's kernels store them.
template <bool BF16, int COUT, class Epi>
__device__ void conv_class(const Fwd& f, const PhasePlan& p, const Cls& k,
                           unsigned char* smem, Epi& epi) {
  constexpr int T = BF16 ? kMmaTile : kFfmaTile;
  constexpr int NV = T / 32;
  constexpr int kSlot = T * kLdF;
  const int K = k.nt * f.cin;
  const int nst = K / kStageK;
  const int total = ((k.mc + T - 1) / T) * nst;
  auto* ring = reinterpret_cast<float*>(smem);                    // [kCStages][T][kLdF]
  int4* rows = reinterpret_cast<int4*>(ring + kCStages * kSlot);  // [2][T]
  float* ws = reinterpret_cast<float*>(rows + 2 * T);             // fp32: [K][COUT]
  auto* wt = reinterpret_cast<__nv_bfloat16*>(rows + 2 * T);      // bf16: [COUT][K + 8]
  __nv_bfloat16* half = wt + COUT * (K + 8);                      // bf16: [2][T][kLdH]
  const int ldw = K + 8;
  for (int i = threadIdx.x; i < K * COUT; i += kThreads) {
    const int kk = i / COUT, n = i - kk * COUT;
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
  std::conditional_t<BF16, float[2][COUT / 16][4], float[8][COUT / 8]> acc;
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
          for (int b = 0; b < COUT / 16; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
      } else {
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < COUT / 8; ++b) acc[a][b] = 0.f;
      }
    }
    if constexpr (BF16)
      mac_mma<COUT>(hs, wt, ldw, s * kStageK, acc);
    else
      mac_ffma<COUT / 8>(st, ws + s * kStageK * COUT, tm, tn, acc);
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
            for (int nt = 0; nt < COUT / 16; ++nt)
              epi(r, wn * (COUT / 2) + 8 * nt + 2 * cq,
                  make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]));
          }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int4 r = rw[tm + 32 * i];
          if (r.x < 0) continue;
          epi(r, 4 * tn, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
          if constexpr (COUT == 64)
            epi(r, 32 + 4 * tn, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
        }
      }
    }
  }
  vae::cp_async_wait<0>();
  __syncthreads();  // smem is free again
}

// ---- conv_enc ----

struct EncWeights {
  const float *w1, *b1, *w2, *b2, *wd, *bd, *wm, *bm, *wl, *bl;
};

// Shared memory of conv_enc (kernels/conv_mega.py::enc_plan): conv2's
// class (9 taps x 32 channels into 64) or the dense layer's ring with A
// streamed, whichever is larger; conv1's weight fits in either.
int enc_smem(int tm, bool bf16) {
  return std::max(conv_class_smem(bf16, 9 * kC1, kC2), dense_ring_bytes(tm, false, true, bf16));
}

// conv1 (1 -> 32 channels, pads (0, 1), so taps at row or column 28 are
// zero) over the block's valid rows: thread item (row, pixel, 8 channels),
// its 9 taps of x read once, 72 FMAs, two 16-byte stores (the 4 items of a
// pixel store its whole 128-byte row of a1). w1s: [9][32], rounded.
template <bool BF16>
__device__ void conv1(const float* __restrict__ x, const float* w1s,
                      const float* __restrict__ b1, int valid, float* a1) {
  for (int i = threadIdx.x; i < valid * kMid * kMid * 4; i += kThreads) {
    const int g = i & 3, pix = i >> 2;
    const int r = pix / (kMid * kMid), p = pix - r * kMid * kMid;
    const int oy = p / kMid, ox = p - oy * kMid;
    const float* xr = x + (size_t)r * kPix;
    float xv[9];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int iy = 2 * oy + ky, ix = 2 * ox + kx;
        xv[3 * ky + kx] = iy < kImg && ix < kImg ? rnd<BF16>(__ldg(xr + iy * kImg + ix)) : 0.f;
      }
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float4 w0 = *reinterpret_cast<const float4*>(w1s + t * kC1 + 8 * g);
      const float4 w1 = *reinterpret_cast<const float4*>(w1s + t * kC1 + 8 * g + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(xv[t], wv[c], acc[c]);
    }
    float out[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) out[c] = vae::softplus(acc[c] + __ldg(b1 + 8 * g + c));
    float* y = a1 + (size_t)pix * kC1 + 8 * g;
    *reinterpret_cast<float4*>(y) = make_float4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<float4*>(y + 4) = make_float4(out[4], out[5], out[6], out[7]);
  }
}

// The heads over the block's valid rows of h (written by this block before
// a barrier, so plain loads): mu and logvar as one hr -> 2 n_z pass, a
// thread per output (consecutive threads on consecutive columns, so a warp
// shares each h value and reads 32 neighbouring weights).
template <bool BF16>
__device__ void heads(const float* h, int hr, const EncWeights& wt, int n_z, int valid,
                      float* __restrict__ mu, float* __restrict__ lv) {
  const int n2 = 2 * n_z;
  for (int o = threadIdx.x; o < valid * n2; o += kThreads) {
    const int r = o / n2, c = o - r * n2;
    const bool m = c < n_z;
    const int cc = m ? c : c - n_z;
    const float* w = (m ? wt.wm : wt.wl) + cc;
    const float* hrow = h + (size_t)r * hr;
    float acc = 0.f;
    for (int k = 0; k < hr; ++k)
      acc = fmaf(rnd<BF16>(hrow[k]), rnd<BF16>(__ldg(w + (size_t)k * n_z)), acc);
    (m ? mu : lv)[(size_t)r * n_z + cc] = acc + __ldg((m ? wt.bm : wt.bl) + cc);
  }
}

// A block owns TM rows and runs the stages in turn, each over all of them;
// a1, a2 and h go to device memory (saved outputs) and the next stage reads
// them back after a barrier.
template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
    conv_enc(const float* __restrict__ x, int batch, EncWeights wt, int hr, int n_z,
             PhasePlan plan2, float* __restrict__ mu, float* __restrict__ lv, float* a1,
             float* a2, float* h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ PhasePlan p;
  const int row0 = blockIdx.x * TM;
  const int valid = min(TM, batch - row0);
  float* w1s = reinterpret_cast<float*>(smem_raw);  // [9][32]
  for (int i = threadIdx.x; i < 9 * kC1; i += kThreads) w1s[i] = rnd<BF16>(__ldg(wt.w1 + i));
  __syncthreads();
  conv1<BF16>(x + (size_t)row0 * kPix, w1s, wt.b1, valid, a1 + (size_t)row0 * kMidFlat);
  __syncthreads();  // a1 is written; w1s is free
  // conv2: a1 [14, 14, 32] -> a2 [7, 7, 64], the stride-2 plan's one class.
  load_plan(plan2, p);
  {
    const Fwd f{a1 + (size_t)row0 * kMidFlat, wt.w2, a2 + (size_t)row0 * kFlat,
                valid, kMid, kMid, kC1, kC2, kSmall};
    SoftplusOut epi{f.y, wt.b2};
    conv_class<BF16, kC2>(f, p, Cls(f, p, 0), smem_raw, epi);
  }
  // dense: a2 [3136] -> h [hr], a2 streamed back.
  float* hb = h + (size_t)row0 * hr;
  auto to_h = [&](int r, int j, float y) {
    if (r < valid) hb[(size_t)r * hr + j] = vae::softplus(y + __ldg(wt.bd + j));
  };
  dense_rows<TM, BF16, false, true>(a2 + (size_t)row0 * kFlat, nullptr, kFlat, valid, wt.wd,
                                    kFlat, hr, reinterpret_cast<float*>(smem_raw), to_h);
  heads<BF16>(hb, hr, wt, n_z, valid, mu + (size_t)row0 * n_z, lv + (size_t)row0 * n_z);
}

// ---- conv_dec ----

struct DecWeights {
  const float *d1, *c1, *d2, *c2, *wt1, *bt1, *wt2, *bt2;
};

// Shared memory of the dense stages (kernels/conv_mega.py::dec_plan): the
// staged z and g1 (fp32 [row][k + 4]; bf16 [row][k + 8], k padded to 32)
// and the weight ring (bf16: with the rounded slices). The convs reuse it.
__host__ __device__ constexpr int dec_dense_smem(int n_z, int hg, bool bf16) {
  return (bf16 ? 2 * kDecTM * (pad32(n_z) + 8 + pad32(hg) + 8)
               : 4 * kDecTM * (pad32(n_z) + 4 + pad32(hg) + 4)) +
         dense_ring_bytes(kDecTM, false, false, bf16);
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
// dense1 and dense2 as tiled products with z and g1 resident in shared
// memory (g1 and g2 also go to device memory as saved outputs), convt1 over
// g2 class after class (conv_class), then convt2 and the loss image by
// image (convt2_loss). The convs read back from device memory what this
// block wrote there, after a barrier: cp.async through L2, or plain loads.
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
  // z and g1 as the products' resident A: [64][kz + pad], [64][kg + pad].
  constexpr int kPadA = BF16 ? 8 : 4;
  const int ldz = kz + kPadA, ldg = kg + kPadA;
  float *zs = nullptr, *g1s = nullptr, *ring;
  __nv_bfloat16 *zh = nullptr, *g1h = nullptr;
  if constexpr (BF16) {
    zh = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    g1h = zh + kDecTM * ldz;
    ring = reinterpret_cast<float*>(g1h + kDecTM * ldg);
  } else {
    zs = reinterpret_cast<float*>(smem_raw);
    g1s = zs + kDecTM * ldz;
    ring = g1s + kDecTM * ldg;
  }
  for (int i = threadIdx.x; i < kDecTM * kz; i += kThreads) {
    const int r = i / kz, k = i - r * kz;
    const float v = r < valid && k < n_z ? z[(size_t)(row0 + r) * n_z + k] : 0.f;
    if constexpr (BF16)
      zh[r * ldz + k] = __float2bfloat16(v);
    else
      zs[r * ldz + k] = v;
  }
  for (int i = threadIdx.x; i < kDecTM * (kg - hg); i += kThreads) {
    const int r = i / (kg - hg), k = hg + i - r * (kg - hg);
    if constexpr (BF16)
      g1h[r * ldg + k] = __float2bfloat16(0.f);
    else
      g1s[r * ldg + k] = 0.f;
  }
  __syncthreads();

  auto to_g1 = [&](int r, int j, float y) {
    const float v = vae::softplus(y + __ldg(wt.c1 + j));
    if constexpr (BF16)
      g1h[r * ldg + j] = __float2bfloat16(v);
    else
      g1s[r * ldg + j] = v;
    if (r < valid) g1[(size_t)(row0 + r) * hg + j] = v;
  };
  dense_rows<kDecTM, BF16, false, false>(zs, zh, ldz, valid, wt.d1, n_z, hg, ring, to_g1);
  auto to_g2 = [&](int r, int j, float y) {
    if (r < valid) g2[(size_t)(row0 + r) * kFlat + j] = vae::softplus(y + __ldg(wt.c2 + j));
  };
  dense_rows<kDecTM, BF16, false, false>(g1s, g1h, ldg, valid, wt.d2, hg, kFlat, ring, to_g2);

  // convt1: g2 [7, 7, 64] -> d1p [14, 14, 32], class after class.
  load_plan(plan1, p);
  {
    const Fwd f{g2 + (size_t)row0 * kFlat, wt.wt1, d1p + (size_t)row0 * kMidFlat,
                valid, kSmall, kSmall, kC2, kC1, kMid};
    SoftplusOut epi{f.y, wt.bt1};
    for (int c = 0; c < p.ncls; ++c) conv_class<BF16, kC1>(f, p, Cls(f, p, c), smem_raw, epi);
  }
  // convt2 and the loss: d1p [14, 14, 32] -> logits [28, 28] -> rec.
  load_plan(plan2, p);
  convt2_loss<BF16>(p, d1p + (size_t)row0 * kMidFlat, x + (size_t)row0 * kPix, wt.wt2,
                    __ldg(wt.bt2), valid, bernoulli, reinterpret_cast<float*>(smem_raw),
                    r_out + (size_t)row0 * kPix, rec + row0);
}

// A plan of the transposed conv as the convs take it: 4 parity classes (in
// the order (0, 0), (0, 1), (1, 0), (1, 1)) of at most 4 taps over the
// undilated input.
bool transposed_plan(const PhasePlan& q) {
  if (q.ncls != 4 || q.istep != 1 || q.ostep != 2) return false;
  for (int c = 0, t0 = 0; c < q.ncls; t0 = q.tap_end[c++])
    if (q.tap_end[c] - t0 > 4 || q.oy0[c] != c / 2 || q.ox0[c] != c % 2) return false;
  return true;
}

template <bool BF16>
const void* enc_kernel(int tm) {
  return tm == 16   ? (const void*)conv_enc<16, BF16>
         : tm == 32 ? (const void*)conv_enc<32, BF16>
                    : (const void*)conv_enc<64, BF16>;
}

cudaError_t launch(const void* fn, int grid, int smem, void** args, void* stream) {
  int per_sm = 0;
  cudaError_t e = vae::launch_info(fn, smem, &per_sm);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, smem,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return e != cudaSuccess ? e : last;
}

}  // namespace


// Encoder forward over x [batch, 784] (fp32). `weights`: the 10 device
// pointers w1 [3,3,1,32] b1 w2 [3,3,32,64] b2 wd [3136, hr] bd wm [hr, n_z]
// bm wl bl. Outputs: mu, lv [batch, n_z]; a1 [batch, 14, 14, 32];
// a2 [batch, 7, 7, 64]; h [batch, hr]. plan2 is conv2's phase plan
// (kernels/conv.py::_plan_table: one class of 9 taps); `tile_rows` (16, 32
// or 64) and `smem` are kernels/conv_mega.py::enc_plan's. Launches on
// `stream` without synchronising and returns the launch's CUDA error.
extern "C" int vae_conv_enc(const void* x, int batch, const void* const* weights,
                            int hr, int n_z, void* mu, void* lv, void* a1,
                            void* a2, void* h, const int* plan2, int tile_rows,
                            int smem, int bf16, void* stream) {
  PhasePlan p2;
  if (batch <= 0 || hr <= 0 || n_z <= 0 || !read_plan(plan2, kSmall, &p2) ||
      p2.ncls != 1 || p2.ntaps != 9 || p2.istep != 2 || p2.ostep != 1 ||
      (tile_rows != 16 && tile_rows != 32 && tile_rows != 64) ||
      smem != enc_smem(tile_rows, bf16 != 0) ||
      smem + (int)sizeof(PhasePlan) > vae::kSmemLimit ||
      reinterpret_cast<uintptr_t>(a1) % 16 != 0 || reinterpret_cast<uintptr_t>(a2) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* const* p = reinterpret_cast<const float* const*>(weights);
  EncWeights wt{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9]};
  const void* fn = bf16 ? enc_kernel<true>(tile_rows) : enc_kernel<false>(tile_rows);
  const float* xp = static_cast<const float*>(x);
  float *o_mu = static_cast<float*>(mu), *o_lv = static_cast<float*>(lv),
        *o_a1 = static_cast<float*>(a1), *o_a2 = static_cast<float*>(a2),
        *o_h = static_cast<float*>(h);
  void* args[] = {&xp, &batch, &wt, &hr, &n_z, &p2, &o_mu, &o_lv, &o_a1, &o_a2, &o_h};
  return (int)launch(fn, (batch + tile_rows - 1) / tile_rows, smem, args, stream);
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
      !read_plan(plan2, kImg, &p2) || !transposed_plan(p1) || !transposed_plan(p2) ||
      smem != std::max(dec_dense_smem(n_z, hg, bf16 != 0),
                       conv_class_smem(bf16 != 0, 4 * kC2, kC1)) ||
      smem + (int)sizeof(PhasePlan) > vae::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const float* const* p = reinterpret_cast<const float* const*>(weights);
  DecWeights wt{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
  const void* fn = bf16 ? (const void*)conv_dec<true> : (const void*)conv_dec<false>;
  const float* zp = static_cast<const float*>(z);
  const float* xp = static_cast<const float*>(x);
  float *o_rec = static_cast<float*>(rec), *o_g1 = static_cast<float*>(g1),
        *o_g2 = static_cast<float*>(g2), *o_d1p = static_cast<float*>(d1p),
        *o_r = static_cast<float*>(r);
  void* args[] = {&zp, &xp, &batch, &wt, &hg, &n_z, &bernoulli,
                  &p1, &p2, &o_rec, &o_g1, &o_g2, &o_d1p, &o_r};
  return (int)launch(fn, (batch + kDecTM - 1) / kDecTM, smem, args, stream);
}
