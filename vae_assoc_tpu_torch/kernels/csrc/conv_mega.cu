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
// conv 0.9 M) against 3-13 KB of input and 42-48 KB of saved activations,
// so at B = 1024 the work is 78 us of fp32 FMAs at 67 TFLOP/s and arithmetic
// bounds it. The dense weights (6.27 MB each) stream from L2, so weight
// reuse per L2 read is the rows a block owns.
//
// What the design does about it (simple first).
// - A block owns TM <= 8 rows (kernels/conv_mega.py sizes TM with
//   kernels/mlp.py::rows_plan). One row's input, conv output and dense
//   activations would take 42.8 KB of shared memory (x 3,136 B, a1
//   25,088 B, a2 12,544 B, h), so at most 5 rows would fit; a1 and d1p,
//   which are saved outputs anyway, are staged through device memory
//   (written, then read back from L1/L2 by the same block after a barrier)
//   and shared memory holds x, a2 and h (the encoder) or z, g1, g2 and the
//   per-element loss (the decoder): 17.7 KB a row, so 8 rows fit.
// - Convs: one thread per output (channel fastest, so a warp shares one
//   pixel: its activation reads broadcast and its weight reads coalesce),
//   the 3 x 3 taps summed in place. The transposed convs skip the taps that
//   fall on the zeros of the x2 dilation, so they do only useful work.
// - Dense layers: one thread per output column for all TM rows; weights
//   read once per block from L2 (mlp_fwd.cu's inner loop with runtime TM).
// - Geometry is fixed (28 x 28, 32 and 64 channels); widths hr, hg, n_z, TM
//   and the dtype are runtime arguments: no template instances. With bf16
//   both operands of every product are rounded to bf16 (activations when
//   staged, weights when loaded) and the products add in fp32.
// Tensor cores, register tiling of the convs and larger tiles are later
// work.

#include "common.cuh"

namespace {

using vae::kThreads;

constexpr int kImg = 28, kMid = 14, kSmall = 7, kC1 = 32, kC2 = 64;
constexpr int kPix = kImg * kImg;                // 784
constexpr int kMidFlat = kMid * kMid * kC1;      // 6272
constexpr int kFlat = kSmall * kSmall * kC2;     // 3136
constexpr int kMaxTM = 8;

__device__ __forceinline__ float rnd(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

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

// The dilated, padded (2, 1) coordinate o + k of a transposed conv maps to
// input index (o + k - 2) / 2 when that is even and inside [0, n); else -1.
__device__ __forceinline__ int convt_src(int o, int k, int n) {
  const int d = o + k - 2;
  if (d < 0 || (d & 1)) return -1;
  return d / 2 < n ? d / 2 : -1;
}

// d1p is written and read back by the same block (see conv_enc's a1).
__global__ void __launch_bounds__(kThreads)
    conv_dec(const float* __restrict__ z, const float* __restrict__ x,
             int batch, DecWeights wt, int hg, int n_z, int bernoulli, int tm,
             int zstride, int gstride, int bf16, float* __restrict__ rec,
             float* __restrict__ g1, float* __restrict__ g2, float* d1p,
             float* __restrict__ r_out) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                // [tm, zstride], rounded
  float* g1s = zs + tm * zstride;  // [tm, gstride], rounded
  float* g2s = g1s + tm * gstride; // [tm, 3136], rounded
  float* ls = g2s + tm * kFlat;    // [tm, 784] per-element loss
  const int row0 = blockIdx.x * tm;
  const int valid = min(tm, batch - row0);

  for (int i = threadIdx.x; i < tm * n_z; i += kThreads) {
    const int r = i / n_z;
    const int k = i - r * n_z;
    zs[r * zstride + k] = r < valid ? rnd(z[(size_t)(row0 + r) * n_z + k], bf16) : 0.f;
  }
  __syncthreads();
  auto to_g1 = [&](int r, int j, float y) {
    const float v = vae::softplus(y);
    g1s[r * gstride + j] = rnd(v, bf16);
    if (r < valid) g1[(size_t)(row0 + r) * hg + j] = v;
  };
  dense(zs, zstride, wt.d1, wt.c1, n_z, hg, tm, bf16, to_g1);
  __syncthreads();
  auto to_g2 = [&](int r, int j, float y) {
    const float v = vae::softplus(y);
    g2s[r * kFlat + j] = rnd(v, bf16);
    if (r < valid) g2[(size_t)(row0 + r) * kFlat + j] = v;
  };
  dense(g1s, gstride, wt.d2, wt.c2, hg, kFlat, tm, bf16, to_g2);
  __syncthreads();

  // convt1: g2 [7, 7, 64] -> d1p [14, 14, 32].
  for (int o = threadIdx.x; o < valid * kMidFlat; o += kThreads) {
    const int co = o % kC1;
    const int pix = o / kC1;
    const int r = pix / (kMid * kMid);
    const int p = pix - r * kMid * kMid;
    const int oy = p / kMid, ox = p - (p / kMid) * kMid;
    const float* src = g2s + r * kFlat;
    float acc = 0.f;
    for (int ky = 0; ky < 3; ++ky) {
      const int iy = convt_src(oy, ky, kSmall);
      if (iy < 0) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int ix = convt_src(ox, kx, kSmall);
        if (ix < 0) continue;
        const float* a = src + (iy * kSmall + ix) * kC2;
        const float* wk = wt.wt1 + (ky * 3 + kx) * kC2 * kC1 + co;
#pragma unroll 8
        for (int c = 0; c < kC2; ++c)
          acc = fmaf(a[c], rnd(__ldg(wk + c * kC1), bf16), acc);
      }
    }
    d1p[(size_t)row0 * kMidFlat + o] = vae::softplus(acc + __ldg(wt.bt1 + co));
  }
  __syncthreads();

  // convt2: d1p [14, 14, 32] -> logits [28, 28, 1], then the loss element.
  for (int o = threadIdx.x; o < tm * kPix; o += kThreads) {
    const int r = o / kPix;
    const int p = o - r * kPix;
    float loss = 0.f;
    if (r < valid) {
      const int oy = p / kImg, ox = p - (p / kImg) * kImg;
      const float* src = d1p + (size_t)(row0 + r) * kMidFlat;
      float acc = 0.f;
      for (int ky = 0; ky < 3; ++ky) {
        const int iy = convt_src(oy, ky, kMid);
        if (iy < 0) continue;
        for (int kx = 0; kx < 3; ++kx) {
          const int ix = convt_src(ox, kx, kMid);
          if (ix < 0) continue;
          const float* a = src + (iy * kMid + ix) * kC1;
          const float* wk = wt.wt2 + (ky * 3 + kx) * kC1;
#pragma unroll 8
          for (int c = 0; c < kC1; ++c)
            acc = fmaf(rnd(a[c], bf16), rnd(__ldg(wk + c), bf16), acc);
        }
      }
      const float y = acc + __ldg(wt.bt2);
      r_out[(size_t)row0 * kPix + o] = y;
      const float xv = x[(size_t)row0 * kPix + o];
      if (bernoulli) {
        loss = fmaxf(y, 0.f) - y * xv + log1pf(expf(-fabsf(y)));
      } else {
        const float t = xv - y;
        loss = t * t;
      }
    }
    ls[o] = loss;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < valid; r += kThreads / 32) {
    const float s = vae::warp_sum(ls + r * kPix, kPix);
    if ((threadIdx.x & 31) == 0) rec[row0 + r] = s;
  }
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
// (the logits). `tile_rows` is TM (1..8).
extern "C" int vae_conv_dec(const void* z, const void* x, int batch,
                            const void* const* weights, int hg, int n_z,
                            int bernoulli, void* rec, void* g1, void* g2,
                            void* d1p, void* r, int tile_rows, int bf16,
                            void* stream) {
  if (batch <= 0 || hg <= 0 || n_z <= 0 || tile_rows < 1 || tile_rows > kMaxTM)
    return (int)cudaErrorInvalidValue;
  const float* const* p = reinterpret_cast<const float* const*>(weights);
  const DecWeights wt{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
  const int zstride = (n_z + 3) & ~3;
  const int gstride = (hg + 3) & ~3;
  const size_t smem =
      sizeof(float) * tile_rows * ((size_t)zstride + gstride + kFlat + kPix);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = vae::set_smem(conv_dec, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (batch + tile_rows - 1) / tile_rows;
  conv_dec<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(x), batch, wt, hg,
      n_z, bernoulli, tile_rows, zstride, gstride, bf16,
      static_cast<float*>(rec), static_cast<float*>(g1), static_cast<float*>(g2),
      static_cast<float*>(d1p), static_cast<float*>(r));
  return (int)cudaGetLastError();
}
