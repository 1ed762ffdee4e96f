// The VAE tower megakernel for training, on Hopper (sm_90a): the forward
// pass of a whole depth-2 softplus tower with its per-row loss terms, and
// the per-row half of the fused decoder+loss backward.
//
// mega_fwd replaces the Pallas TPU kernel
// vae_assoc_tpu/kernels/megakernel.py::_fwd_kernel: per row tile,
//   x -> h1 -> h2 -> (mu, logvar) -> eps -> z = mu + exp(logvar / 2) eps
//   -> [z, cond] -> g1 -> g2 -> r -> recon (Bernoulli logit CE or Gaussian
//   SSE against the data columns of x) and the closed-form KL.
// Only x is read and mu, logvar, eps, recon and kl are written; every
// hidden activation and the decoder output r stay in shared memory.
//
// mega_dec_loss_bwd is the per-row half of
// vae_assoc_tpu/kernels/megakernel.py::_dec_loss_bwd_kernel: it
// rematerializes the decoder from z, forms dL/dr on chip, backprops to dz,
// and writes the per-row operands of the decoder's weight gradients (the
// decoder input [z, cond], g1, g2 and the cotangents dr, db2d, db1d) to
// scratch in device memory. The weight gradients themselves are sums over
// all rows: the TPU kernel adds them tile after tile because its grid runs
// in order, but GPU blocks run at once, so a second kernel (vae_wgrad in
// mlp_bwd.cu) computes each dW = A^T D with one block per output tile
// looping over the rows in a fixed order: no atomics, and the same bits
// every run. The price is the round trip of the scratch (dr is [B, 784] for
// images) through device memory.
//
// What bounds them on this card. Per row the image tower does about
// 1.3 M FMAs forward against 3 KB of input, so the work is arithmetic on
// weights streamed from L2 (2.6 MB per net fits the 50 MB L2), each weight
// feeding TM rows. The design is mlp_fwd.cu's: TM rows per block, their
// activations in shared memory, TM chosen by the wrapper
// (kernels/megakernel.py) from the per-row shared-memory need and the batch.
// The backward needs more per row (the decoder input or dr, two
// activations, two sigmoids): TM <= 16 at the image widths.
//
// eps: seeded draws come from a counter-based Philox keyed by the seed and
// indexed by (row, column), so a draw does not depend on TM (the TPU kernel
// hashes its tile index into the seed instead); or eps is injected.
// Tensor cores (wgmma), TMA and a persistent schedule are later work.

#include "common.cuh"

namespace {

using vae::kThreads;

struct FwdWeights {
  const float* p[14];  // w1 b1 w2 b2 wm bm wl bl d1 c1 d2 c2 do co
};

struct FwdDims {
  int n_in;  // encoder input width: data columns + cond columns
  int h1e, h2e, n_z, n_cond, h1d, h2d, n_x;
};

template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads)
    mega_fwd(const float* __restrict__ x, int batch, FwdWeights wt,
             FwdDims d, int bernoulli, const float* __restrict__ eps_in,
             unsigned long long seed, float* __restrict__ mu_out,
             float* __restrict__ lv_out, float* __restrict__ eps_out,
             float* __restrict__ rec_out, float* __restrict__ kl_out,
             int stride) {
  extern __shared__ __align__(16) float smem[];
  float* bufA = smem;
  float* bufB = smem + TM * stride;
  float* mu_s = smem + 2 * TM * stride;
  float* lv_s = mu_s + TM * d.n_z;
  const int row0 = blockIdx.x * TM;
  const int valid = min(TM, batch - row0);
  const int nz = d.n_z;

  vae::load_tile<TM, BF16>(bufA, stride, x, d.n_in, d.n_in, row0, valid);
  __syncthreads();

  auto hidden_to = [&](float* out) {
    return [=](int r, int j, float y) {
      out[r * stride + j] = vae::operand<BF16>(vae::softplus(y));
    };
  };
  auto h1 = hidden_to(bufB);
  vae::layer<TM, BF16>(bufA, stride, wt.p[0], d.h1e, wt.p[1], d.n_in, d.h1e,
                       h1);
  __syncthreads();
  auto h2 = hidden_to(bufA);
  vae::layer<TM, BF16>(bufB, stride, wt.p[2], d.h2e, wt.p[3], d.h1e, d.h2e,
                       h2);
  __syncthreads();
  auto head_mu = [&](int r, int j, float y) {
    mu_s[r * nz + j] = y;
    if (r < valid) mu_out[(size_t)(row0 + r) * nz + j] = y;
  };
  vae::layer<TM, BF16>(bufA, stride, wt.p[4], nz, wt.p[5], d.h2e, nz,
                       head_mu);
  auto head_lv = [&](int r, int j, float y) {
    lv_s[r * nz + j] = y;
    if (r < valid) lv_out[(size_t)(row0 + r) * nz + j] = y;
  };
  vae::layer<TM, BF16>(bufA, stride, wt.p[6], nz, wt.p[7], d.h2e, nz,
                       head_lv);
  __syncthreads();

  // eps, z and the decoder input [z, cond] in bufB; KL per row.
  for (int i = threadIdx.x; i < TM * nz; i += kThreads) {
    const int r = i / nz;
    const int j = i - r * nz;
    float e = 0.f;
    if (r < valid) {
      e = eps_in != nullptr ? eps_in[(size_t)(row0 + r) * nz + j]
                            : vae::philox_normal(seed, row0 + r, j);
      eps_out[(size_t)(row0 + r) * nz + j] = e;
    }
    const float z = mu_s[i] + expf(0.5f * lv_s[i]) * e;
    bufB[r * stride + j] = vae::operand<BF16>(z);
  }
  const int n_x = d.n_x;
  for (int i = threadIdx.x; i < TM * d.n_cond; i += kThreads) {
    const int r = i / d.n_cond;
    const int c = i - r * d.n_cond;
    bufB[r * stride + nz + c] =
        r < valid ? vae::operand<BF16>(x[(size_t)(row0 + r) * d.n_in + n_x + c])
                  : 0.f;
  }
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < valid; r += kThreads / 32) {
    const int lane = threadIdx.x & 31;
    float s = 0.f;
    for (int j = lane; j < nz; j += 32) {
      const float m = mu_s[r * nz + j], l = lv_s[r * nz + j];
      s += 1.f + l - m * m - expf(l);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) kl_out[row0 + r] = -0.5f * s;
  }
  __syncthreads();

  auto g1 = hidden_to(bufA);
  vae::layer<TM, BF16>(bufB, stride, wt.p[8], d.h1d, wt.p[9], nz + d.n_cond,
                       d.h1d, g1);
  __syncthreads();
  auto g2 = hidden_to(bufB);
  vae::layer<TM, BF16>(bufA, stride, wt.p[10], d.h2d, wt.p[11], d.h1d, d.h2d,
                       g2);
  __syncthreads();
  // Decoder output: the per-element loss goes to bufA (free now), never r.
  auto loss = [&](int r, int j, float y) {
    float v = 0.f;
    if (r < valid) {
      const float xv = x[(size_t)(row0 + r) * d.n_in + j];
      if (bernoulli) {
        v = fmaxf(y, 0.f) - y * xv + log1pf(expf(-fabsf(y)));
      } else {
        const float t = xv - y;
        v = t * t;
      }
    }
    bufA[r * stride + j] = v;
  };
  vae::layer<TM, BF16>(bufB, stride, wt.p[12], n_x, wt.p[13], d.h2d, n_x,
                       loss);
  __syncthreads();
  for (int r = warp; r < valid; r += kThreads / 32) {
    const float s = vae::warp_sum(bufA + r * stride, n_x);
    if ((threadIdx.x & 31) == 0) rec_out[row0 + r] = s;
  }
}

struct BwdWeights {
  // d1 c1 d2 c2 do co, then the transposes d1T [h1d, n_z + n_cond],
  // d2T [h2d, h1d], doT [n_x, h2d].
  const float* p[9];
};

struct BwdScratch {
  // Per-row operands of the weight gradients, fp32, row-major:
  // zin [B, n_z + n_cond], g1 [B, h1d], g2 [B, h2d], dr [B, n_x],
  // db2d [B, h2d], db1d [B, h1d].
  float* zin;
  float* g1;
  float* g2;
  float* dr;
  float* db2d;
  float* db1d;
};

struct BwdDims {
  int n_in, n_z, n_cond, h1d, h2d, n_x;
};

template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads)
    mega_dec_loss_bwd(const float* __restrict__ x,
                      const float* __restrict__ z,
                      const float* __restrict__ grec, int batch,
                      BwdWeights wt, BwdScratch s, BwdDims d, int bernoulli,
                      float* __restrict__ dz, int wide, int hid) {
  extern __shared__ __align__(16) float smem[];
  float* W = smem;            // [TM, wide]: decoder input, then dr
  float* P = W + TM * wide;   // [TM, hid]: g1, then db2d
  float* Q = P + TM * hid;    // [TM, hid]: g2, then db1d
  float* S1 = Q + TM * hid;   // [TM, hid]: sigmoid of layer-1 pre-activation
  float* S2 = S1 + TM * hid;  // [TM, hid]: the same for layer 2
  const int row0 = blockIdx.x * TM;
  const int valid = min(TM, batch - row0);
  const int nz = d.n_z, nzc = d.n_z + d.n_cond, n_x = d.n_x;

  // Decoder input [z, cond]: rounded into W, as given into the scratch.
  for (int i = threadIdx.x; i < TM * nzc; i += kThreads) {
    const int r = i / nzc;
    const int k = i - r * nzc;
    float v = 0.f;
    if (r < valid) {
      v = k < nz ? z[(size_t)(row0 + r) * nz + k]
                 : x[(size_t)(row0 + r) * d.n_in + n_x + (k - nz)];
      s.zin[(size_t)(row0 + r) * nzc + k] = v;
    }
    W[r * wide + k] = vae::operand<BF16>(v);
  }
  __syncthreads();

  auto fwd_to = [&](float* out, float* sig, float* glob, int width) {
    return [=](int r, int j, float y) {
      const float g = vae::softplus(y);
      out[r * hid + j] = vae::operand<BF16>(g);
      sig[r * hid + j] = vae::sigmoid(y);
      if (r < valid) glob[(size_t)(row0 + r) * width + j] = g;
    };
  };
  auto e1 = fwd_to(P, S1, s.g1, d.h1d);
  vae::layer<TM, BF16>(W, wide, wt.p[0], d.h1d, wt.p[1], nzc, d.h1d, e1);
  __syncthreads();
  auto e2 = fwd_to(Q, S2, s.g2, d.h2d);
  vae::layer<TM, BF16>(P, hid, wt.p[2], d.h2d, wt.p[3], d.h1d, d.h2d, e2);
  __syncthreads();
  // r = g2 Do + co, and dL/dr on chip; r itself is never stored.
  auto edr = [&](int r, int j, float y) {
    float v = 0.f;
    if (r < valid) {
      const float xv = x[(size_t)(row0 + r) * d.n_in + j];
      const float gr = grec[row0 + r];
      v = bernoulli ? (vae::sigmoid(y) - xv) * gr : 2.f * (y - xv) * gr;
      s.dr[(size_t)(row0 + r) * n_x + j] = v;
    }
    W[r * wide + j] = vae::operand<BF16>(v);
  };
  vae::layer<TM, BF16>(Q, hid, wt.p[4], n_x, wt.p[5], d.h2d, n_x, edr);
  __syncthreads();
  auto bwd_to = [&](float* out, const float* sig, float* glob, int width) {
    return [=](int r, int j, float y) {
      const float v = y * sig[r * hid + j];
      out[r * hid + j] = vae::operand<BF16>(v);
      if (r < valid) glob[(size_t)(row0 + r) * width + j] = v;
    };
  };
  // db2d = (dr Do^T) * sigmoid(b2d), into P (g1 is in the scratch by now).
  auto e3 = bwd_to(P, S2, s.db2d, d.h2d);
  vae::layer<TM, BF16>(W, wide, wt.p[8], d.h2d, nullptr, n_x, d.h2d, e3);
  __syncthreads();
  // db1d = (db2d D2^T) * sigmoid(b1d), into Q.
  auto e4 = bwd_to(Q, S1, s.db1d, d.h1d);
  vae::layer<TM, BF16>(P, hid, wt.p[7], d.h1d, nullptr, d.h2d, d.h1d, e4);
  __syncthreads();
  // dz = db1d D1^T, the z columns only: the cond columns' part is dropped.
  auto edz = [&](int r, int j, float y) {
    if (r < valid) dz[(size_t)(row0 + r) * nz + j] = y;
  };
  vae::layer<TM, BF16>(Q, hid, wt.p[6], nzc, nullptr, d.h1d, nz, edz);
}

}  // namespace

// Forward of one tower over x [batch, n_in] (fp32, the cond columns last).
// `weights` holds the 14 device pointers in the order of FwdWeights, `dims`
// the eight widths of FwdDims. eps_in [batch, n_z] injects eps; when it is
// null, eps is drawn from `seed`. Outputs: mu, lv, eps_out [batch, n_z],
// rec, kl [batch]. `stride` is the shared-memory row length (a multiple of
// 4, at least every on-chip width); `tile_rows` is TM. Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int vae_mega_fwd(const void* x, int batch, const void* const* weights,
                            const int* dims, int bernoulli, const void* eps_in,
                            unsigned long long seed, void* mu, void* lv,
                            void* eps_out, void* rec, void* kl, int stride,
                            int tile_rows, int bf16, void* stream) {
  if (batch <= 0 || stride % 4 != 0) return (int)cudaErrorInvalidValue;
  FwdWeights wt;
  for (int i = 0; i < 14; ++i) wt.p[i] = static_cast<const float*>(weights[i]);
  const FwdDims d{dims[0], dims[1], dims[2], dims[3],
                  dims[4], dims[5], dims[6], dims[7]};
  const auto* xs = static_cast<const float*>(x);
  const auto* ein = static_cast<const float*>(eps_in);
  auto* o_mu = static_cast<float*>(mu);
  auto* o_lv = static_cast<float*>(lv);
  auto* o_eps = static_cast<float*>(eps_out);
  auto* o_rec = static_cast<float*>(rec);
  auto* o_kl = static_cast<float*>(kl);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t per_tile = 2 * (size_t)stride + 2 * (size_t)d.n_z;
#define VAE_FWD(TM)                                                          \
  [&]() -> cudaError_t {                                                     \
    auto k = bf16 ? mega_fwd<TM, true> : mega_fwd<TM, false>;                \
    const size_t smem = (size_t)TM * per_tile * sizeof(float);               \
    cudaError_t e = vae::set_smem(k, smem);                                  \
    if (e != cudaSuccess) return e;                                          \
    k<<<(batch + TM - 1) / TM, kThreads, smem, st>>>(                        \
        xs, batch, wt, d, bernoulli, ein, seed, o_mu, o_lv, o_eps, o_rec,    \
        o_kl, stride);                                                       \
    return cudaGetLastError();                                               \
  }()
  auto run = [&]() -> cudaError_t { VAE_TM_SWITCH(tile_rows, VAE_FWD) };
#undef VAE_FWD
  return (int)run();
}

// Per-row half of the decoder+loss backward. x [batch, n_in] (cond columns
// last), z [batch, n_z], grec [batch] (the cotangent of rec). `weights`:
// the 9 device pointers of BwdWeights; `scratch`: the 6 of BwdScratch;
// `dims`: n_in, n_z, n_cond, h1d, h2d, n_x. Writes dz [batch, n_z] and the
// scratch. `wide` and `hid` are the shared-memory row lengths (multiples of
// 4) of the wide buffer (>= n_x and n_z + n_cond) and the hidden buffers.
extern "C" int vae_mega_dec_loss_bwd(const void* x, const void* z,
                                     const void* grec, int batch,
                                     const void* const* weights,
                                     void* const* scratch, const int* dims,
                                     int bernoulli, void* dz, int wide,
                                     int hid, int tile_rows, int bf16,
                                     void* stream) {
  if (batch <= 0 || wide % 4 != 0 || hid % 4 != 0)
    return (int)cudaErrorInvalidValue;
  BwdWeights wt;
  for (int i = 0; i < 9; ++i) wt.p[i] = static_cast<const float*>(weights[i]);
  BwdScratch s{static_cast<float*>(scratch[0]), static_cast<float*>(scratch[1]),
               static_cast<float*>(scratch[2]), static_cast<float*>(scratch[3]),
               static_cast<float*>(scratch[4]), static_cast<float*>(scratch[5])};
  const BwdDims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5]};
  const auto* xs = static_cast<const float*>(x);
  const auto* zs = static_cast<const float*>(z);
  const auto* gs = static_cast<const float*>(grec);
  auto* o_dz = static_cast<float*>(dz);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t per_tile = (size_t)wide + 4 * (size_t)hid;
#define VAE_BWD(TM)                                                          \
  [&]() -> cudaError_t {                                                     \
    auto k = bf16 ? mega_dec_loss_bwd<TM, true>                              \
                  : mega_dec_loss_bwd<TM, false>;                            \
    const size_t smem = (size_t)TM * per_tile * sizeof(float);               \
    cudaError_t e = vae::set_smem(k, smem);                                  \
    if (e != cudaSuccess) return e;                                          \
    k<<<(batch + TM - 1) / TM, kThreads, smem, st>>>(                        \
        xs, zs, gs, batch, wt, s, d, bernoulli, o_dz, wide, hid);            \
    return cudaGetLastError();                                               \
  }()
  auto run = [&]() -> cudaError_t { VAE_TM_SWITCH_16(tile_rows, VAE_BWD) };
#undef VAE_BWD
  return (int)run();
}
