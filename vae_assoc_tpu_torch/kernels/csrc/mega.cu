// The VAE tower megakernel for training, on Hopper (sm_90a): the forward
// pass of a whole depth-2 softplus tower with its per-row loss terms, and
// the per-row half of the fused decoder+loss backward.
//
// mega_fwd replaces the Pallas TPU kernel
// vae_assoc_tpu/kernels/megakernel.py::_fwd_kernel: per row tile,
//   x -> h1 -> h2 -> (mu, logvar) -> eps -> z = mu + exp(logvar / 2) eps
//   -> [z, cond] -> g1 -> g2 -> r -> recon (Bernoulli logit CE or Gaussian
//   SSE against the data columns of x) and the closed-form KL.
// It reads x (and an injected eps) and writes mu, logvar, eps, recon and
// kl; the hidden activations go to a workspace, and r is never stored.
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
// What bounds them on this card. Per row the image tower does about 1.3 M
// multiply-adds each way against 3 KB of input, so the work is arithmetic
// on weights streamed from L2 (2.6 MB per net fits the 50 MB L2), and the
// rows that share each weight byte read are what a tile saves; in bf16 the
// tensor cores finish a slice long before the next arrives, so each block
// streaming its weight slices from L2 bounds them.
//
// Both run their products through dense_tile.cuh's block-tiled product
// over TM = 16, 32 or 64 rows (from the batch): each weight byte a block
// reads serves all its rows, fp32 on register tiles, bf16 on mma.sync.
// Each product's output goes to device memory and streams back as the
// next one's A, so nothing per row lives in shared memory and the widths
// do not bound the tile. Where 16-row tiles leave SMs idle, blocks (a
// cluster) share each tile, each taking every parts-th column tile, with a
// cluster barrier between products.
// - mega_fwd's seven products: the encoder stack (softplus_stack: x W1,
//   h1 W2), the two heads (two N = n_z products, so the thread that wrote
//   mu[r, j] computes logvar[r, j] and, in the same epilogue, eps and z into
//   the decoder input), the decoder stack, and the output product, whose
//   epilogue forms each element's loss and adds it to the thread's partial
//   for that row in shared memory. The partials are added in a fixed
//   order, and the parts' sums in part order, so a second call gives the
//   same bits. KL: one warp per row over the saved mu and logvar.
// - mega_dec_loss_bwd's five: the decoder [z, cond] -> g1 -> g2, r with
//   dL/dr formed in the epilogue, then dr Do^T, db2d D2^T and db1d D1^T.
//   The transposed products read D1, D2 and Do as the forward does (no
//   transposed copies), and sigmoid(pre) comes from the saved g as
//   -expm1(-g), so no sigmoid buffer is kept.
//
// eps: seeded draws come from a counter-based Philox keyed by the seed and
// indexed by (row, column), so a draw does not depend on TM (the TPU kernel
// hashes its tile index into the seed instead); or eps is injected. The
// seed comes by value or through a device pointer read when the kernel
// runs (a step captured in a CUDA graph writes it before each replay).

#include "common.cuh"
#include "dense_tile.cuh"

namespace {

using vae::kThreads;

struct FwdWeights {
  const float* p[14];  // w1 b1 w2 b2 wm bm wl bl d1 c1 d2 c2 do co
};

struct FwdDims {
  int n_in;  // encoder input width: data columns + cond columns
  int h1e, h2e, n_z, n_cond, h1d, h2d, n_x;
};

// Shared memory of the forward (kernels/megakernel.py::fwd_plan): the ring
// of its one product mode, W as stored with A streamed, then the loss
// partials [TM][32].
__host__ __device__ constexpr int fwd_ring(int tm, bool bf16) {
  return dense_ring_bytes(tm, false, true, bf16);
}
__host__ __device__ constexpr int fwd_smem(int tm, bool bf16) {
  return fwd_ring(tm, bf16) + 4 * 32 * tm;
}

// `parts` blocks (a cluster, consecutive in x) own TM rows and run the
// seven products in turn (dense_tile.cuh), each taking every parts-th
// column tile, each A streamed back from what these blocks wrote before the
// barrier that ends the last product. ws: two buffers [batch, ldh]; rows
// of h1, then the decoder input [z, cond] and g2 go to the first, h2 and g1
// to the second. rec_parts [parts - 1, batch]: the loss sums of parts 1 ...,
// which part 0 adds to its own in part order. At 64 rows two blocks share
// an SM (at most 128 registers a thread).
template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads, TM == 64 ? 2 : 1)
    mega_fwd(const float* __restrict__ x, int batch, FwdWeights wt, FwdDims d, int bernoulli,
             const float* __restrict__ eps_in, const unsigned long long* __restrict__ seed_at,
             unsigned long long seed, float* __restrict__ mu_out, float* __restrict__ lv_out,
             float* __restrict__ eps_out, float* __restrict__ rec_out,
             float* __restrict__ kl_out, float* ws, int ldh, float* rec_parts, int parts) {
  extern __shared__ __align__(16) float ring[];
  float* red = ring + fwd_ring(TM, BF16) / 4;  // [TM][32] loss partials per (row, peer)
  const int part = blockIdx.x % parts;
  const int row0 = blockIdx.x / parts * TM;
  const int valid = min(TM, batch - row0);
  auto shared_rows = [&]() {  // the other parts' writes of the last product
    if (parts > 1) cluster_sync();
  };
  const int nz = d.n_z, nzc = d.n_z + d.n_cond, n_x = d.n_x;
  const float* xb = x + (size_t)row0 * d.n_in;
  float* buf0 = ws + (size_t)row0 * ldh;
  float* buf1 = ws + (size_t)batch * ldh + (size_t)row0 * ldh;
  for (int i = threadIdx.x; i < TM * 32; i += kThreads) red[i] = 0.f;

  // The encoder: h1 = softplus(x W1 + b1) in buf0, h2 in buf1.
  softplus_stack<TM, BF16>(
      xb, d.n_in, d.n_in, 2,
      [&](int i) {
        return i == 0 ? StackLayer{wt.p[0], wt.p[1], buf0, d.h1e, ldh}
                      : StackLayer{wt.p[2], wt.p[3], buf1, d.h2e, ldh};
      },
      valid, ring, part, parts);
  shared_rows();
  // Every part is past h2's product, so h1's buffer takes the decoder
  // input: the cond columns now, z in logvar's epilogue.
  for (int i = threadIdx.x; part == 0 && i < valid * d.n_cond; i += kThreads) {
    const int r = i / d.n_cond, c = i - r * d.n_cond;
    buf0[(size_t)r * ldh + nz + c] = xb[(size_t)r * d.n_in + n_x + c];
  }
  // The heads: two N = n_z products, so the thread that wrote mu[r, j]
  // computes logvar[r, j], then eps, z = mu + exp(logvar / 2) eps.
  float* mu = mu_out + (size_t)row0 * nz;
  float* lv = lv_out + (size_t)row0 * nz;
  auto head_mu = [&](int r, int j, float y) {
    if (r < valid) mu[(size_t)r * nz + j] = y + __ldg(wt.p[5] + j);
  };
  dense_rows<TM, BF16, false, true>(buf1, nullptr, ldh, valid, wt.p[4], d.h2e, nz, ring,
                                    head_mu, part, parts);
  auto head_lv = [&](int r, int j, float y) {
    if (r < valid) {
      const size_t at = (size_t)r * nz + j;
      const float l = y + __ldg(wt.p[7] + j);
      lv[at] = l;
      const size_t g = (size_t)row0 * nz + at;
      const float e = eps_in != nullptr
                          ? eps_in[g]
                          : vae::philox_normal(seed_at != nullptr ? *seed_at : seed, row0 + r, j);
      eps_out[g] = e;
      buf0[(size_t)r * ldh + j] = mu[at] + expf(0.5f * l) * e;
    }
  };
  dense_rows<TM, BF16, false, true>(buf1, nullptr, ldh, valid, wt.p[6], d.h2e, nz, ring,
                                    head_lv, part, parts);
  shared_rows();
  // KL per row, one warp a row in a fixed order.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; part == 0 && r < valid; r += kThreads / 32) {
    const float s = vae::warp_sum_of(nz, [&](int j) {
      const float m = mu[(size_t)r * nz + j], l = lv[(size_t)r * nz + j];
      return 1.f + l - m * m - expf(l);
    });
    if (lane == 0) kl_out[row0 + r] = -0.5f * s;
  }

  // The decoder: g1 = softplus([z, cond] D1 + c1) in buf1, g2 in buf0.
  softplus_stack<TM, BF16>(
      buf0, ldh, nzc, 2,
      [&](int i) {
        return i == 0 ? StackLayer{wt.p[8], wt.p[9], buf1, d.h1d, ldh}
                      : StackLayer{wt.p[10], wt.p[11], buf0, d.h2d, ldh};
      },
      valid, ring, part, parts);
  shared_rows();
  // r = g2 Do + co and the per-element loss in the epilogue; r is never
  // stored. Each thread adds its elements of a row to its own partial.
  const int peer = dense_row_peer<TM, BF16>();
  auto loss = [&](int r, int j, float y) {
    if (r < valid) {
      const float v = y + __ldg(wt.p[13] + j);
      const float xv = __ldg(xb + (size_t)r * d.n_in + j);
      float e;
      if (bernoulli) {
        e = fmaxf(v, 0.f) - v * xv + log1pf(expf(-fabsf(v)));
      } else {
        const float t = xv - v;
        e = t * t;
      }
      red[r * 32 + peer] += e;
    }
  };
  dense_rows<TM, BF16, false, true>(buf0, nullptr, ldh, valid, wt.p[12], d.h2d, n_x, ring,
                                    loss, part, parts);
  // Each part's sum per row over its column tiles, peers in order; then
  // part 0 adds the others' in part order.
  for (int r = warp; r < valid; r += kThreads / 32) {
    const float s = vae::warp_sum_of(32, [&](int c) { return red[r * 32 + c]; });
    if (lane == 0) {
      if (part == 0)
        rec_out[row0 + r] = s;
      else
        rec_parts[(size_t)(part - 1) * batch + row0 + r] = s;
    }
  }
  if (parts > 1) {
    cluster_sync();
    for (int r = threadIdx.x; part == 0 && r < valid; r += kThreads) {
      float s = rec_out[row0 + r];
      for (int p = 1; p < parts; ++p) s += rec_parts[(size_t)(p - 1) * batch + row0 + r];
      rec_out[row0 + r] = s;
    }
  }
}

template <bool BF16>
const void* fwd_kernel(int tm) {
  return tm == 16   ? (const void*)mega_fwd<16, BF16>
         : tm == 32 ? (const void*)mega_fwd<32, BF16>
                    : (const void*)mega_fwd<64, BF16>;
}

struct BwdWeights {
  const float *d1, *c1, *d2, *c2, *wo, *co;  // d1 [n_z + n_cond, h1d] ... wo = do [h2d, n_x]
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

// Shared memory of the backward (kernels/megakernel.py::dec_bwd_plan): the
// ring of its largest product mode, W^T with A streamed.
__host__ __device__ constexpr int bwd_smem(int tm, bool bf16) {
  return dense_ring_bytes(tm, true, true, bf16);
}

// `parts` blocks (a cluster, consecutive in x) own TM rows and run the five
// products in turn (dense_tile.cuh, which also holds cluster_sync and
// dsoftplus), each taking every parts-th column tile, each A streamed back
// from the scratch these blocks wrote before the barrier that ends the last
// product. Parts > 1 only where the batch leaves
// SMs idle: each block then streams its share of the weights. At 64 rows
// two blocks share an SM (at most 128 registers a thread, a 114 KB ring),
// so one block's barriers and waits overlap the other's products.
template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads, TM == 64 ? 2 : 1)
    mega_dec_loss_bwd(const float* __restrict__ x, const float* __restrict__ z,
                      const float* __restrict__ grec, int batch, BwdWeights wt,
                      BwdScratch s, BwdDims d, int bernoulli, float* __restrict__ dz,
                      int parts) {
  extern __shared__ __align__(16) float ring[];
  const int part = blockIdx.x % parts;
  const int row0 = blockIdx.x / parts * TM;
  const int valid = min(TM, batch - row0);
  auto shared_rows = [&]() {  // the other parts' writes of the last stage
    if (parts > 1) cluster_sync();
  };
  const int nz = d.n_z, nzc = d.n_z + d.n_cond, n_x = d.n_x, h1d = d.h1d, h2d = d.h2d;
  float* zin = s.zin + (size_t)row0 * nzc;
  float* g1 = s.g1 + (size_t)row0 * h1d;
  float* g2 = s.g2 + (size_t)row0 * h2d;
  float* dr = s.dr + (size_t)row0 * n_x;
  float* db2d = s.db2d + (size_t)row0 * h2d;
  float* db1d = s.db1d + (size_t)row0 * h1d;
  const float* xb = x + (size_t)row0 * d.n_in;

  // The decoder input [z, cond], by the first part.
  for (int i = threadIdx.x; part == 0 && i < valid * nzc; i += kThreads) {
    const int r = i / nzc, k = i - r * nzc;
    zin[i] = k < nz ? z[(size_t)(row0 + r) * nz + k] : xb[(size_t)r * d.n_in + n_x + (k - nz)];
  }
  __syncthreads();
  shared_rows();
  // The rematerialized decoder: g1 = softplus([z, cond] D1 + c1), g2.
  softplus_stack<TM, BF16>(
      zin, nzc, nzc, 2,
      [&](int i) {
        return i == 0 ? StackLayer{wt.d1, wt.c1, g1, h1d, h1d}
                      : StackLayer{wt.d2, wt.c2, g2, h2d, h2d};
      },
      valid, ring, part, parts);
  shared_rows();
  // r = g2 Do + co, and dL/dr in the epilogue; r itself is never stored.
  auto edr = [&](int r, int j, float y) {
    if (r < valid) {
      const float v = y + __ldg(wt.co + j);
      const float xv = __ldg(xb + (size_t)r * d.n_in + j);
      const float gr = __ldg(grec + row0 + r);
      dr[(size_t)r * n_x + j] = bernoulli ? (vae::sigmoid(v) - xv) * gr : 2.f * (v - xv) * gr;
    }
  };
  dense_rows<TM, BF16, false, true>(g2, nullptr, h2d, valid, wt.wo, h2d, n_x, ring,
                                    edr, part, parts);
  shared_rows();
  // db2d = (dr Do^T) * sigmoid(b2d), sigmoid from the saved g2.
  auto e3 = [&](int r, int j, float y) {
    if (r < valid) db2d[(size_t)r * h2d + j] = y * dsoftplus(g2[(size_t)r * h2d + j]);
  };
  dense_rows<TM, BF16, true, true>(dr, nullptr, n_x, valid, wt.wo, n_x, h2d, ring, e3, part, parts);
  shared_rows();
  // db1d = (db2d D2^T) * sigmoid(b1d).
  auto e4 = [&](int r, int j, float y) {
    if (r < valid) db1d[(size_t)r * h1d + j] = y * dsoftplus(g1[(size_t)r * h1d + j]);
  };
  dense_rows<TM, BF16, true, true>(db2d, nullptr, h2d, valid, wt.d2, h2d, h1d, ring,
                                   e4, part, parts);
  shared_rows();
  // dz = db1d D1^T, the z columns only (D1's first n_z rows).
  auto edz = [&](int r, int j, float y) {
    if (r < valid) dz[(size_t)(row0 + r) * nz + j] = y;
  };
  dense_rows<TM, BF16, true, true>(db1d, nullptr, h1d, valid, wt.d1, h1d, nz, ring, edz, part,
                                   parts);
}

template <bool BF16>
const void* bwd_kernel(int tm) {
  return tm == 16   ? (const void*)mega_dec_loss_bwd<16, BF16>
         : tm == 32 ? (const void*)mega_dec_loss_bwd<32, BF16>
                    : (const void*)mega_dec_loss_bwd<64, BF16>;
}

}  // namespace

// Forward of one tower over x [batch, n_in] (fp32, the cond columns last).
// `weights` holds the 14 device pointers in the order of FwdWeights, `dims`
// the eight widths of FwdDims. eps_in [batch, n_z] injects eps; when it is
// null, eps is drawn from the seed: *seed_at where seed_at (device memory)
// is not null, else `seed`. Outputs: mu, lv, eps_out [batch, n_z],
// rec, kl [batch]. ws: the workspace, two buffers [batch, ldh], ldh a
// multiple of 4 and at least every hidden width and n_z + n_cond;
// rec_parts: (parts - 1) * batch floats (null for one part). `tile_rows`
// (16, 32 or 64), `smem` and `parts` (1, 2, 4 or 8 blocks, a cluster, per
// row tile) are kernels/megakernel.py::fwd_plan's. Launches on `stream`
// without synchronising and returns the launch's CUDA error.
extern "C" int vae_mega_fwd(const void* x, int batch, const void* const* weights,
                            const int* dims, int bernoulli, const void* eps_in,
                            const void* seed_at, unsigned long long seed, void* mu, void* lv,
                            void* eps_out, void* rec, void* kl, void* ws, int ldh,
                            void* rec_parts, int tile_rows, int smem, int parts, int bf16,
                            void* stream) {
  FwdDims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7]};
  if (batch <= 0 || d.n_z <= 0 || d.n_cond < 0 || d.h1e <= 0 || d.h2e <= 0 || d.h1d <= 0 ||
      d.h2d <= 0 || d.n_x <= 0 || d.n_in != d.n_x + d.n_cond || ws == nullptr ||
      ldh % 4 != 0 || ldh < d.h1e || ldh < d.h2e || ldh < d.h1d || ldh < d.h2d ||
      ldh < d.n_z + d.n_cond ||
      (tile_rows != 16 && tile_rows != 32 && tile_rows != 64) ||
      (parts != 1 && parts != 2 && parts != 4 && parts != 8) ||
      (parts > 1) != (rec_parts != nullptr) ||
      smem != fwd_smem(tile_rows, bf16 != 0) || smem > vae::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  FwdWeights wt;
  for (int i = 0; i < 14; ++i) wt.p[i] = static_cast<const float*>(weights[i]);
  const void* fn = bf16 ? fwd_kernel<true>(tile_rows) : fwd_kernel<false>(tile_rows);
  int per_sm = 0;
  cudaError_t e = vae::launch_info(fn, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const auto* xs = static_cast<const float*>(x);
  const auto* ein = static_cast<const float*>(eps_in);
  const auto* sat = static_cast<const unsigned long long*>(seed_at);
  auto* o_mu = static_cast<float*>(mu);
  auto* o_lv = static_cast<float*>(lv);
  auto* o_eps = static_cast<float*>(eps_out);
  auto* o_rec = static_cast<float*>(rec);
  auto* o_kl = static_cast<float*>(kl);
  auto* w = static_cast<float*>(ws);
  auto* rp = static_cast<float*>(rec_parts);
  void* args[] = {&xs, &batch, &wt, &d, &bernoulli, &ein, &sat, &seed, &o_mu,
                  &o_lv, &o_eps, &o_rec, &o_kl, &w, &ldh, &rp, &parts};
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

// Per-row half of the decoder+loss backward. x [batch, n_in] (cond columns
// last), z [batch, n_z], grec [batch] (the cotangent of rec). `weights`:
// the 6 device pointers d1 [n_z + n_cond, h1d] c1 d2 [h1d, h2d] c2
// do [h2d, n_x] co; `scratch`: the 6 of BwdScratch; `dims`: n_in, n_z,
// n_cond, h1d, h2d, n_x. Writes dz [batch, n_z] and the scratch.
// `tile_rows` (16, 32 or 64) and `smem` are kernels/megakernel.py::
// dec_bwd_plan's; `parts` (1 or 2, kernels/megakernel.py::dec_bwd_parts)
// blocks, a cluster, share each tile's rows. Launches on `stream` without
// synchronising and returns the launch's CUDA error.
extern "C" int vae_mega_dec_loss_bwd(const void* x, const void* z,
                                     const void* grec, int batch,
                                     const void* const* weights,
                                     void* const* scratch, const int* dims,
                                     int bernoulli, void* dz, int tile_rows,
                                     int smem, int parts, int bf16, void* stream) {
  if (batch <= 0 || (tile_rows != 16 && tile_rows != 32 && tile_rows != 64) ||
      (parts != 1 && parts != 2) ||
      smem != bwd_smem(tile_rows, bf16 != 0) || smem > vae::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  BwdWeights wt{w[0], w[1], w[2], w[3], w[4], w[5]};
  BwdScratch s{static_cast<float*>(scratch[0]), static_cast<float*>(scratch[1]),
               static_cast<float*>(scratch[2]), static_cast<float*>(scratch[3]),
               static_cast<float*>(scratch[4]), static_cast<float*>(scratch[5])};
  BwdDims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5]};
  if (d.n_z <= 0 || d.n_cond < 0 || d.h1d <= 0 || d.h2d <= 0 || d.n_x <= 0 ||
      d.n_in != d.n_x + d.n_cond)
    return (int)cudaErrorInvalidValue;
  const void* fn = bf16 ? bwd_kernel<true>(tile_rows) : bwd_kernel<false>(tile_rows);
  int per_sm = 0;
  cudaError_t e = vae::launch_info(fn, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const auto* xs = static_cast<const float*>(x);
  const auto* zs = static_cast<const float*>(z);
  const auto* gs = static_cast<const float*>(grec);
  auto* o_dz = static_cast<float*>(dz);
  void* args[] = {&xs, &zs, &gs, &batch, &wt, &s, &d, &bernoulli, &o_dz, &parts};
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
