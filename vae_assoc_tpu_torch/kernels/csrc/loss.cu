// The fused joint-loss kernels on Hopper (sm_90a): the per-sample loss
// terms of all K modalities in one launch, and their closed-form backward
// in another.
//
// loss_fwd replaces the Pallas TPU kernel
// vae_assoc_tpu/kernels/loss.py::_loss_kernel. It writes the per-sample
// matrix out [B, 2K (+1)]: recon_k (Bernoulli logit cross-entropy
// max(r, 0) - r x + log1p(exp(-|r|)), or Gaussian squared error (x - r)^2,
// summed over the D_k features), kl_k = -1/2 sum(1 + lv - mu^2 - e^lv),
// and, with the association column, sum_{i<j} |mu_i - mu_j|^2. One warp
// owns one (row, column) cell and sums it with common.cuh::warp_sum_of, in
// a fixed order, so the same inputs give the same bits. All in fp32: the
// reference casts every input to fp32.
//
// loss_bwd replaces the TPU kernel's custom-VJP backward,
// loss.py::_loss_bwd_kernel: per modality, elementwise over [B, D_k],
//   drecon = (sigmoid(r) - x) g_rec   or   2 (r - x) g_rec,
// and over [B, n_z],
//   dmu = mu g_kl (+ sum_{j != i} 2 (mu_i - mu_j) g_assoc),
//   dlogvar = 1/2 (e^lv - 1) g_kl.
// The data gradient dx is not a kernel output: the wrapper derives it in
// torch, and only when a caller asks for it (kernels/loss.py).
//
// What bounds them on this card. Both are memory-bound: at the config-3
// widths loss_fwd reads about 8.2 KB per row (x and r of both modalities,
// four [n_z] vectors) and writes 20 bytes, about 2.5 us at batch 1024;
// loss_bwd reads that and the cotangent row and writes about 4.2 KB, about
// 3.8 us. Consecutive lanes read consecutive floats (one warp per row for
// loss_fwd, one thread per element for loss_bwd), so the reads coalesce.
// Launch overhead is of the same order at batch 1024.

#include "common.cuh"

namespace {

using vae::kThreads;

constexpr int kMaxMods = 8;

struct LossMod {
  const float* x;   // [B, d] data
  const float* r;   // [B, d] decoder output (logits or means)
  const float* mu;  // [B, n_z]
  const float* lv;  // [B, n_z]
  float* dr;        // [B, d] (backward only)
  float* dmu;       // [B, n_z] (backward only)
  float* dlv;       // [B, n_z] (backward only)
  int d;
  int bern;  // 1: Bernoulli logits, 0: Gaussian means
};

struct LossTable {
  LossMod m[kMaxMods];
};

__global__ void __launch_bounds__(kThreads)
    loss_fwd(LossTable t, int k, int batch, int n_z, int ncols,
             float* __restrict__ out) {
  // One warp per (row, column); the warp index is uniform in a warp, so a
  // warp past the end leaves as a whole.
  const long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (w >= (long long)batch * ncols) return;
  const int row = (int)(w / ncols);
  const int col = (int)(w - (long long)row * ncols);
  float s;
  if (col < k) {
    const LossMod& M = t.m[col];
    const float* x = M.x + (size_t)row * M.d;
    const float* r = M.r + (size_t)row * M.d;
    if (M.bern) {
      s = vae::warp_sum_of(M.d, [&](int j) {
        const float l = r[j];
        return fmaxf(l, 0.f) - l * x[j] + log1pf(expf(-fabsf(l)));
      });
    } else {
      s = vae::warp_sum_of(M.d, [&](int j) {
        const float e = x[j] - r[j];
        return e * e;
      });
    }
  } else if (col < 2 * k) {
    const LossMod& M = t.m[col - k];
    const float* mu = M.mu + (size_t)row * n_z;
    const float* lv = M.lv + (size_t)row * n_z;
    s = -0.5f * vae::warp_sum_of(n_z, [&](int j) {
      const float m = mu[j], v = lv[j];
      return 1.f + v - m * m - expf(v);
    });
  } else {
    s = 0.f;
    for (int i = 0; i < k; ++i) {
      for (int j = i + 1; j < k; ++j) {
        const float* a = t.m[i].mu + (size_t)row * n_z;
        const float* b = t.m[j].mu + (size_t)row * n_z;
        s += vae::warp_sum_of(n_z, [&](int c) {
          const float e = a[c] - b[c];
          return e * e;
        });
      }
    }
  }
  if ((threadIdx.x & 31) == 0) out[(size_t)row * ncols + col] = s;
}

// Grid: y over the modalities; x strides over the modality's B * d
// drecon elements, then its B * n_z (dmu, dlogvar) elements.
__global__ void __launch_bounds__(kThreads)
    loss_bwd(LossTable t, int k, int batch, int n_z, int ncols, int with_assoc,
             const float* __restrict__ g) {
  const int m = blockIdx.y;
  const LossMod& M = t.m[m];
  const long long n_rec = (long long)batch * M.d;
  const long long total = n_rec + (long long)batch * n_z;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    if (i < n_rec) {
      const int row = (int)(i / M.d);
      const float gr = g[(size_t)row * ncols + m];
      const float r = M.r[i], x = M.x[i];
      M.dr[i] = M.bern ? (vae::sigmoid(r) - x) * gr : 2.f * (r - x) * gr;
    } else {
      const long long e = i - n_rec;
      const int row = (int)(e / n_z);
      const float gkl = g[(size_t)row * ncols + k + m];
      const float mu = M.mu[e];
      float dmu = mu * gkl;
      if (with_assoc) {
        const float gas = g[(size_t)row * ncols + 2 * k];
        for (int j = 0; j < k; ++j) {
          if (j != m) dmu += 2.f * (mu - t.m[j].mu[e]) * gas;
        }
      }
      M.dmu[e] = dmu;
      M.dlv[e] = 0.5f * (expf(M.lv[e]) - 1.f) * gkl;
    }
  }
}

// `mods` holds k rows of 9 int64 values (x, r, mu, lv, dr, dmu, dlv, d,
// bern) as LossMod; the backward pointers may be 0 for the forward.
bool fill_table(LossTable* t, const long long* mods, int k) {
  if (k < 1 || k > kMaxMods) return false;
  for (int i = 0; i < k; ++i) {
    const long long* row = mods + 9 * i;
    LossMod& M = t->m[i];
    M.x = reinterpret_cast<const float*>(row[0]);
    M.r = reinterpret_cast<const float*>(row[1]);
    M.mu = reinterpret_cast<const float*>(row[2]);
    M.lv = reinterpret_cast<const float*>(row[3]);
    M.dr = reinterpret_cast<float*>(row[4]);
    M.dmu = reinterpret_cast<float*>(row[5]);
    M.dlv = reinterpret_cast<float*>(row[6]);
    M.d = (int)row[7];
    M.bern = (int)row[8];
    if (M.d <= 0) return false;
  }
  return true;
}

}  // namespace

// out [batch, 2k + with_assoc] from the k modalities of `mods` (see
// fill_table); every tensor fp32 and row-major.
extern "C" int vae_loss_fwd(const long long* mods, int k, int batch, int n_z,
                            int with_assoc, void* out, void* stream) {
  LossTable t;
  if (batch <= 0 || n_z <= 0 || !fill_table(&t, mods, k))
    return (int)cudaErrorInvalidValue;
  const int ncols = 2 * k + (with_assoc ? 1 : 0);
  const long long warps = (long long)batch * ncols;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  loss_fwd<<<(unsigned)blocks, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(t, k, batch, n_z, ncols,
                                                  static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// dr, dmu, dlv of the k modalities of `mods` from the cotangent
// g [batch, 2k + with_assoc] of the per-sample loss matrix.
extern "C" int vae_loss_bwd(const long long* mods, int k, int batch, int n_z,
                            int with_assoc, const void* g, void* stream) {
  LossTable t;
  if (batch <= 0 || n_z <= 0 || !fill_table(&t, mods, k))
    return (int)cudaErrorInvalidValue;
  const int ncols = 2 * k + (with_assoc ? 1 : 0);
  long long widest = 0;
  for (int i = 0; i < k; ++i) {
    const long long n = (long long)batch * (t.m[i].d + n_z);
    if (n > widest) widest = n;
  }
  long long blocks = (widest + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  loss_bwd<<<dim3((unsigned)blocks, (unsigned)k), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
      t, k, batch, n_z, ncols, with_assoc, static_cast<const float*>(g));
  return (int)cudaGetLastError();
}
