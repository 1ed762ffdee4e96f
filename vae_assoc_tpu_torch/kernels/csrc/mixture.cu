// Sketch-RNN's reconstruction loss and its gradient in one pass
// (mixture_loss, for kernels/mixture.py): one warp per row of the head's
// output y [rows, 3 + 6 M] and its target (dx, dy, p1, p2, p3).
//
//   pen logits y[0:3]; then six groups of M: pi (softmax), mu_x, mu_y,
//   sigma_x = exp, sigma_y = exp, rho = tanh
//   N_j = exp(-Z_j / (2 (1 - rho_j^2))) / (2 pi s_x s_y sqrt(1 - rho_j^2)),
//   Z_j = n_x^2 + n_y^2 - 2 rho_j n_x n_y, n = (d - mu) / s
//   loss = -log(sum_j pi_j N_j + 1e-6) (1 - p3) + CE(pen logits, (p1, p2, p3))
//
// Lane j < M holds component j, lanes 0..2 the pen logits; the sums over a
// row are warp shuffles in a fixed order, so the same inputs give the same
// bits. dy is the gradient of the row's loss with respect to y.

#include "common.cuh"

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kEps = 1e-6f;
constexpr float kBig = 3.402823466e38f;  // -kBig: the max's identity for idle lanes

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ float warp_max(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

__global__ void __launch_bounds__(vae::kThreads)
    mixture_loss(const float* __restrict__ y, const float* __restrict__ tgt, int rows, int m,
                 float* __restrict__ loss, float* __restrict__ dy) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (vae::kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const int width = 3 + 6 * m;
  const float* yr = y + (size_t)row * width;
  const float* tr = tgt + (size_t)row * 5;
  const float x1 = tr[0], x2 = tr[1], mask = 1.f - tr[4];
  const bool comp = lane < m;
  const float a = comp ? yr[3 + lane] : -kBig;
  const float amax = warp_max(a);
  const float ea = comp ? expf(a - amax) : 0.f;
  const float pi = ea / warp_sum(ea);
  float pn = 0.f, n1 = 0.f, n2 = 0.f, rho = 0.f, q = 1.f, s1 = 1.f, s2 = 1.f, z = 0.f;
  if (comp) {
    const float mu1 = yr[3 + m + lane], mu2 = yr[3 + 2 * m + lane];
    s1 = expf(yr[3 + 3 * m + lane]);
    s2 = expf(yr[3 + 4 * m + lane]);
    rho = tanhf(yr[3 + 5 * m + lane]);
    n1 = (x1 - mu1) / s1;
    n2 = (x2 - mu2) / s2;
    q = 1.f - rho * rho;
    z = n1 * n1 + n2 * n2 - 2.f * rho * n1 * n2;
    const float nj = expf(-z / (2.f * q)) / (kTwoPi * (s1 * s2) * sqrtf(q));
    pn = pi * nj;
  }
  const float s = warp_sum(pn);
  // The pen state's cross-entropy over lanes 0..2.
  const bool pen = lane < 3;
  const float l = pen ? yr[lane] : -kBig;
  const float lmax = warp_max(l);
  const float el = pen ? expf(l - lmax) : 0.f;
  const float esum = warp_sum(el), lse = logf(esum);
  const float p = pen ? tr[2 + lane] : 0.f;
  const float ce = warp_sum(pen ? -p * (l - lmax - lse) : 0.f);
  const float psum = warp_sum(p);
  if (lane == 0) loss[row] = -logf(s + kEps) * mask + ce;
  float* dr = dy + (size_t)row * width;
  if (pen) dr[lane] = el / esum * psum - p;
  if (comp) {
    const float coef = -mask / (s + kEps);
    const float w = coef * pn;
    dr[3 + lane] = coef * (pn - pi * s);
    dr[3 + m + lane] = w * (n1 - rho * n2) / (q * s1);
    dr[3 + 2 * m + lane] = w * (n2 - rho * n1) / (q * s2);
    dr[3 + 3 * m + lane] = w * ((n1 * n1 - rho * n1 * n2) / q - 1.f);
    dr[3 + 4 * m + lane] = w * ((n2 * n2 - rho * n1 * n2) / q - 1.f);
    dr[3 + 5 * m + lane] = w * (n1 * n2 - z * rho / q + rho);
  }
}

}  // namespace

// The loss of each of `rows` rows of y [rows, 3 + 6 m] (fp32, row-major)
// against tgt [rows, 5] into loss [rows], and its gradient into dy [rows,
// 3 + 6 m]; m in [1, 32]. Launches on `stream` without synchronising and
// returns the launch's CUDA error.
extern "C" int vae_mixture_loss(const void* y, const void* tgt, int rows, int m, void* loss,
                                void* dy, void* stream) {
  if (rows <= 0 || m < 1 || m > 32) return (int)cudaErrorInvalidValue;
  const int per_block = vae::kThreads / 32;
  mixture_loss<<<(rows + per_block - 1) / per_block, vae::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(tgt), rows, m,
      static_cast<float*>(loss), static_cast<float*>(dy));
  return (int)cudaGetLastError();
}
