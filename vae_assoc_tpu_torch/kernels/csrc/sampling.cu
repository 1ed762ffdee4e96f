// The fused reparameterization sampler on Hopper (sm_90a).
//
// reparam replaces the Pallas TPU kernel
// vae_assoc_tpu/kernels/sampling.py::_reparam_kernel: it draws
// eps ~ N(0, 1) on the chip and writes z = mu + exp(logvar / 2) * eps and
// eps (the backward needs it). The TPU kernel seeds the core's own PRNG
// with a hash of the tile index; here eps[row, col] is
// common.cuh::philox_normal(seed, row, col), the counter-based Philox
// stream the tower megakernel (mega.cu) and the torch twin
// (ops/sampling.py::philox_normal) draw, so for one seed the plain, mega
// and composable paths see the same noise, whatever the launch shape. The
// seed comes by value, or through a device pointer that the kernel reads
// when it runs, so that a step captured in a CUDA graph draws a new eps on
// each replay from the seed the host wrote there before it.
//
// What bounds it on this card. Per element it reads 8 bytes and writes 8
// (320 bytes per row at n_z = 20), about 0.1 us of memory time at batch
// 1024, and the ten Philox rounds are a few dozen integer instructions:
// the launch itself dominates. One thread per element, a grid-stride loop;
// making it cheaper means fusing it into the encoder kernel (as mega_fwd
// does), which is later work. vae_empty launches a kernel that does
// nothing, so that a timing of reparam can be read against the floor of a
// launch through the same library.

#include "common.cuh"

namespace {

using vae::kThreads;

__global__ void __launch_bounds__(kThreads)
    reparam(const float* __restrict__ mu, const float* __restrict__ lv,
            int batch, int n_z, const unsigned long long* __restrict__ seed_at,
            unsigned long long seed, float* __restrict__ z, float* __restrict__ eps) {
  if (seed_at != nullptr) seed = *seed_at;
  const long long total = (long long)batch * n_z;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int row = (int)(i / n_z);
    const int col = (int)(i - (long long)row * n_z);
    const float e = vae::philox_normal(seed, (uint32_t)row, (uint32_t)col);
    eps[i] = e;
    z[i] = mu[i] + expf(0.5f * lv[i]) * e;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// z, eps [batch, n_z] from mu, logvar [batch, n_z] and the 64-bit seed:
// *seed_at where seed_at (device memory) is not null, else seed.
extern "C" int vae_reparam(const void* mu, const void* lv, int batch, int n_z,
                           const void* seed_at, unsigned long long seed, void* z,
                           void* eps, void* stream) {
  if (batch <= 0 || n_z <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)batch * n_z;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 8192) blocks = 8192;
  reparam<<<(int)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(lv), batch, n_z,
      static_cast<const unsigned long long*>(seed_at), seed, static_cast<float*>(z),
      static_cast<float*>(eps));
  return (int)cudaGetLastError();
}

// One launch of a kernel with no work: the launch floor reparam is read against.
extern "C" int vae_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
