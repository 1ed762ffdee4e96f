// The conv image tower's linear primitive and its weight gradient, on Hopper
// (sm_90a).
//
// conv_fwd replaces two Pallas TPU kernels that compute the same function:
// vae_assoc_tpu/kernels/conv.py::_fwd_kernel (im2col: 9 per-tap matmuls)
// and vae_assoc_tpu/kernels/conv_banded.py::_banded_fwd_kernel (3 banded
// matmuls against band matrices built for the TPU's 128-lane layout, which
// this card does not have). Both compute, over NHWC x and a [9 cin, cout]
// weight (the HWIO kernel flattened),
//   y[b, oy, ox, :] = sum_{ky, kx, c} w[(3 ky + kx) cin + c, :]
//                     * xt[b, s oy + ky, s ox + kx, c],
// where xt is x dilated x2 with zeros when `dilate`, then padded (lo, hi).
// One kernel serves every conv of the tower: the stride-2 conv (s = 2, pads
// (0, 1)), the transposed conv (a x2-dilated stride-1 conv, pads (2, 1),
// kernel not flipped) and both of their input gradients (the flipped,
// channel-transposed weight with the mapped stride and pads; the wrapper,
// kernels/conv.py, picks them). conv_dw replaces
// vae_assoc_tpu/kernels/conv.py::_dw_kernel: dw = sum over every output
// pixel of patch^T . dy.
//
// What bounds them on this card. In the tower's main layer, conv2 at
// B = 1024, conv_fwd does 1.85 GFLOP against 38.5 MB of input and output:
// 28 us of fp32 FMAs at 67 TFLOP/s, 11.5 us of memory, so arithmetic bounds
// it; conv1 (cin = 1) moves 28.9 MB for 56 k FMAs per image and is bound by
// memory. conv_dw on conv2 is compute-bound the same way.
//
// What the design does about it (an implicit GEMM, simple first):
// - conv_fwd: each block owns tiles of TP output pixels times all cout
//   channels and keeps the whole rounded weight in shared memory (at most
//   576 x 32 floats = 73,728 B). It walks the 9 cin patch columns in chunks
//   of 64, gathering each chunk of the TP patches from device memory (the
//   im2col matrix is never written) and padding and dilating on the fly.
//   Each thread accumulates R pixels x up to 4 channels in registers.
//   Blocks are persistent over tiles, so the weight is loaded once a block.
// - The dilated modes multiply the zeros the dilation inserts: the
//   transposed convs do about 4x their useful work. Skipping them (a
//   sub-pixel decomposition) is later work.
// - conv_dw: a block owns a tile of patch columns times all cout and loops
//   over a fixed chunk of output pixels in slices of 16, gathering the patch
//   slice and the dy slice into shared memory. With more than one chunk,
//   each chunk writes a partial and a second kernel adds the partials in
//   chunk order: no atomics, so the same inputs give the same bits (the
//   scheme of vae_wgrad in mlp_bwd.cu).
// - Geometry (stride, dilation, pads, sizes) and dtype are runtime
//   arguments: no template instances. With bf16 both operands are rounded
//   to bf16 when staged in shared memory and the products add in fp32, the
//   reference's _mm policy.
// Tensor cores (wgmma), TMA and skipping the dilation zeros are later work.

#include "common.cuh"

namespace {

using vae::kThreads;

constexpr int kMaxRows = 8;   // rows (pixels or patch columns) a thread owns
constexpr int kMaxCh = 4;     // channels a thread owns
constexpr int kChunk = 64;    // patch columns per gathered chunk (conv_fwd)
constexpr int kSlice = 16;    // output pixels per slice (conv_dw)
constexpr int kDwRows = 4;    // patch columns a thread owns (conv_dw)
constexpr int kMaxCout = 64;

struct Geom {
  int batch, h, w, cin, cout;
  int stride, dilate, lo;
  int hd, wd;  // the input's size after dilation
  int out_hw;  // oh == ow
};

__device__ __forceinline__ float rnd(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

// Channels a thread owns and the number of channel threads (a power of two
// covering cout), shared by both kernels and by kernels/conv.py's plans.
__host__ __device__ inline int chans_per_thread(int cout) {
  return cout >= kMaxCh ? kMaxCh : cout;
}
__host__ __device__ inline int chan_threads(int cout) {
  const int rc = chans_per_thread(cout);
  const int need = (cout + rc - 1) / rc;
  int ct = 1;
  while (ct < need) ct *= 2;
  return ct;
}

// Per output pixel m: the image's offset in x and the padded coordinates of
// its patch's top-left tap.
struct RowInfo {
  int base, py, px;
};

__device__ __forceinline__ RowInfo row_info(const Geom& g, int m) {
  const int per_img = g.out_hw * g.out_hw;
  const int b = m / per_img;
  const int rem = m - b * per_img;
  const int oy = rem / g.out_hw;
  const int ox = rem - oy * g.out_hw;
  return {b * g.h * g.w * g.cin, g.stride * oy, g.stride * ox};
}

// Patch column k packed as (ky, kx, c).
__device__ __forceinline__ int col_info(const Geom& g, int k) {
  const int tap = k / g.cin;
  const int c = k - tap * g.cin;
  return (tap / 3) | ((tap % 3) << 2) | (c << 4);
}

// xt at (py + ky, px + kx, c): zero in the padding and at dilation zeros.
__device__ __forceinline__ float patch_value(const float* __restrict__ x,
                                             const Geom& g, RowInfo r,
                                             int col) {
  int y = r.py + (col & 3) - g.lo;
  int xx = r.px + ((col >> 2) & 3) - g.lo;
  if (y < 0 || xx < 0 || y >= g.hd || xx >= g.wd) return 0.f;
  if (g.dilate) {
    if ((y | xx) & 1) return 0.f;
    y >>= 1;
    xx >>= 1;
  }
  return __ldg(x + (size_t)r.base + ((size_t)y * g.w + xx) * g.cin +
               (col >> 4));
}

__global__ void __launch_bounds__(kThreads)
    conv_fwd(const float* __restrict__ x, const float* __restrict__ w2d,
             float* __restrict__ y, Geom g, int rp, int ntiles, int bf16) {
  extern __shared__ __align__(16) float smem[];
  const int K = 9 * g.cin;
  const int rc = chans_per_thread(g.cout);
  const int ct = chan_threads(g.cout);
  const int rt = kThreads / ct;
  const int tp = rt * rp;
  const int ld = kChunk + 1;
  float* ws = smem;                                 // [K, cout], rounded
  float* xs = ws + K * g.cout;                      // [tp, ld] patch chunk
  int* cols = reinterpret_cast<int*>(xs + tp * ld);  // [K]
  RowInfo* rows = reinterpret_cast<RowInfo*>(cols + K);  // [tp]
  for (int i = threadIdx.x; i < K * g.cout; i += kThreads)
    ws[i] = rnd(w2d[i], bf16);
  for (int k = threadIdx.x; k < K; k += kThreads) cols[k] = col_info(g, k);
  const int M = g.batch * g.out_hw * g.out_hw;
  const int cx = threadIdx.x % ct, pr = threadIdx.x / ct;
  const int co0 = cx * rc;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = tile * tp;
    __syncthreads();  // the previous tile is done with rows and xs
    for (int p = threadIdx.x; p < tp; p += kThreads)
      rows[p] = m0 + p < M ? row_info(g, m0 + p) : RowInfo{-1, 0, 0};
    float acc[kMaxRows][kMaxCh];
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i)
#pragma unroll
      for (int j = 0; j < kMaxCh; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kc = min(kChunk, K - k0);
      __syncthreads();  // rows, cols and ws ready; xs free
      for (int i = threadIdx.x; i < tp * kc; i += kThreads) {
        const int p = i / kc;
        const int kk = i - p * kc;
        const RowInfo r = rows[p];
        xs[p * ld + kk] =
            r.base >= 0 ? rnd(patch_value(x, g, r, cols[k0 + kk]), bf16) : 0.f;
      }
      __syncthreads();
      if (co0 < g.cout) {
        for (int kk = 0; kk < kc; ++kk) {
          const float* wrow = ws + (k0 + kk) * g.cout + co0;
          float wv[kMaxCh];
#pragma unroll
          for (int j = 0; j < kMaxCh; ++j)
            wv[j] = j < rc && co0 + j < g.cout ? wrow[j] : 0.f;
#pragma unroll
          for (int i = 0; i < kMaxRows; ++i) {
            if (i < rp) {
              const float a = xs[(pr + i * rt) * ld + kk];
#pragma unroll
              for (int j = 0; j < kMaxCh; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      const int m = m0 + pr + i * rt;
      if (i >= rp || m >= M) continue;
#pragma unroll
      for (int j = 0; j < kMaxCh; ++j) {
        const int co = co0 + j;
        if (j < rc && co < g.cout) y[(size_t)m * g.cout + co] = acc[i][j];
      }
    }
  }
}

// dw (or a chunk's partial) [K, cout] over output pixels
// [chunk * rows_per_chunk, min(M, (chunk + 1) * rows_per_chunk)).
__global__ void __launch_bounds__(kThreads)
    conv_dw(const float* __restrict__ x, const float* __restrict__ dy,
            float* __restrict__ dw, float* __restrict__ partial, Geom g,
            int rows_per_chunk, int bf16) {
  extern __shared__ __align__(16) float smem[];
  const int K = 9 * g.cin;
  const int rc = chans_per_thread(g.cout);
  const int ct = chan_threads(g.cout);
  const int rt = kThreads / ct;
  const int tk = rt * kDwRows;
  const int k0 = blockIdx.x * tk;
  const int kn = min(tk, K - k0);
  const int ld = tk + 1;
  float* ps = smem;                       // [kSlice, ld] patch slice
  float* ds = ps + kSlice * ld;           // [kSlice, cout] dy slice
  int* cols = reinterpret_cast<int*>(ds + kSlice * g.cout);  // [kn]
  RowInfo* rows = reinterpret_cast<RowInfo*>(cols + tk);     // [kSlice]
  for (int k = threadIdx.x; k < kn; k += kThreads) cols[k] = col_info(g, k0 + k);
  const int M = g.batch * g.out_hw * g.out_hw;
  const int mbeg = blockIdx.y * rows_per_chunk;
  const int mend = min(M, mbeg + rows_per_chunk);
  const int cx = threadIdx.x % ct, pr = threadIdx.x / ct;
  const int co0 = cx * rc;

  float acc[kDwRows][kMaxCh];
#pragma unroll
  for (int i = 0; i < kDwRows; ++i)
#pragma unroll
    for (int j = 0; j < kMaxCh; ++j) acc[i][j] = 0.f;
  for (int ms = mbeg; ms < mend; ms += kSlice) {
    __syncthreads();  // the previous slice is consumed
    for (int s = threadIdx.x; s < kSlice; s += kThreads)
      rows[s] = ms + s < mend ? row_info(g, ms + s) : RowInfo{-1, 0, 0};
    for (int i = threadIdx.x; i < kSlice * g.cout; i += kThreads) {
      const int s = i / g.cout;
      ds[i] = ms + s < mend ? rnd(dy[(size_t)ms * g.cout + i], bf16) : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kSlice * kn; i += kThreads) {
      const int s = i / kn;
      const int kk = i - s * kn;
      const RowInfo r = rows[s];
      ps[s * ld + kk] =
          r.base >= 0 ? rnd(patch_value(x, g, r, cols[kk]), bf16) : 0.f;
    }
    __syncthreads();
    if (co0 < g.cout) {
      for (int s = 0; s < kSlice; ++s) {
        float dv[kMaxCh];
#pragma unroll
        for (int j = 0; j < kMaxCh; ++j)
          dv[j] = j < rc && co0 + j < g.cout ? ds[s * g.cout + co0 + j] : 0.f;
#pragma unroll
        for (int i = 0; i < kDwRows; ++i) {
          const float a = ps[s * ld + pr + i * rt];  // < tk; unused past kn
#pragma unroll
          for (int j = 0; j < kMaxCh; ++j) acc[i][j] = fmaf(a, dv[j], acc[i][j]);
        }
      }
    }
  }
  float* out = partial != nullptr ? partial + (size_t)blockIdx.y * K * g.cout : dw;
#pragma unroll
  for (int i = 0; i < kDwRows; ++i) {
    const int kk = pr + i * rt;
    if (kk >= kn) continue;
#pragma unroll
    for (int j = 0; j < kMaxCh; ++j) {
      const int co = co0 + j;
      if (j < rc && co < g.cout) out[(size_t)(k0 + kk) * g.cout + co] = acc[i][j];
    }
  }
}

// Adds the chunks' partial [n] arrays in chunk order.
__global__ void __launch_bounds__(kThreads)
    dw_reduce(const float* __restrict__ partial, int chunks, int n,
              float* __restrict__ dw) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    float s = partial[i];
    for (int c = 1; c < chunks; ++c) s += partial[(size_t)c * n + i];
    dw[i] = s;
  }
}

// The geometry, or false when the kernels do not take it.
bool make_geom(int batch, int h, int w, int cin, int cout, int stride,
               int dilate, int lo, int hi, int out_hw, Geom* g) {
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 ||
      cout > kMaxCout || (stride != 1 && stride != 2) || lo < 0 || hi < 0 ||
      out_hw <= 0 || cin >= (1 << 26))
    return false;
  const int hd = dilate ? 2 * h - 1 : h;
  const int wd = dilate ? 2 * w - 1 : w;
  // Every tap of every output lies inside the padded input.
  if (stride * (out_hw - 1) + 3 > hd + lo + hi ||
      stride * (out_hw - 1) + 3 > wd + lo + hi)
    return false;
  *g = Geom{batch, h, w, cin, cout, stride, dilate ? 1 : 0, lo, hd, wd,
            out_hw};
  return true;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// y [batch, out_hw, out_hw, cout] = the conv of x [batch, h, w, cin] (NHWC,
// fp32) with w2d [9 cin, cout]: stride 1 or 2, x dilated x2 when `dilate`,
// padded (lo, hi). Launches on `stream` without synchronising and returns
// cudaGetLastError(); a geometry the kernel does not take returns
// cudaErrorInvalidValue.
extern "C" int vae_conv_fwd(const void* x, int batch, int h, int w, int cin,
                            const void* w2d, int cout, int stride, int dilate,
                            int lo, int hi, int out_hw, void* y, int bf16,
                            void* stream) {
  Geom g;
  if (!make_geom(batch, h, w, cin, cout, stride, dilate, lo, hi, out_hw, &g))
    return (int)cudaErrorInvalidValue;
  const int rt = kThreads / chan_threads(cout);
  int rp = 128 / rt;
  rp = rp < 1 ? 1 : (rp > kMaxRows ? kMaxRows : rp);
  const int tp = rt * rp;
  const int K = 9 * cin;
  const size_t smem = sizeof(float) * ((size_t)K * cout + (size_t)tp * (kChunk + 1)) +
                      sizeof(int) * K + sizeof(RowInfo) * tp;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = vae::set_smem(conv_fwd, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_fwd,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long M = (long long)batch * out_hw * out_hw;
  const int ntiles = (int)((M + tp - 1) / tp);
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  if (grid < 1) grid = 1;
  if (grid > ntiles) grid = ntiles;
  conv_fwd<<<(int)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w2d),
      static_cast<float*>(y), g, rp, ntiles, bf16);
  return (int)cudaGetLastError();
}

// dw [9 cin, cout] = sum over the output pixels of patch^T . dy for the conv
// of vae_conv_fwd with the same geometry; dy [batch, out_hw, out_hw, cout].
// The pixels split into `chunks` of `rows_per_chunk`; with chunks > 1,
// `partial` holds chunks * 9 cin * cout floats of scratch and a second
// launch adds them in order.
extern "C" int vae_conv_dw(const void* x, int batch, int h, int w, int cin,
                           const void* dy, int cout, int stride, int dilate,
                           int lo, int hi, int out_hw, int rows_per_chunk,
                           int chunks, void* dw, void* partial, int bf16,
                           void* stream) {
  Geom g;
  if (!make_geom(batch, h, w, cin, cout, stride, dilate, lo, hi, out_hw, &g))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)batch * out_hw * out_hw;
  if (chunks < 1 || rows_per_chunk < 1 ||
      (long long)rows_per_chunk * chunks < M ||
      (chunks > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rt = kThreads / chan_threads(cout);
  const int tk = rt * kDwRows;
  const int K = 9 * cin;
  const size_t smem = sizeof(float) * ((size_t)kSlice * (tk + 1) + (size_t)kSlice * cout) +
                      sizeof(int) * tk + sizeof(RowInfo) * kSlice;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = vae::set_smem(conv_dw, smem);
  if (e != cudaSuccess) return (int)e;
  auto st = static_cast<cudaStream_t>(stream);
  float* part = chunks > 1 ? static_cast<float*>(partial) : nullptr;
  const dim3 grid((K + tk - 1) / tk, chunks);
  conv_dw<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<float*>(dw), part, g, rows_per_chunk, bf16);
  e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return (int)e;
  const int n = K * cout;
  const int blocks = (n + kThreads - 1) / kThreads;
  dw_reduce<<<blocks < 1024 ? blocks : 1024, kThreads, 0, st>>>(
      part, chunks, n, static_cast<float*>(dw));
  return (int)cudaGetLastError();
}
