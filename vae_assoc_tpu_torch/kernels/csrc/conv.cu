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
// conv_fwd runs a phase plan (kernels/conv.py::phase_plan), passed by value.
// In a dilated mode an output pixel of parity (oy mod 2, ox mod 2) meets
// nonzero input only at the taps whose dilated coordinate is even, so the
// plan splits the outputs into up to four parity classes, each a dense conv
// of the undilated input over 4, 2, 2 or 1 taps: 9 tap products per 4
// output pixels where multiplying the dilation's zeros took 36. A stride-2
// conv is one class of all 9 taps. blockIdx.y picks the class; the blocks
// along x are persistent over the class's tiles, so each stages its class's
// weight rows once (only those: the shared memory left is L1, where the
// taps' loads of neighbouring pixels hit). Every route is an implicit GEMM that never writes the patch
// matrix: M = the class's output pixels, N = cout, K = its taps x cin.
//
// What bounds it, and the routes (kernels/conv.py::fwd_route):
// - mma (bf16; cin a multiple of 32, cout 32 or 64). Bound by bytes: the
//   activations stay fp32 in device memory (conv2 at B = 16384 moves 616 MB,
//   0.18 ms at 3.35 TB/s, for 30 GFLOP, 0.03 ms of tensor cores). Tiles of
//   128 pixels; 8 warps of 32 pixels x cout/2 channels on mma.sync.m16n8k16
//   (bf16 operands, fp32 sums) fed by ldmatrix. The weight is staged once a
//   block as bf16 [cout][K].
// - ffma (fp32, the same shapes). Bound by fp32 FMA throughput (conv2 at
//   B = 16384: 29.6 GFLOP, 0.44 ms at 67 TFLOP/s); no TF32. Tiles of 256
//   pixels, each thread 8 pixels x cout/8 channels in registers, fragments
//   read as 16-byte shared loads (64 FMAs per 4 loads at cout 64).
//   Both tiled routes gather slices of 32 patch columns (one tap, 32
//   channels) with one address and one bounds check per (pixel, tap) and
//   16-byte loads through L1 (neighbouring pixels' taps read the same
//   input again), the next slice in registers while the current one
//   multiplies, then stored to the other of two shared buffers (rounded to
//   bf16 on the way in bf16). A cp.async ring with the classes of a tile
//   in one block measured slower (see PERF.md).
// - dot (cout = 1: the convt2 forward and conv1's dx). Bound by bytes.
//   8 lanes per output pixel, each reading 4 channels of a tap as a float4,
//   so a warp's load covers whole 128-byte pixel rows; the 8 partial sums
//   meet in a fixed shuffle order.
// - taps (cin = 1: the conv1 forward and convt2's dx; K = 9 takes no
//   tensor cores; and every other shape). Bound by bytes. A thread owns 8
//   channels of 2 pixels; all taps' loads of an input channel are issued
//   before their products.
// With bf16 both operands are rounded to bf16 and the products add in
// fp32, the reference's _mm policy. The host side sets each kernel's
// shared-memory cap and reads its occupancy once per process
// (vae::launch_info); the SM count comes from the wrapper, cached there.
//
// conv_dw runs the same phase plan, its taps rewritten per pixel of the
// layer's undilated side (kernels/conv.py::dw_taps): dy's pixels for the
// stride-2 conv (its one class), x's for the transposed conv, each of whose
// input pixels meets exactly one output pixel under each tap. At direct
// pixel (y, x), tap t meets the other, gathered side at (2 y, 2 x) + an
// offset, so dW is one product over the direct pixels, [9 taps x cg
// gathered values]^T . [cd direct values], every (pixel, tap) once: no
// dilation zeros, and one pass over the pixels where the four classes of
// a dilated layer would stage each of them four times.
// - ffma / mma (cg = 32, cd 32 or 64: conv2 and convt1, the same
//   288 x 64 product). A block owns all of it and a chunk of pixels,
//   streamed 32 at a time through a cp.async ring (one address and bounds
//   check per (pixel, tap), 16-byte copies). fp32 keeps it in registers,
//   72 FMAs per staged pixel for 5 shared loads; bf16 runs mma.sync with
//   the pixels as k, fragments by ldmatrix.trans. Bound by fp32 FMAs
//   (0.44 ms for conv2 at B = 16384), or in bf16 by the bytes of x and dy.
// - thin (conv1: cin = 1; convt2: cout = 1). Bound by bytes: the direct
//   side (32 channels) is read once as float4s and each of its pixels meets
//   9 single-channel values of the other side.
// The pixels split into chunks whose partials a second kernel adds in chunk
// order: no atomics, so the same inputs give the same bits (the scheme of
// wgrad in mlp_bwd.cu).
//
// The plan, a class's pixels and taps, and the tiled routes' slice
// products live in conv_tile.cuh, which conv_mega.cu's decoder shares.

#include <algorithm>
#include <cstring>

#include "conv_tile.cuh"

namespace {

enum Route { kTaps = 0, kDot = 1, kFfma = 2, kMma = 3 };

constexpr int kDotTile = 128;  // cout = 1: 32 lane groups x 4 positions
constexpr int kTapsPix = 2;    // positions a thread owns per step, taps route
constexpr int kMaxCout = 64;

// Slice s of the class (its tap s / (cin / 32), channels 32 (s % (cin /
// 32)) ...) of the tile's patch matrix, 4 channels per slot: slot i of a
// thread is pixel tid / 8 + 32 i, channels 4 (tid % 8) ... One address and
// one bounds check per (pixel, tap), 16-byte loads; zero outside the image.
template <int NV>
__device__ __forceinline__ void gather(const Fwd& f, const PhasePlan& p,
                                       const Cls& k, const int4* rows, int s,
                                       float4 (&v)[NV]) {
  const int per_tap = f.cin / kStageK;
  const int t = s / per_tap;
  const int c0 = (s - t * per_tap) * kStageK + 4 * (threadIdx.x & 7);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float* xp = tap_ptr(f, p, rows[(threadIdx.x >> 3) + 32 * i], k.t0 + t);
    v[i] = xp != nullptr ? __ldg(reinterpret_cast<const float4*>(xp + c0))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int CN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_ffma(Fwd f, PhasePlan plan, int /*bf16*/) {
  constexpr int kCout = 8 * CN;
  constexpr int kBuf = kFfmaTile * kLdF;
  extern __shared__ __align__(16) float smem[];
  __shared__ PhasePlan p;
  load_plan(plan, p);
  const Cls k(f, p, blockIdx.y);
  const int K = k.nt * f.cin;
  float* ws = smem;                 // [K][cout], the class's taps
  float* as = ws + K * kCout;       // [2][tile][kLdF]
  int4* rows = reinterpret_cast<int4*>(as + 2 * kBuf);  // [tile]
  for (int i = threadIdx.x; i < K * kCout; i += kThreads)
    ws[i] = weight_row(f, p, k.t0 * f.cin + i / kCout)[i % kCout];
  const int ntiles = (k.mc + kFfmaTile - 1) / kFfmaTile;
  const int nstages = K / kStageK;
  const int tn = threadIdx.x & 7, tm = threadIdx.x >> 3;
  static_assert(kFfmaTile == kThreads, "one pixel row per thread");
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    __syncthreads();  // the weight is staged; the last tile is done
    rows[threadIdx.x] = pixel_row(f, p, k, tile * kFfmaTile + threadIdx.x);
    __syncthreads();
    float4 v[8];
    auto store = [&](float* dst) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(dst + ((threadIdx.x >> 3) + 32 * i) * kLdF +
                                   4 * (threadIdx.x & 7)) = v[i];
    };
    gather<8>(f, p, k, rows, 0, v);
    store(as);
    __syncthreads();
    float acc[8][CN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < CN; ++q) acc[i][q] = 0.f;
    for (int s = 0; s < nstages; ++s) {
      const bool more = s + 1 < nstages;
      if (more) gather<8>(f, p, k, rows, s + 1, v);
      mac_ffma<CN>(as + (s & 1) * kBuf, ws + s * kStageK * kCout, tm, tn, acc);
      if (more) store(as + ((s + 1) & 1) * kBuf);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int4 r = rows[tm + 32 * i];
      if (r.x < 0) continue;
      float* yp = f.y + r.w + 4 * tn;
      *reinterpret_cast<float4*>(yp) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if constexpr (CN == 8)
        *reinterpret_cast<float4*>(yp + 32) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

template <int COUT>
__global__ void __launch_bounds__(kThreads, 2)
    conv_mma(Fwd f, PhasePlan plan, int /*bf16*/) {
  constexpr int NT = COUT / 16;
  constexpr int kBuf = kMmaTile * kLdH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ PhasePlan p;
  load_plan(plan, p);
  const Cls k(f, p, blockIdx.y);
  const int K = k.nt * f.cin;
  const int ldw = K + 8;  // rows of 16 B x odd: ldmatrix conflict-free
  auto* wt = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [cout][ldw], the class's taps
  __nv_bfloat16* as = wt + COUT * ldw;                    // [2][tile][kLdH]
  int4* rows = reinterpret_cast<int4*>(as + 2 * kBuf);    // [tile]
  for (int i = threadIdx.x; i < K * COUT; i += kThreads) {
    const int kk = i / COUT, n = i - kk * COUT;
    wt[n * ldw + kk] = __float2bfloat16(weight_row(f, p, k.t0 * f.cin + kk)[n]);
  }
  const int ntiles = (k.mc + kMmaTile - 1) / kMmaTile;
  const int nstages = K / kStageK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    __syncthreads();  // the weight is staged; the last tile is done
    if (threadIdx.x < kMmaTile)
      rows[threadIdx.x] = pixel_row(f, p, k, tile * kMmaTile + threadIdx.x);
    __syncthreads();
    float4 v[4];
    auto store = [&](__nv_bfloat16* dst) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint2*>(dst + ((threadIdx.x >> 3) + 32 * i) * kLdH +
                                  4 * (threadIdx.x & 7)) = vae::pack_bf16x4(v[i]);
    };
    gather<4>(f, p, k, rows, 0, v);
    store(as);
    __syncthreads();
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
    for (int s = 0; s < nstages; ++s) {
      const bool more = s + 1 < nstages;
      if (more) gather<4>(f, p, k, rows, s + 1, v);
      mac_mma<COUT>(as + (s & 1) * kBuf, wt, ldw, s * kStageK, acc);
      if (more) store(as + ((s + 1) & 1) * kBuf);
      __syncthreads();
    }
    const int g = lane >> 2, cq = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int4 r = rows[32 * wm + 16 * mt + g + 8 * hh];
        if (r.x < 0) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<float2*>(f.y + r.w + wn * (COUT / 2) + 8 * nt +
                                     2 * cq) =
              make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
      }
  }
}

// cout = 1 (cin a multiple of 32): a group of 8 lanes per output pixel, 4
// pixels per group; lane l reads channels 4 l ... (+ 32 k) of each tap as
// one float4, so a warp's load covers whole 128-byte pixel rows. Up to 4
// taps' loads are in flight before their products; the 8 partial sums
// meet in a fixed shuffle order.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    conv_dot(Fwd f, PhasePlan plan, int /*bf16*/) {
  extern __shared__ __align__(16) float smem[];
  __shared__ PhasePlan p;
  load_plan(plan, p);
  const Cls k(f, p, blockIdx.y);
  const int K = k.nt * f.cin;
  float* ws = smem;  // [K], the class's rows, rounded
  for (int i = threadIdx.x; i < K; i += kThreads)
    ws[i] = rnd<BF16>(weight_row(f, p, k.t0 * f.cin + i)[0]);
  __syncthreads();
  const int l8 = threadIdx.x & 7, slot = threadIdx.x >> 3;
  const int ntiles = (k.mc + kDotTile - 1) / kDotTile;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int4 r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) r[u] = pixel_row(f, p, k, tile * kDotTile + slot + 32 * u);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 4 * l8; c0 < f.cin; c0 += 32) {
      for (int t0 = 0; t0 < k.nt; t0 += 4) {
        float4 v[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* xp = t0 + q < k.nt ? tap_ptr(f, p, r[u], k.t0 + t0 + q) : nullptr;
            v[u][q] = xp != nullptr ? __ldg(reinterpret_cast<const float4*>(xp + c0))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (t0 + q >= k.nt) break;
          const float4 w = *reinterpret_cast<const float4*>(ws + (t0 + q) * f.cin + c0);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[u] = fmaf(rnd<BF16>(v[u][q].x), w.x, acc[u]);
            acc[u] = fmaf(rnd<BF16>(v[u][q].y), w.y, acc[u]);
            acc[u] = fmaf(rnd<BF16>(v[u][q].z), w.z, acc[u]);
            acc[u] = fmaf(rnd<BF16>(v[u][q].w), w.w, acc[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
      if (l8 == 0 && r[u].x >= 0) f.y[r[u].w] = acc[u];
    }
  }
}

// cin = 1 and every shape the other routes do not take: thread (pixel,
// channel group) owns CG channels of kTapsPix pixels (CG = 8: channels
// 4 g ... and 4 (groups + g) ..., so the groups of a pixel store whole
// 128-byte rows); per input channel the loads of every tap of the class for
// both pixels are issued before their products. The weight in shared
// memory has rows padded to whole groups with zeros, so no lane tests its
// channel.
template <int CG>
__device__ __forceinline__ void mac_taps(float v, const float* w, int g,
                                         int groups, float (&acc)[CG]) {
  if constexpr (CG == 8) {
    const float4 w0 = *reinterpret_cast<const float4*>(w + 4 * g);
    const float4 w1 = *reinterpret_cast<const float4*>(w + 4 * (groups + g));
    acc[0] = fmaf(v, w0.x, acc[0]), acc[1] = fmaf(v, w0.y, acc[1]);
    acc[2] = fmaf(v, w0.z, acc[2]), acc[3] = fmaf(v, w0.w, acc[3]);
    acc[4] = fmaf(v, w1.x, acc[4]), acc[5] = fmaf(v, w1.y, acc[5]);
    acc[6] = fmaf(v, w1.z, acc[6]), acc[7] = fmaf(v, w1.w, acc[7]);
  } else {
    acc[0] = fmaf(v, w[g], acc[0]);
  }
}

template <int CG>
__global__ void __launch_bounds__(kThreads)
    conv_taps(Fwd f, PhasePlan plan, int bf16) {
  extern __shared__ __align__(16) float smem[];
  __shared__ PhasePlan p;
  load_plan(plan, p);
  const Cls k(f, p, blockIdx.y);
  const int groups = (f.cout + CG - 1) / CG;
  const int cs = groups * CG;  // weight row stride
  const int K = k.nt * f.cin;
  float* ws = smem;  // [K][cs], the class's rows
  for (int i = threadIdx.x; i < K * cs; i += kThreads) {
    const int kk = i / cs, n = i - kk * cs;
    const float wv = n < f.cout ? weight_row(f, p, k.t0 * f.cin + kk)[n] : 0.f;
    ws[i] = rnd(wv, bf16);
  }
  __syncthreads();
  const int tp = kThreads / groups;
  const int pos = threadIdx.x / groups, g = threadIdx.x - pos * groups;
  if (pos >= tp) return;
  const int ntiles = (k.mc + tp * kTapsPix - 1) / (tp * kTapsPix);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int4 r[kTapsPix];
    float acc[kTapsPix][CG];
#pragma unroll
    for (int u = 0; u < kTapsPix; ++u) {
      r[u] = pixel_row(f, p, k, tile * tp * kTapsPix + pos + tp * u);
#pragma unroll
      for (int q = 0; q < CG; ++q) acc[u][q] = 0.f;
    }
    for (int ci = 0; ci < f.cin; ++ci) {
      float v[kTapsPix][kMaxTaps];
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t)
#pragma unroll
        for (int u = 0; u < kTapsPix; ++u) {
          const float* xp = t < k.nt ? tap_ptr(f, p, r[u], k.t0 + t) : nullptr;
          const float xv = xp != nullptr ? __ldg(xp + ci) : 0.f;
          v[u][t] = rnd(xv, bf16);
        }
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) {
        if (t >= k.nt) break;
        const float* wk = ws + (t * f.cin + ci) * cs;
#pragma unroll
        for (int u = 0; u < kTapsPix; ++u) mac_taps<CG>(v[u][t], wk, g, groups, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kTapsPix; ++u) {
      if (r[u].x < 0) continue;
      float* yp = f.y + r[u].w;
      if (CG == 8 && f.cout % 8 == 0) {
        *reinterpret_cast<float4*>(yp + 4 * g) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
        *reinterpret_cast<float4*>(yp + 4 * (groups + g)) =
            make_float4(acc[u][4], acc[u][5], acc[u][6], acc[u][7]);
      } else {
#pragma unroll
        for (int q = 0; q < CG; ++q) {
          const int n = CG == 8 ? 4 * (q < 4 ? g : groups + g) + (q & 3) : g;
          if (n < f.cout) yp[n] = acc[u][q];
        }
      }
    }
  }
}

// Shared memory of a route for K patch columns, the largest class's
// (kernels/conv.py::fwd_tile_plan).
int fwd_smem(int route, int cout, int k) {
  if (route == kFfma)
    return 4 * (k * cout + 2 * kFfmaTile * kLdF) + 16 * kFfmaTile;
  if (route == kMma)
    return 2 * (cout * (k + 8) + 2 * kMmaTile * kLdH) + 16 * kMmaTile;
  if (route == kDot) return 4 * k;
  const int cg = cout >= 8 ? 8 : 1;
  return 4 * k * cg * ((cout + cg - 1) / cg);
}

// ---- conv_dw ----

constexpr int kDwSlice = 32;           // pixels per staged slice, tiled routes
constexpr int kDwStages = 3;           // slices in the tiled routes' cp.async ring
constexpr int kDwG = 32;               // gathered channels, tiled routes
constexpr int kDwK = kMaxTaps * kDwG;  // 288 rows of the tiled product
constexpr int kLdGa = kDwK + 4;        // fp32 staged row of gathered values
constexpr int kLdGh = kDwK + 8;        // bf16 row: 592 B, ldmatrix conflict-free

enum DwRoute { kDwFfma = 0, kDwMma = 1, kDwThin = 2 };

// conv_dw's view of the layer: the phase plan's taps rewritten per pixel
// of the layer's undilated side, the "direct" side (dy of a stride-2 conv,
// whose one class is its output pixels; x of a transposed conv, each of
// whose input pixels meets one output pixel under each tap). Direct pixel
// (y, x) meets the other, "gathered" side at (2 y + oy[t], 2 x + ox[t])
// under tap t, zero outside it, and adds gathered^T direct to weight row
// wrow[t] (kernels/conv.py::dw_taps). Each (output pixel, tap meeting
// nonzero input) comes once: no dilation zeros, and one pass over the
// pixels for all 9 taps.
struct DwTaps {
  const float* direct;    // [batch, hd, hd, cd]
  const float* gathered;  // [batch, hg, hg, cg]
  int batch, hd, hg, cd, cg;
  int gathered_x;  // gathered = x: dW row wrow cg + g, column d; else row wrow cd + d, column g
  int wrow[kMaxTaps], oy[kMaxTaps], ox[kMaxTaps];
};

// A block's result: dw itself, or its chunk's partial when the pixels
// split into more than one chunk (a second launch adds them in order).
__device__ __forceinline__ float* dw_out(float* dw, float* partial, int n) {
  return gridDim.x > 1 ? partial + (size_t)blockIdx.x * n : dw;
}

// Direct pixel m: (image, y, x).
__device__ __forceinline__ int3 dw_pixel(const DwTaps& t, int m) {
  const int hw2 = t.hd * t.hd;
  const int b = m / hw2;
  const int r = m - b * hw2;
  const int y = r / t.hd;
  return make_int3(b, y, r - y * t.hd);
}

// Index in dw of row kk = tap i, gathered channel g, and direct channel d.
__device__ __forceinline__ int dw_index(const DwTaps& t, const int* wrow, int i,
                                        int g, int d) {
  return t.gathered_x ? (wrow[i] * t.cg + g) * t.cd + d : (wrow[i] * t.cd + d) * t.cg + g;
}

// A thread's share of the product: fp32 rows 4 tm ..., 128 + 4 tm ... and
// 256 + tm by columns 4 tn ... (and 32 + 4 tn ...); bf16 up to 3 x CD / 8
// mma tiles.
template <int CD, bool BF16>
struct DwAcc {
  float v[9][CD / 8];
};
template <int CD>
struct DwAcc<CD, true> {
  float v[3][CD / 8][4];
};

// Tiled routes (32 gathered channels, cd = 32 or 64: conv2 and convt1):
// P [288, cd] = sum over direct pixels p of G[p]^T D[p], G[p] the gathered
// side's 32 channels at the 9 taps, D[p] the direct side's channels. A
// block owns all of P (in registers) and a chunk of pixels, streamed 32 at
// a time through a ring of kDwStages shared-memory stages filled by
// cp.async: thread t copies pixel t / 8's channels 4 (t % 8) ... of each
// tap (one address and bounds check per (pixel, tap), 16 bytes through L1,
// where neighbouring pixels' taps hit, zero-filled outside the image) and
// of D, so two slices are in flight while one multiplies. fp32: up to 72
// FMAs per 5 shared loads a pixel. bf16: each thread rounds the values it
// copied into a double-buffered bf16 slice; mma.sync with the pixels as k,
// fragments of G^T and D by ldmatrix.trans (both are pixel-major); warp w
// owns the 16-row tiles w, w + 8, w + 16.
template <int CD, bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
    dw_tiled(DwTaps t, int per, float* dw, float* partial) {
  constexpr int kLdD = CD + 4, kLdDh = CD + 8;
  constexpr int kStage = kDwSlice * (kLdGa + kLdD);   // floats
  constexpr int kHalf = kDwSlice * (kLdGh + kLdDh);   // bf16 values
  constexpr int CN = CD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int wrow[kMaxTaps];
  auto* ring = reinterpret_cast<float*>(smem_raw);  // [kDwStages][G, D]
  auto* half = reinterpret_cast<__nv_bfloat16*>(ring + kDwStages * kStage);  // [2][G, D]
  if (threadIdx.x < kMaxTaps) wrow[threadIdx.x] = t.wrow[threadIdx.x];
  const int M = t.batch * t.hd * t.hd;
  const int m0 = blockIdx.x * per, m1 = min(M, m0 + per);
  const int nsl = m1 > m0 ? (m1 - m0 + kDwSlice - 1) / kDwSlice : 0;
  const int gp = threadIdx.x >> 3, c0 = 4 * (threadIdx.x & 7);
  auto issue = [&](int j) {
    if (j < nsl) {
      float* st = ring + (j % kDwStages) * kStage;
      const int m = m0 + j * kDwSlice + gp;
      const bool in = m < m1;
      const int3 q = dw_pixel(t, in ? m : m0);
      const float* img = t.gathered + (size_t)q.x * t.hg * t.hg * kDwG + c0;
#pragma unroll
      for (int i = 0; i < kMaxTaps; ++i) {
        const int y = 2 * q.y + t.oy[i], x = 2 * q.z + t.ox[i];
        const bool ok = in && y >= 0 && x >= 0 && y < t.hg && x < t.hg;
        vae::cp_async16_ca(st + gp * kLdGa + i * kDwG + c0,
                           ok ? img + (y * t.hg + x) * kDwG : t.gathered, ok);
      }
      const float* dp = t.direct + (size_t)(in ? m : m0) * CD + c0;
#pragma unroll
      for (int u = 0; u < CD / 32; ++u)
        vae::cp_async16(st + kDwSlice * kLdGa + gp * kLdD + c0 + 32 * u, dp + 32 * u, in);
    }
    vae::cp_async_commit();  // empty past the last slice: uniform counts
  };
  for (int j = 0; j < kDwStages - 1; ++j) issue(j);
  const int tn = threadIdx.x & 7, tm = threadIdx.x >> 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  DwAcc<CD, BF16> acc{};
  for (int j = 0; j < nsl; ++j) {
    vae::cp_async_wait<kDwStages - 2>();
    const float* st = ring + (j % kDwStages) * kStage;
    const float* ds = st + kDwSlice * kLdGa;
    __nv_bfloat16* hs = half + (j & 1) * kHalf;
    if constexpr (BF16) {  // the values this thread copied, rounded
#pragma unroll
      for (int i = 0; i < kMaxTaps; ++i)
        *reinterpret_cast<uint2*>(hs + gp * kLdGh + i * kDwG + c0) = vae::pack_bf16x4(
            *reinterpret_cast<const float4*>(st + gp * kLdGa + i * kDwG + c0));
#pragma unroll
      for (int u = 0; u < CD / 32; ++u)
        *reinterpret_cast<uint2*>(hs + kDwSlice * kLdGh + gp * kLdDh + c0 + 32 * u) =
            vae::pack_bf16x4(*reinterpret_cast<const float4*>(ds + gp * kLdD + c0 + 32 * u));
    }
    __syncthreads();  // slice j is whole; slice j - 1 is consumed
    issue(j + kDwStages - 1);
    if constexpr (BF16) {
      const __nv_bfloat16* gs = hs;
      const __nv_bfloat16* dh = hs + kDwSlice * kLdGh;
#pragma unroll
      for (int ks = 0; ks < kDwSlice; ks += 16) {
        uint32_t bf[CN][2];
#pragma unroll
        for (int np = 0; np < CN / 2; ++np) {
          uint32_t r[4];
          vae::ldmatrix_x4_trans(
              r, dh + (ks + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLdDh + 16 * np +
                     (lane >> 4) * 8);
          bf[2 * np][0] = r[0], bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2], bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int mt = warp + 8 * i;
          if (mt >= kDwK / 16) continue;
          uint32_t af[4];
          vae::ldmatrix_x4_trans(
              af, gs + (ks + (lane >> 4) * 8 + (lane & 7)) * kLdGh + 16 * mt +
                      ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int n = 0; n < CN; ++n) vae::mma_bf16(acc.v[i][n], af, bf[n][0], bf[n][1]);
        }
      }
    } else {
#pragma unroll 2
      for (int px = 0; px < kDwSlice; ++px) {
        const float* gp_ = st + px * kLdGa;
        const float4 a0 = *reinterpret_cast<const float4*>(gp_ + 4 * tm);
        const float4 a1 = *reinterpret_cast<const float4*>(gp_ + 128 + 4 * tm);
        const float av[9] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, gp_[256 + tm]};
        float dv[CN];
        const float4 d0 = *reinterpret_cast<const float4*>(ds + px * kLdD + 4 * tn);
        dv[0] = d0.x, dv[1] = d0.y, dv[2] = d0.z, dv[3] = d0.w;
        if constexpr (CN == 8) {
          const float4 d1 = *reinterpret_cast<const float4*>(ds + px * kLdD + 32 + 4 * tn);
          dv[4] = d1.x, dv[5] = d1.y, dv[6] = d1.z, dv[7] = d1.w;
        }
#pragma unroll
        for (int r = 0; r < 9; ++r)
#pragma unroll
          for (int q = 0; q < CN; ++q) acc.v[r][q] = fmaf(av[r], dv[q], acc.v[r][q]);
      }
    }
  }
  vae::cp_async_wait<0>();
  __syncthreads();  // wrow is staged even when the chunk is empty
  float* out = dw_out(dw, partial, kMaxTaps * kDwG * CD);
  if constexpr (BF16) {
    const int g = lane >> 2, cq = lane & 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int mt = warp + 8 * i;
      if (mt >= kDwK / 16) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kk = 16 * mt + g + 8 * hh;
#pragma unroll
        for (int n = 0; n < CN; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            out[dw_index(t, wrow, kk / kDwG, kk % kDwG, 8 * n + 2 * cq + e)] =
                acc.v[i][n][2 * hh + e];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      const int kk = r < 4 ? 4 * tm + r : r < 8 ? 124 + 4 * tm + r : 256 + tm;
#pragma unroll
      for (int q = 0; q < CN; ++q)
        out[dw_index(t, wrow, kk / kDwG, kk % kDwG, q < 4 ? 4 * tn + q : 28 + 4 * tn + q)] =
            acc.v[r][q];
    }
  }
}

// Thin route (one channel on the gathered side: conv1's x, convt2's dy;
// cd = 4 ... 32 on the direct side). Bound by bytes: the direct side is
// read once with 16-byte loads (cd / 4 lanes per pixel) and each pixel's 9
// gathered values come from L1/L2. Each lane keeps the 9 taps x 4 channels
// of its pixels' products; the lanes of one channel group, then the warps,
// add in a fixed order.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    dw_thin(DwTaps t, int per, float* dw, float* partial) {
  __shared__ float red[kThreads / 32][kMaxTaps * 32];
  const int lpp = t.cd / 4, ppw = 32 / lpp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / lpp, q = lane - g * lpp;
  const int M = t.batch * t.hd * t.hd;
  const int m0 = blockIdx.x * per, m1 = min(M, m0 + per);
  float acc[kMaxTaps][4];
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int m = m0 + warp * ppw + g; m < m1; m += (kThreads / 32) * ppw) {
    const int3 px = dw_pixel(t, m);
    float4 wv = __ldg(reinterpret_cast<const float4*>(t.direct + (size_t)m * t.cd + 4 * q));
    wv = make_float4(rnd<BF16>(wv.x), rnd<BF16>(wv.y), rnd<BF16>(wv.z), rnd<BF16>(wv.w));
    const float* nb = t.gathered + (size_t)px.x * t.hg * t.hg;
    float nv[kMaxTaps];
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
      const int ny = 2 * px.y + t.oy[i], nx = 2 * px.z + t.ox[i];
      nv[i] = ny >= 0 && nx >= 0 && ny < t.hg && nx < t.hg
                  ? rnd<BF16>(__ldg(nb + ny * t.hg + nx)) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
      acc[i][0] = fmaf(nv[i], wv.x, acc[i][0]);
      acc[i][1] = fmaf(nv[i], wv.y, acc[i][1]);
      acc[i][2] = fmaf(nv[i], wv.z, acc[i][2]);
      acc[i][3] = fmaf(nv[i], wv.w, acc[i][3]);
    }
  }
  for (int o = lpp; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
  if (g == 0)
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][i * t.cd + 4 * q + j] = acc[i][j];
  __syncthreads();
  float* out = dw_out(dw, partial, kMaxTaps * t.cd);
  for (int i = threadIdx.x; i < kMaxTaps * t.cd; i += kThreads) {
    float s = red[0][i];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) s += red[w][i];
    const int tap = i / t.cd;
    out[t.wrow[tap] * t.cd + i - tap * t.cd] = s;
  }
}

// Adds the chunks' partial [n] arrays in chunk order: block x owns 32
// consecutive values, warp w the chunks [w q, (w + 1) q), q = chunks / 8
// rounded up, each in order; the 8 warp sums then add in warp order.
__global__ void __launch_bounds__(kThreads)
    dw_reduce(const float* __restrict__ partial, int chunks, int n,
              float* __restrict__ dw) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const int q = (chunks + kWarps - 1) / kWarps;
  float s = 0.f;
  if (i < n)
    for (int c = warp * q; c < min(chunks, (warp + 1) * q); ++c)
      s += partial[(size_t)c * n + i];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < n) {
    float t = red[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += red[w][lane];
    dw[i] = t;
  }
}

// Shared memory of a tiled dw route for cd direct channels: the ring and,
// in bf16, the two rounded slices (kernels/conv.py::dw_smem).
int dw_smem(int route, int cd) {
  const int ring = 4 * kDwStages * kDwSlice * (kLdGa + cd + 4);
  return route == kDwMma ? ring + 2 * 2 * kDwSlice * (kLdGh + cd + 8) : ring;
}

}  // namespace

// y [batch, out_hw, out_hw, cout] = the conv of x [batch, h, w, cin] (NHWC,
// fp32) with w2d [9 cin, cout] under the phase plan `plan_rows`
// (kPlanInts ints, kernels/conv.py::_plan_table) on `route` with `smem`
// bytes of dynamic shared memory (kernels/conv.py::fwd_tile_plan), on
// n_sm SMs. Launches on `stream` without synchronising and returns
// cudaGetLastError(); arguments the kernels do not take return
// cudaErrorInvalidValue.
extern "C" int vae_conv_fwd(const void* x, int batch, int h, int w, int cin,
                            const void* w2d, int cout, int out_hw,
                            const int* plan_rows, int route, int smem,
                            int n_sm, void* y, int bf16, void* stream) {
  PhasePlan plan;
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 ||
      cout > kMaxCout || n_sm <= 0 || route < kTaps || route > kMma ||
      !read_plan(plan_rows, out_hw, &plan))
    return (int)cudaErrorInvalidValue;
  int max_taps = 0;
  for (int c = 0, t0 = 0; c < plan.ncls; t0 = plan.tap_end[c++])
    max_taps = std::max(max_taps, plan.tap_end[c] - t0);
  const bool tiled = route == kFfma || route == kMma;
  if (smem != fwd_smem(route, cout, max_taps * cin) ||
      smem + (int)sizeof(PhasePlan) > vae::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (tiled && (cin % kStageK != 0 || (cout != 32 && cout != 64) ||
                (route == kMma) != (bf16 != 0)))
    return (int)cudaErrorInvalidValue;
  if (route == kDot && (cout != 1 || cin % kStageK != 0))
    return (int)cudaErrorInvalidValue;
  if (route != kTaps && reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const void* fn;
  int tile;
  if (route == kFfma) {
    fn = cout == 64 ? (const void*)conv_ffma<8> : (const void*)conv_ffma<4>;
    tile = kFfmaTile;
  } else if (route == kMma) {
    fn = cout == 64 ? (const void*)conv_mma<64> : (const void*)conv_mma<32>;
    tile = kMmaTile;
  } else if (route == kDot) {
    fn = bf16 ? (const void*)conv_dot<true> : (const void*)conv_dot<false>;
    tile = kDotTile;
  } else {
    const int cg = cout >= 8 ? 8 : 1;
    fn = cg == 8 ? (const void*)conv_taps<8> : (const void*)conv_taps<1>;
    tile = kThreads / ((cout + cg - 1) / cg) * kTapsPix;
  }
  int per_sm = 0;
  cudaError_t e = vae::launch_info(fn, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  long long tiles = 1;
  for (int c = 0; c < plan.ncls; ++c)
    tiles = std::max(tiles, ((long long)batch * plan.cnqy[c] * plan.cnqx[c] +
                             tile - 1) / tile);
  const long long fill =
      ((long long)n_sm * std::max(per_sm, 1) + plan.ncls - 1) / plan.ncls;
  Fwd f{static_cast<const float*>(x), static_cast<const float*>(w2d),
        static_cast<float*>(y), batch, h, w, cin, cout, out_hw};
  void* args[] = {&f, &plan, &bf16};
  e = cudaLaunchKernel(fn, dim3((unsigned)std::min(tiles, fill), plan.ncls),
                       dim3(kThreads), args, smem,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(e != cudaSuccess ? e : last);
}

// dw [9 cin, cout] = sum over the output pixels of patch^T . dy for the conv
// of vae_conv_fwd with the same geometry; dy [batch, out_hw, out_hw, cout].
// `taps` holds the 9 taps' (wrow, oy, ox) as 27 ints (kernels/conv.py::
// dw_taps); the gathered side is x when `gathered_x`, else dy. `route` is
// kernels/conv.py::dw_route's; the direct side's pixels split into `chunks`
// of `per` pixels; `smem` is dw_smem's. With chunks > 1, `partial` holds
// chunks * 9 cin * cout floats of scratch and a second launch adds them in
// order.
extern "C" int vae_conv_dw(const void* x, int batch, int h, int w, int cin,
                           const void* dy, int cout, int out_hw,
                           const int* taps, int gathered_x, int route, int per,
                           int chunks, int smem, void* dw, void* partial,
                           int bf16, void* stream) {
  if (batch <= 0 || h <= 0 || h != w || cin <= 0 || cout <= 0 || out_hw <= 0 ||
      taps == nullptr || chunks < 1 || per < 1 || (chunks > 1 && partial == nullptr) ||
      route < kDwFfma || route > kDwThin ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  DwTaps t{static_cast<const float*>(gathered_x ? dy : x),
           static_cast<const float*>(gathered_x ? x : dy), batch,
           gathered_x ? out_hw : h, gathered_x ? h : out_hw,
           gathered_x ? cout : cin, gathered_x ? cin : cout, gathered_x ? 1 : 0,
           {}, {}, {}};
  for (int i = 0; i < kMaxTaps; ++i) {
    t.wrow[i] = taps[3 * i];
    t.oy[i] = taps[3 * i + 1];
    t.ox[i] = taps[3 * i + 2];
    if (t.wrow[i] < 0 || t.wrow[i] >= kMaxTaps) return (int)cudaErrorInvalidValue;
  }
  if ((long long)per * chunks < (long long)batch * t.hd * t.hd)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  float* dwp = static_cast<float*>(dw);
  float* part = chunks > 1 ? static_cast<float*>(partial) : nullptr;
  cudaError_t e;
  if (route == kDwThin) {
    if (t.cg != 1 || (t.cd != 4 && t.cd != 8 && t.cd != 16 && t.cd != 32) || smem != 0)
      return (int)cudaErrorInvalidValue;
    auto kern = bf16 ? dw_thin<true> : dw_thin<false>;
    kern<<<chunks, kThreads, 0, st>>>(t, per, dwp, part);
  } else {
    if (t.cg != kDwG || (t.cd != 32 && t.cd != 64) || (route == kDwMma) != (bf16 != 0) ||
        smem != dw_smem(route, t.cd) || smem + 64 > vae::kSmemLimit)
      return (int)cudaErrorInvalidValue;
    const void* fn = route == kDwFfma
        ? (t.cd == 64 ? (const void*)dw_tiled<64, false> : (const void*)dw_tiled<32, false>)
        : (t.cd == 64 ? (const void*)dw_tiled<64, true> : (const void*)dw_tiled<32, true>);
    int per_sm = 0;
    e = vae::launch_info(fn, smem, &per_sm);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {&t, &per, &dwp, &part};
    e = cudaLaunchKernel(fn, dim3(chunks), dim3(kThreads), args, smem, st);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return (int)e;
  const int n = 9 * cin * cout;
  dw_reduce<<<(n + 31) / 32, kThreads, 0, st>>>(part, chunks, n, dwp);
  return (int)cudaGetLastError();
}
