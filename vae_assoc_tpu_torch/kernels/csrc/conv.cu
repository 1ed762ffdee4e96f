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
// conv_dw: a block owns a tile of patch columns times all cout and loops
// over a fixed chunk of output pixels in slices of 16, gathering the patch
// slice and the dy slice into shared memory. With more than one chunk,
// each chunk writes a partial and a second kernel adds the partials in
// chunk order: no atomics, so the same inputs give the same bits (the
// scheme of wgrad in mlp_bwd.cu). Its geometry is a runtime argument.

#include <algorithm>
#include <cstring>

#include "common.cuh"

namespace {

using vae::kThreads;

// ---- conv_fwd ----

constexpr int kMaxTaps = 9;
constexpr int kMaxClasses = 4;
constexpr int kStageK = 32;        // patch columns per staged slice
constexpr int kFfmaTile = 256;     // q positions per tile, fp32 route
constexpr int kMmaTile = 128;      // bf16 route
constexpr int kDotTile = 128;      // cout = 1: 32 lane groups x 4 positions
constexpr int kTapsPix = 2;        // positions a thread owns per step, taps route
constexpr int kLdF = kStageK + 4;  // fp32 slice row: 144 B, rows on distinct banks
constexpr int kLdH = kStageK + 8;  // bf16 slice row: 80 B, ldmatrix conflict-free
constexpr int kMaxCout = 64;

enum Route { kTaps = 0, kDot = 1, kFfma = 2, kMma = 3 };

// The phase plan (kernels/conv.py::_plan_table). Class c covers q
// positions qy < cnqy[c], qx < cnqx[c], whose output pixel is (oy0[c] +
// ostep qy, ox0[c] + ostep qx), and owns the taps [tap_end[c - 1],
// tap_end[c]); tap t reads x at (istep qy + dy[t], istep qx + dx[t])
// against weight rows wrow[t] cin ... blockIdx.y picks the class.
struct PhasePlan {
  int ncls, ntaps, istep, ostep;
  int oy0[kMaxClasses], ox0[kMaxClasses], cnqy[kMaxClasses],
      cnqx[kMaxClasses], tap_end[kMaxClasses];
  int wrow[kMaxTaps], dy[kMaxTaps], dx[kMaxTaps];
};
constexpr int kPlanInts = 4 + 5 * kMaxClasses + 3 * kMaxTaps;
static_assert(sizeof(PhasePlan) == 4 * kPlanInts, "PLAN_BYTES in conv.py");

struct Fwd {
  const float* x;    // [batch, h, w, cin]
  const float* w2d;  // [9 cin, cout]
  float* y;          // [batch, out_hw, out_hw, cout]
  int batch, h, w, cin, cout, out_hw;
};

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

__device__ __forceinline__ float rnd(float v, int bf16) {
  return bf16 ? rnd<true>(v) : v;
}

// The plan into shared memory (one int per thread), then a barrier.
__device__ __forceinline__ void load_plan(const PhasePlan& plan, PhasePlan& p) {
  if (threadIdx.x < kPlanInts)
    reinterpret_cast<int*>(&p)[threadIdx.x] =
        reinterpret_cast<const int*>(&plan)[threadIdx.x];
  __syncthreads();
}

// The block's class: its first tap, its tap count, its pixel count.
struct Cls {
  int c, t0, nt, mc;
  __device__ Cls(const Fwd& f, const PhasePlan& p)
      : c(blockIdx.y),
        t0(blockIdx.y ? p.tap_end[blockIdx.y - 1] : 0),
        nt(p.tap_end[blockIdx.y] - t0),
        mc(f.batch * p.cnqy[blockIdx.y] * p.cnqx[blockIdx.y]) {}
};

// Output pixel m of class c: (x offset of its image or -1 past the class,
// istep qy, istep qx, y offset of the pixel).
__device__ __forceinline__ int4 pixel_row(const Fwd& f, const PhasePlan& p,
                                          const Cls& k, int m) {
  if (m >= k.mc) return make_int4(-1, 0, 0, 0);
  const int nqx = p.cnqx[k.c], per = p.cnqy[k.c] * nqx;
  const int b = m / per;
  const int r = m - b * per;
  const int qy = r / nqx;
  const int qx = r - qy * nqx;
  return make_int4(b * f.h * f.w * f.cin, p.istep * qy, p.istep * qx,
                   ((b * f.out_hw + p.oy0[k.c] + p.ostep * qy) * f.out_hw +
                    p.ox0[k.c] + p.ostep * qx) * f.cout);
}

// x at pixel row r shifted by tap t, or nullptr outside the image.
__device__ __forceinline__ const float* tap_ptr(const Fwd& f,
                                                const PhasePlan& p, int4 r,
                                                int t) {
  const int iy = r.y + p.dy[t], ix = r.z + p.dx[t];
  if (r.x < 0 || iy < 0 || ix < 0 || iy >= f.h || ix >= f.w) return nullptr;
  return f.x + r.x + (iy * f.w + ix) * f.cin;
}

// Weight row of patch column k = t cin + ci (the plan's taps in order).
__device__ __forceinline__ const float* weight_row(const Fwd& f,
                                                   const PhasePlan& p, int k) {
  const int t = k / f.cin;
  return f.w2d + (size_t)(p.wrow[t] * f.cin + (k - t * f.cin)) * f.cout;
}

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

// fp32 route: the slice's 8 pixels x 4 channels of this thread per column,
// pixels tm + 32 i, channels 4 tn ... and 32 + 4 tn ... (CN = 8).
template <int CN>
__device__ __forceinline__ void mac_ffma(const float* a, const float* w,
                                         int tm, int tn,
                                         float (&acc)[8][CN]) {
  constexpr int kCout = 8 * CN;
#pragma unroll 2
  for (int kk = 0; kk < kStageK; kk += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (tm + 32 * i) * kLdF + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* wr = w + (kk + j) * kCout + 4 * tn;
      float bv[CN];
      const float4 b0 = *reinterpret_cast<const float4*>(wr);
      bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
      if constexpr (CN == 8) {
        const float4 b1 = *reinterpret_cast<const float4*>(wr + 32);
        bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = j == 0 ? av[i].x : j == 1 ? av[i].y
                       : j == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int q = 0; q < CN; ++q) acc[i][q] = fmaf(xv, bv[q], acc[i][q]);
      }
    }
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
  const Cls k(f, p);
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

// bf16 route: warp (wm, wn) owns pixels 32 wm ... and channels
// cout/2 wn ...: 2 x NT mma tiles per 16 patch columns.
template <int COUT>
__device__ __forceinline__ void mac_mma(const __nv_bfloat16* a,
                                        const __nv_bfloat16* wt, int ldw,
                                        int k0, float (&acc)[2][COUT / 16][4]) {
  constexpr int NT = COUT / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int ks = 0; ks < kStageK; ks += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      vae::ldmatrix_x4(af[mt], a + (32 * wm + 16 * mt + (lane & 15)) * kLdH +
                                   ks + (lane >> 4) * 8);
    uint32_t bf[NT][2];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      vae::ldmatrix_x4(r, wt + (wn * (COUT / 2) + 16 * np + (lane & 7) +
                                (lane >> 4) * 8) * ldw +
                              k0 + ks + ((lane >> 3) & 1) * 8);
      bf[2 * np][0] = r[0], bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2], bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        vae::mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
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
  const Cls k(f, p);
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
  const Cls k(f, p);
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
  const Cls k(f, p);
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

// The plan from its ints; false for a plan the kernels cannot run (taps,
// steps or outputs out of range).
bool read_plan(const int* in, int out_hw, PhasePlan* p) {
  if (in == nullptr) return false;
  std::memcpy(p, in, sizeof(PhasePlan));
  if (p->ncls < 1 || p->ncls > kMaxClasses || p->ntaps < 1 ||
      p->ntaps > kMaxTaps || p->istep < 1 ||
      p->istep > 2 || p->ostep < 1 || p->ostep > 2)
    return false;
  int prev = 0;
  for (int c = 0; c < p->ncls; ++c) {
    if (p->tap_end[c] <= prev || p->cnqy[c] < 1 || p->cnqx[c] < 1 ||
        p->oy0[c] < 0 ||
        p->ox0[c] < 0 || p->oy0[c] + p->ostep * (p->cnqy[c] - 1) >= out_hw ||
        p->ox0[c] + p->ostep * (p->cnqx[c] - 1) >= out_hw)
      return false;
    prev = p->tap_end[c];
  }
  if (prev != p->ntaps) return false;
  for (int t = 0; t < p->ntaps; ++t)
    if (p->wrow[t] < 0 || p->wrow[t] >= kMaxTaps) return false;
  return true;
}

// ---- conv_dw ----

constexpr int kMaxCh = 4;   // channels a thread owns
constexpr int kSlice = 16;  // output pixels per slice
constexpr int kDwRows = 4;  // patch columns a thread owns

struct Geom {
  int batch, h, w, cin, cout;
  int stride, dilate, lo;
  int hd, wd;  // the input's size after dilation
  int out_hw;  // oh == ow
};

// Channels a thread owns and the number of channel threads (a power of two
// covering cout), shared with kernels/conv.py's dw_plan.
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
  int per_sm = 0;
  cudaError_t e = vae::launch_info((const void*)conv_dw, (int)smem, &per_sm);
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
