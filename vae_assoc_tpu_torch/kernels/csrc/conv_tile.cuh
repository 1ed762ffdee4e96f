// The conv primitive's pieces that conv.cu (conv_fwd) and conv_mega.cu
// (conv_dec's convt1) share: the phase plan as the kernels read it, a
// class's pixels and taps, and the tiled routes' products over one staged
// slice of 32 patch columns (fp32 register tiles, bf16 mma.sync). conv.cu
// says what the routes are and what bounds them.

#pragma once

#include <cstring>

#include "common.cuh"

namespace {

using vae::kThreads;

constexpr int kMaxTaps = 9;
constexpr int kMaxClasses = 4;
constexpr int kStageK = 32;        // patch columns per staged slice
constexpr int kFfmaTile = 256;     // q positions per tile, fp32 route
constexpr int kMmaTile = 128;      // bf16 route
constexpr int kLdF = kStageK + 4;  // fp32 slice row: 144 B, rows on distinct banks
constexpr int kLdH = kStageK + 8;  // bf16 slice row: 80 B, ldmatrix conflict-free

// The phase plan (kernels/conv.py::_plan_table). Class c covers q
// positions qy < cnqy[c], qx < cnqx[c], whose output pixel is (oy0[c] +
// ostep qy, ox0[c] + ostep qx), and owns the taps [tap_end[c - 1],
// tap_end[c]); tap t reads x at (istep qy + dy[t], istep qx + dx[t])
// against weight rows wrow[t] cin ...
struct PhasePlan {
  int ncls, ntaps, istep, ostep;
  int oy0[kMaxClasses], ox0[kMaxClasses], cnqy[kMaxClasses],
      cnqx[kMaxClasses], tap_end[kMaxClasses];
  int wrow[kMaxTaps], dy[kMaxTaps], dx[kMaxTaps];
};
constexpr int kPlanInts = 4 + 5 * kMaxClasses + 3 * kMaxTaps;
static_assert(sizeof(PhasePlan) == 4 * kPlanInts, "PLAN_BYTES in conv.py");

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

// Class c: its first tap, its tap count, its pixel count.
struct Cls {
  int c, t0, nt, mc;
  __device__ Cls(const Fwd& f, const PhasePlan& p, int cls)
      : c(cls),
        t0(cls ? p.tap_end[cls - 1] : 0),
        nt(p.tap_end[cls] - t0),
        mc(f.batch * p.cnqy[cls] * p.cnqx[cls]) {}
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

}  // namespace
