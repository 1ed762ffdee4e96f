// An LSTM layer's whole recurrence, forward (lstm_fwd) and backward
// (lstm_bwd), one launch a range of steps, for kernels/lstm.py:
// Sketch-RNN's encoder (two directions in one launch) and decoder
// (models/sketch_rnn.py). No TPU kernel: the JAX package has no recurrent
// tower.
//
// The cell (sketch_rnn rnn.LSTMCell, forget bias 1):
//   [i, j, f, o] = x W_x + h W_h + b     (x W_x + b hoisted over all steps)
//   c' = c sigma(f + 1) + sigma(i) tanh(j),  h' = tanh(c') sigma(o)
// A row whose length is at most t keeps its state at step t
// (bidirectional_dynamic_rnn's sequence_length).
//
// What bounds it. A step's product is small (B x H by H x 4H: 0.1 GFLOP at
// the decoder's B 100, H 512) and every step needs the whole of the last
// one's h (or dgates): the chain of 250 dependent steps sets the time, so
// the design keeps a step's path short. Both kernels are persistent over
// their steps:
// - Each block owns a tile of kN = 64 product columns for the rows of one
//   row group and keeps its share of W_h in shared memory for every step,
//   loaded (and in bf16 rounded) once. lstm_fwd: the four gates of 16 units,
//   [n][k] = W_h[k][g H + u0 + j] for n = 16 g + j. lstm_bwd: one gate g
//   (the block's rank in a cluster of four) of 64 units, [n][k] =
//   W_h[u0 + n][g H + k], so the cluster splits dh's k = 4H by gate.
// - At each step a block stages the step's shared operand rows (h_t, or
//   gate g's columns of dgates_{t+1}) from L2 into shared memory in two
//   halves of k, multiplying the first while the second arrives, or where
//   the whole operand leaves no room (fp32's decoder backward at 48 rows,
//   so that B = 100 takes one launch) in four chunks through two slots (bf16:
//   mma.sync m16n8k16, warps split 2 by column and 4 by k, the four k
//   partials added in order; fp32: FMA, k in order), and runs the epilogue:
//   forward the gates, c and h; backward, after one cluster barrier, each
//   block adds the four gates' products for a quarter of the rows in gate
//   order, read through distributed shared memory, then the gate
//   gradients, dc and the dh carry. Epilogue inputs that no other block
//   writes (x W_x, the saved gates and c, the states' cotangents) are
//   fetched before the step's barrier; a block's own c and h (forward) or
//   dh and dc carries (backward) stay in registers across the steps.
// - One barrier ends a step, among the blocks of one direction and row
//   group (rows are independent): a counter in global memory whose high bit
//   flips when the group's last block arrives (the master adds 2^31 - (n -
//   1), the others 1), so it returns to its low bits of zero by itself and
//   a replayed CUDA graph needs no reset. Every block of a launch is
//   resident at once (the host plan launches no more than fit, one a SM).
// - bf16: a step's epilogue also writes its output rounded to bf16 into a
//   two-slot stage, which the next step's operand reads (half the L2
//   bytes), and arrives at the barrier before it stores its fp32 outputs,
//   which no other block reads in the launch; the first step of a range
//   rounds the fp32 input itself.
//
// The bf16 policy is the other kernels': products' operands rounded to bf16
// and summed in fp32; c, h, the gates and every stored value fp32.
// Deterministic: no atomics in any sum; each output adds its k in one fixed
// order, so two runs, or a replayed graph and the eager step, give the
// same bits.

#include <cooperative_groups.h>

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using vae::kThreads;

constexpr int kN = 64;              // product columns a block owns
constexpr int kUnitsF = kN / 4;     // forward: units a block owns, four gates each
constexpr int kLdR = kN + 8;        // fp32 row of a product tile
constexpr int kParts = 4;           // bf16: warps' k groups, each a partial tile
constexpr int kSyncStride = 32;     // words between two groups' barrier counters
constexpr int kFetchRows = 16;      // W_h values a thread loads before it stores them

struct LstmDir {
  const float* xproj;   // [T, B, 4H]: x W_x (+ b), gates in [i, j, f, o] order
  const float* w;       // W_h [H, 4H] as stored
  float* hs;            // [T + 1, B, H], hs[0] the initial state
  float* cs;            // [T + 1, B, H]
  float* gates;         // [T, B, 4H] pre-activations
  float* dgates;        // [T + 1, B, 4H], slot T zero (backward)
  const float* dh_seq;  // [T + 1, B, H]: cotangent of hs (backward; may be null)
  float* dh_acc;        // [B, H]: dh carried (backward)
  float* dc_acc;        // [B, H]: dc carried (backward)
  float* dh0;           // [B, H]: dh of the initial state (backward, step -1)
  __nv_bfloat16* stage; // bf16 only: [2][B][H] forward, [2][B][4H] backward
};

struct LstmArgs {
  LstmDir d[2];
  const float* xrow;    // [B, 4H] added at every step (direction 0), or null
  const int* lengths;   // [B] steps each row runs, or null: all T
  unsigned* sync;       // barrier counters, kSyncStride words apart
  int t0, t1, T, B, H;  // steps [t0, t1) of T (backward: walked down; t0 may be -1)
  int b0, b1, rows;     // this launch's rows [b0, b1), `rows` a row group's
  int nc;               // chunks of k the operand is staged in (Layout)
};

__device__ __forceinline__ float sig(float a) { return 1.f / (1.f + expf(-a)); }

// Shared memory of a block, in bytes from its start (kernels/lstm.py's
// step_plan reports the total). ws: the block's W_h share [kN][ldk]; as:
// the step's operand [tm][lda] staged in nc chunks of k (at the multiples of
// 16 nearest K c / nc): nc = 2, the whole operand (lda = ldk, each chunk at
// its own k); nc = 4, two slots of `slot` bytes, each a chunk; red: the
// product, kParts partial tiles in bf16, one in fp32; tile: the bf16
// backward's partials added, which the cluster reads (fp32 reads red); pf:
// the epilogue's inputs fetched ahead; xr: the forward's per-row addend.
struct Layout {
  int ldk, lda, nc, ws, as, slot, red, tile, pf, xr, total;
};

__host__ __device__ inline Layout lstm_layout(bool fwd, int tm, int H, bool bf16, int nc) {
  Layout l;
  const int esz = bf16 ? 2 : 4, pad = bf16 ? 8 : 4;  // rows of 16 B times an odd number
  l.ldk = H + pad;
  l.nc = nc;
  l.lda = nc > 2 ? 16 * ((H / 16 + nc - 1) / nc) + pad : l.ldk;  // the widest chunk
  l.slot = nc > 2 ? tm * l.lda * esz : 0;
  l.ws = 0;
  l.as = l.ws + kN * l.ldk * esz;
  l.red = l.as + (nc > 2 ? 2 * l.slot : tm * l.ldk * esz);
  l.tile = l.red + (bf16 ? kParts : 1) * tm * kLdR * 4;
  l.pf = l.tile + (fwd || !bf16 ? 0 : tm * kLdR * 4);
  l.xr = l.pf + (fwd ? tm * kN * 4 : (tm / 4) * 7 * kN * 4);
  l.total = l.xr + (fwd ? tm * kN * 4 : 0);
  return l;
}

// The barrier that ends a step, over the n blocks of one group (see the top
// of this file). arrive() after the writes the next step reads, wait()
// before it reads them: the pattern of CUTLASS's semaphore, a release add by
// one thread after the block's barrier and an acquire spin before it. Thread
// 0 holds the high bit the barrier in flight ends on.
struct GroupSync {
  unsigned* ctr;
  unsigned add;
  unsigned gen;

  __device__ GroupSync(unsigned* c, int n, bool master)
      : ctr(c), add(master ? 0x80000000u - (unsigned)(n - 1) : 1u), gen(0) {
    if (threadIdx.x == 0) {
      unsigned v;
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(ctr) : "memory");
      gen = v >> 31;
    }
  }
  __device__ void arrive() {
    __syncthreads();  // the block's writes of the step are done
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(ctr), "r"(add) : "memory");
      gen ^= 1u;
    }
  }
  __device__ void wait() {
    if (threadIdx.x == 0) {
      unsigned v;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(ctr) : "memory");
      } while ((v >> 31) != gen);
    }
    __syncthreads();
  }
};

// Rows [row0, row0 + rows) of the step's operand, its k in [k0, k1) (from
// column col0 + k0 of a source with rows of ld), into `as` ([rows][lda],
// k0 at its column 0, bf16 or fp32), as one cp.async group. bf16: from the
// bf16 stage `src16` (cp.async through L2), or, where it is null, from the
// fp32 `src32` rounded here; fp32: from `src32` (cp.async). Other blocks
// wrote these rows before the barrier: every read goes through L2.
template <bool BF16>
__device__ void stage_rows(unsigned char* as, int lda, const float* src32,
                           const __nv_bfloat16* src16, int ld, int col0, int row0, int rows,
                           int k0, int k1) {
  constexpr int kv = BF16 ? 8 : 4;  // values of a 16-byte piece
  const int per = (k1 - k0) / kv;
  for (int e = threadIdx.x; e < rows * per; e += kThreads) {
    const int r = e / per, c = kv * (e % per);
    const size_t at = (size_t)(row0 + r) * ld + col0 + k0 + c;
    if constexpr (BF16) {
      auto* dst = reinterpret_cast<__nv_bfloat16*>(as) + r * lda + c;
      if (src16 != nullptr) {
        vae::cp_async16(dst, src16 + at, true);
      } else {
        const uint2 lo = vae::pack_bf16x4(__ldcg(reinterpret_cast<const float4*>(src32 + at)));
        const uint2 hi =
            vae::pack_bf16x4(__ldcg(reinterpret_cast<const float4*>(src32 + at + 4)));
        *reinterpret_cast<uint4*>(dst) = make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
    } else {
      vae::cp_async16(reinterpret_cast<float*>(as) + r * lda + c, src32 + at, true);
    }
  }
  vae::cp_async_commit();
}

// A block's product out[r][n] = sum over k of A[r][k] W[n][k], for its TM
// rows and kN columns; A and W in shared memory, k contiguous (rows of lda
// and ldw). run() adds the k16 steps [ks0, ks1), with A holding only those
// (its column 0 at k = 16 ks0), so a product can start on the k that has
// arrived; store() writes the tile(s) (the caller syncs). bf16:
// warp w takes columns 32 (w % 2) .. + 32 and the k16 steps congruent to w
// / 2 mod 4, in order, and stores its partial tile at out + (w / 2) TM kLdR
// (kParts tiles, added in order by the caller). fp32: thread (rg, cg) =
// (tid % 8, tid / 8) sums rows rg + 8 i, columns cg + 32 q, k in order.
template <int TM, bool BF16>
struct Product;

template <int TM>
struct Product<TM, true> {
  static constexpr int MT = TM / 16;
  float acc[MT][4][4] = {};

  __device__ void run(const unsigned char* as, int lda, const unsigned char* ws, int ldw,
                      int ks0, int ks1) {
    const auto* A = reinterpret_cast<const __nv_bfloat16*>(as);
    const auto* W = reinterpret_cast<const __nv_bfloat16*>(ws);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wn = warp & 1, kw = warp >> 1;
    for (int ks = ks0 + ((kw - ks0) & (kParts - 1)); ks < ks1; ks += kParts) {
      const int k0 = 16 * ks;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        vae::ldmatrix_x4(af[mt],
                         A + (16 * mt + (lane & 15)) * lda + k0 - 16 * ks0 + (lane >> 4) * 8);
      uint32_t bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        vae::ldmatrix_x4(r, W + (32 * wn + 16 * np + (lane & 7) + (lane >> 4) * 8) * ldw + k0 +
                                ((lane >> 3) & 1) * 8);
        bf[2 * np][0] = r[0], bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2], bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) vae::mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }

  __device__ void store(float* out) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* o = out + (warp >> 1) * TM * kLdR + 32 * (warp & 1);
    const int g = lane >> 2, cq = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(o + (16 * mt + g + 8 * hh) * kLdR + 8 * nt + 2 * cq) =
              make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
  }
};

template <int TM>
struct Product<TM, false> {
  static constexpr int RT = TM / 8;
  float acc[RT][2] = {};

  __device__ void run(const unsigned char* as, int lda, const unsigned char* ws, int ldw,
                      int ks0, int ks1) {
    const auto* A = reinterpret_cast<const float*>(as);
    const auto* W = reinterpret_cast<const float*>(ws);
    const int rg = threadIdx.x & 7, cg = threadIdx.x >> 3;
    for (int k = 16 * ks0; k < 16 * ks1; k += 4) {
      float4 av[RT], bv[2];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        av[i] = *reinterpret_cast<const float4*>(A + (rg + 8 * i) * lda + k - 16 * ks0);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        bv[q] = *reinterpret_cast<const float4*>(W + (cg + 32 * q) * ldw + k);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          acc[i][q] = fmaf(av[i].x, bv[q].x, acc[i][q]);
          acc[i][q] = fmaf(av[i].y, bv[q].y, acc[i][q]);
          acc[i][q] = fmaf(av[i].z, bv[q].z, acc[i][q]);
          acc[i][q] = fmaf(av[i].w, bv[q].w, acc[i][q]);
        }
    }
  }

  __device__ void store(float* out) const {
    const int rg = threadIdx.x & 7, cg = threadIdx.x >> 3;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) out[(rg + 8 * i) * kLdR + cg + 32 * q] = acc[i][q];
  }
};

// The step's product: the operand staged in NC (= L.nc) chunks of k, each
// a multiple of 16, the product run on one chunk while the next arrives;
// the tile(s) in `red`, whole at return. Before it, the only cp.async group
// in flight is the epilogue's fetch.
template <int TM, bool BF16, int NC>
__device__ void step_product(unsigned char* smem, const Layout& L, const float* src32,
                             const __nv_bfloat16* src16, int ld, int col0, int row0, int rows,
                             int K) {
  constexpr bool kSlots = NC > 2;
  auto ks = [&](int c) { return (K / 16) * c / NC; };  // chunk c's first k16 step
  auto chunk = [&](int c) {  // where chunk c's column 0 lies
    return smem + L.as + (kSlots ? (c & 1) * L.slot : 16 * ks(c) * (BF16 ? 2 : 4));
  };
  auto stage = [&](int c) {
    stage_rows<BF16>(chunk(c), L.lda, src32, src16, ld, col0, row0, rows, 16 * ks(c),
                     16 * ks(c + 1));
  };
  stage(0);
  stage(1);
  Product<TM, BF16> prod;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c + 1 < NC)
      vae::cp_async_wait<1>();
    else
      vae::cp_async_wait<0>();
    __syncthreads();
    prod.run(chunk(c), L.lda, smem + L.ws, L.ldk, ks(c), ks(c + 1));
    if (c + 2 < NC) {
      __syncthreads();  // every warp is done with the slot
      stage(c + 2);
    }
  }
  prod.store(reinterpret_cast<float*>(smem + L.red));
  __syncthreads();
}

template <int TM, bool BF16>
__device__ void step_product(unsigned char* smem, const Layout& L, const float* src32,
                             const __nv_bfloat16* src16, int ld, int col0, int row0, int rows,
                             int K) {
  if (L.nc > 2)
    step_product<TM, BF16, 4>(smem, L, src32, src16, ld, col0, row0, rows, K);
  else
    step_product<TM, BF16, 2>(smem, L, src32, src16, ld, col0, row0, rows, K);
}

// The block's W_h share into shared memory, once: ws[n][k] = src(n, k),
// rounded to bf16 in a bf16 kernel (the old per-step rounding's bits).
// N_FAST: neighbouring threads take neighbouring n (the forward's columns
// lie along W_h's rows), else neighbouring k. Each thread holds kFetchRows
// loads in flight before it stores them.
template <bool BF16, bool N_FAST, class Src>
__device__ void load_share(unsigned char* ws, int ldk, int K, Src src) {
  const int total = kN * K;
  auto nk = [&](int e, int& n, int& k) {
    n = N_FAST ? e % kN : e / K;
    k = N_FAST ? e / kN : e % K;
  };
  for (int e0 = threadIdx.x; e0 < total; e0 += kFetchRows * kThreads) {
    float v[kFetchRows];
#pragma unroll
    for (int s = 0; s < kFetchRows; ++s) {
      const int e = e0 + s * kThreads;
      int n = 0, k = 0;
      nk(e, n, k);
      v[s] = e < total ? src(n, k) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kFetchRows; ++s) {
      const int e = e0 + s * kThreads;
      if (e >= total) continue;
      int n = 0, k = 0;
      nk(e, n, k);
      if constexpr (BF16)
        reinterpret_cast<__nv_bfloat16*>(ws)[n * ldk + k] = __float2bfloat16_rn(v[s]);
      else
        reinterpret_cast<float*>(ws)[n * ldk + k] = v[s];
    }
  }
}

// Zeros the operand's rows [rows, tm) once, in each slot (no step writes
// them), then a barrier: no thread's zeros may land on a row a step stages.
__device__ void zero_padding(unsigned char* smem, const Layout& L, int row_bytes, int rows,
                             int tm) {
  const int n = (tm - rows) * row_bytes / 16;
  for (int s = 0; s < (L.slot ? 2 : 1); ++s)
    for (int e = threadIdx.x; e < n; e += kThreads)
      reinterpret_cast<uint4*>(smem + L.as + s * L.slot + rows * row_bytes)[e] =
          make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
}

// Steps t0 .. t1 - 1 forward. Grid (H / 16 unit groups, row groups,
// directions); a group's barrier spans its H / 16 blocks.
template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd(const __grid_constant__ LstmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LstmDir& d = a.d[blockIdx.z];
  const int H = a.H, N = 4 * H, B = a.B;
  const Layout L = lstm_layout(true, TM, H, BF16, a.nc);
  const int u0 = blockIdx.x * kUnitsF;
  const int row0 = a.b0 + blockIdx.y * a.rows, rows = min(a.rows, a.b1 - row0);
  const float* red = reinterpret_cast<const float*>(smem + L.red);
  float* xs = reinterpret_cast<float*>(smem + L.pf);
  float* xr = reinterpret_cast<float*>(smem + L.xr);
  const float* xrow = blockIdx.z == 0 ? a.xrow : nullptr;
  GroupSync bar(a.sync + (blockIdx.z * gridDim.y + blockIdx.y) * kSyncStride, gridDim.x,
                blockIdx.x == 0);

  const float* w = d.w;
  load_share<BF16, true>(smem + L.ws, L.ldk, H, [&](int n, int k) {
    return __ldg(w + (size_t)k * N + (n / kUnitsF) * H + u0 + n % kUnitsF);
  });
  zero_padding(smem, L, L.lda * (BF16 ? 2 : 4), rows, TM);
  // x W_x's (or xrow's) values of the block's rows and units: [row][16 g + j].
  auto fetch = [&](float* dst, const float* src) {
    for (int e = threadIdx.x; e < rows * 16; e += kThreads) {
      const int r = e / 16, g = (e / 4) % 4, c = 4 * (e % 4);
      vae::cp_async16(dst + r * kN + g * kUnitsF + c, src + (size_t)(row0 + r) * N + g * H + u0 + c,
                      true);
    }
  };
  if (xrow != nullptr) fetch(xr, xrow);

  // This thread's (row, unit) slots of the epilogue, fixed for every step.
  constexpr int kSlots = TM * kUnitsF / kThreads;
  float c[kSlots], h[kSlots];
  int len[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int e = threadIdx.x + kThreads * m, i = e / kUnitsF, j = e % kUnitsF;
    c[m] = h[m] = 0.f;
    len[m] = INT_MAX;
    if (i < rows) {
      const size_t bh = (size_t)(row0 + i) * H + u0 + j;
      c[m] = d.cs[(size_t)a.t0 * B * H + bh];
      h[m] = d.hs[(size_t)a.t0 * B * H + bh];
      if (a.lengths != nullptr) len[m] = a.lengths[row0 + i];
    }
  }

  for (int t = a.t0; t < a.t1; ++t) {
    fetch(xs, d.xproj + (size_t)t * B * N);
    vae::cp_async_commit();
    if (t > a.t0) bar.wait();  // h_t is whole
    const __nv_bfloat16* staged =
        BF16 && t > a.t0 ? d.stage + (size_t)(t & 1) * B * H : nullptr;
    step_product<TM, BF16>(smem, L, d.hs + (size_t)t * B * H, staged, H, 0, row0, rows, H);
    float pre[kSlots][4];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int e = threadIdx.x + kThreads * m, i = e / kUnitsF, j = e % kUnitsF;
      if (i >= rows) continue;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int n = g * kUnitsF + j;
        float v = red[i * kLdR + n];
#pragma unroll
        for (int p = 1; p < (BF16 ? kParts : 1); ++p) v += red[(p * TM + i) * kLdR + n];
        v += xs[i * kN + n];
        if (xrow != nullptr) v += xr[i * kN + n];
        pre[m][g] = v;
      }
      if (t < len[m]) {
        c[m] = c[m] * sig(pre[m][2] + 1.f) + sig(pre[m][0]) * tanhf(pre[m][1]);
        h[m] = tanhf(c[m]) * sig(pre[m][3]);
      }
      if constexpr (BF16)
        d.stage[(size_t)((t + 1) & 1) * B * H + (size_t)(row0 + i) * H + u0 + j] =
            __float2bfloat16_rn(h[m]);
    }
    // bf16: the next step reads only the stage, so the fp32 outputs are
    // stored after the arrival.
    if (BF16 && t + 1 < a.t1) bar.arrive();
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int e = threadIdx.x + kThreads * m, i = e / kUnitsF, j = e % kUnitsF;
      if (i >= rows) continue;
      const int b = row0 + i, u = u0 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) d.gates[((size_t)t * B + b) * N + g * H + u] = pre[m][g];
      const size_t bh = (size_t)b * H + u;
      d.cs[(size_t)(t + 1) * B * H + bh] = c[m];
      d.hs[(size_t)(t + 1) * B * H + bh] = h[m];
    }
    if (!BF16 && t + 1 < a.t1) bar.arrive();  // fp32: h_{t+1} is the next operand
  }
}

// Steps t1 - 1 down to t0 backward (t = -1: dh of the initial state).
// Grid (unit groups of 64, row groups, 4 x directions), clusters of the
// four gates; a group's barrier spans its 4 x unit-group blocks.
template <int TM, bool BF16>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd(const __grid_constant__ LstmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = (int)cluster.block_rank();  // this block's gate: its quarter of the product's k
  const int dir = blockIdx.z / 4;
  const LstmDir& d = a.d[dir];
  const int H = a.H, N = 4 * H, B = a.B, T = a.T;
  const Layout L = lstm_layout(false, TM, H, BF16, a.nc);
  const int u0 = blockIdx.x * kN;
  const int row0 = a.b0 + blockIdx.y * a.rows, rows = min(a.rows, a.b1 - row0);
  const int q = (rows + 3) / 4, r0 = g * q, rq = max(0, min(q, rows - r0));  // epilogue rows
  constexpr int kQ = TM / 4;
  const float* red = reinterpret_cast<const float*>(smem + L.red);
  float* tile = reinterpret_cast<float*>(smem + (BF16 ? L.tile : L.red));  // [TM][kLdR]
  const float* part[4];  // the four gates' products, in the cluster's blocks
#pragma unroll
  for (int k = 0; k < 4; ++k) part[k] = cluster.map_shared_rank(tile, k);
  float* pf = reinterpret_cast<float*>(smem + L.pf);  // [kQ][4][kN] gates, then c', c, dh
  float* pf_cn = pf + kQ * 4 * kN;
  float* pf_cp = pf_cn + kQ * kN;
  float* pf_dh = pf_cp + kQ * kN;
  GroupSync bar(a.sync + (dir * gridDim.y + blockIdx.y) * kSyncStride, 4 * gridDim.x,
                blockIdx.x == 0 && g == 0);

  const float* w = d.w;
  load_share<BF16, false>(smem + L.ws, L.ldk, H, [&](int n, int k) {
    return u0 + n < H ? __ldg(w + (size_t)(u0 + n) * N + g * H + k) : 0.f;
  });
  zero_padding(smem, L, L.lda * (BF16 ? 2 : 4), rows, TM);

  // Step t's epilogue inputs of the block's rows and units, one cp.async group.
  auto fetch = [&](int t) {
    constexpr int kPer = 112;  // 16-byte pieces a row: 4 x 16 gates, 16 each of c', c, dh
    for (int e = threadIdx.x; e < rq * kPer; e += kThreads) {
      const int il = e / kPer, p = e % kPer, b = row0 + r0 + il;
      const int c = 4 * (p % 16), u = u0 + c;
      if (u >= H || (p >= 96 && d.dh_seq == nullptr)) continue;
      if (p < 64) {
        const int gg = p / 16;
        vae::cp_async16(pf + (il * 4 + gg) * kN + c, d.gates + ((size_t)t * B + b) * N + gg * H + u,
                        true);
      } else if (p < 80) {
        vae::cp_async16(pf_cn + il * kN + c, d.cs + ((size_t)(t + 1) * B + b) * H + u, true);
      } else if (p < 96) {
        vae::cp_async16(pf_cp + il * kN + c, d.cs + ((size_t)t * B + b) * H + u, true);
      } else {
        vae::cp_async16(pf_dh + il * kN + c, d.dh_seq + ((size_t)(t + 1) * B + b) * H + u, true);
      }
    }
    vae::cp_async_commit();
  };

  constexpr int kSlots = kQ * kN / kThreads;
  float dh[kSlots], dc[kSlots];
  int len[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int e = threadIdx.x + kThreads * m, il = e / kN, u = u0 + e % kN;
    dh[m] = dc[m] = 0.f;
    len[m] = INT_MAX;
    if (il < rq && u < H) {
      const int b = row0 + r0 + il;
      dh[m] = d.dh_acc[(size_t)b * H + u];
      dc[m] = d.dc_acc[(size_t)b * H + u];
      if (a.lengths != nullptr) len[m] = a.lengths[b];
    }
  }

  if (a.t1 - 1 >= 0) fetch(a.t1 - 1);
  for (int t = a.t1 - 1; t >= a.t0; --t) {
    if (t + 1 < a.t1) bar.wait();  // dgates_{t+1} is whole
    const __nv_bfloat16* staged =
        BF16 && t + 1 < a.t1 ? d.stage + (size_t)((t + 1) & 1) * B * N : nullptr;
    step_product<TM, BF16>(smem, L, d.dgates + (size_t)(t + 1) * B * N, staged, N, g * H, row0,
                           rows, H);
    if constexpr (BF16) {  // the warps' partials added in order
      for (int e = threadIdx.x; e < rows * kN; e += kThreads) {
        const int at = (e / kN) * kLdR + e % kN;
        tile[at] = ((red[at] + red[TM * kLdR + at]) + red[2 * TM * kLdR + at]) +
                   red[3 * TM * kLdR + at];
      }
    }
    cluster.sync();  // the four gates' products are whole
    float dg[kSlots][4];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int e = threadIdx.x + kThreads * m, il = e / kN, j = e % kN, u = u0 + j;
      if (il >= rq || u >= H) continue;
      const int b = row0 + r0 + il, at = (r0 + il) * kLdR + j;
      const float p = ((part[0][at] + part[1][at]) + part[2][at]) + part[3][at];
      const bool next = t + 1 < T && t + 1 < len[m];
      const float carry = p + (next ? 0.f : dh[m]);
      if (t < 0) {
        d.dh0[(size_t)b * H + u] = carry;
        continue;
      }
      const float dhv = (d.dh_seq != nullptr ? pf_dh[il * kN + j] : 0.f) + carry;
      dh[m] = dhv;
      dg[m][0] = dg[m][1] = dg[m][2] = dg[m][3] = 0.f;
      if (t < len[m]) {
        const float* pre = pf + il * 4 * kN + j;
        const float i = sig(pre[0]), jj = tanhf(pre[kN]), f = sig(pre[2 * kN] + 1.f);
        const float o = sig(pre[3 * kN]);
        const float tc = tanhf(pf_cn[il * kN + j]);
        const float dcv = dc[m] + dhv * o * (1.f - tc * tc);
        dg[m][0] = dcv * jj * (i * (1.f - i));
        dg[m][1] = dcv * i * (1.f - jj * jj);
        dg[m][2] = dcv * pf_cp[il * kN + j] * (f * (1.f - f));
        dg[m][3] = dhv * tc * (o * (1.f - o));
        dc[m] = dcv * f;
      }  // else the state was held: the gradient passes through
      if constexpr (BF16) {
        __nv_bfloat16* st = d.stage + (size_t)(t & 1) * B * N + (size_t)b * N + u;
#pragma unroll
        for (int k = 0; k < 4; ++k) st[k * H] = __float2bfloat16_rn(dg[m][k]);
      }
    }
    // bf16: the next step reads only the stage, so dgates in fp32 is stored
    // after the arrival. Both arrivals end the epilogue's reads of pf, so
    // the next step's fetch follows them.
    if (BF16 && t > a.t0) {
      bar.arrive();
      if (t - 1 >= 0) fetch(t - 1);
    }
    if (t >= 0) {
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int e = threadIdx.x + kThreads * m, il = e / kN, u = u0 + e % kN;
        if (il >= rq || u >= H) continue;
        const size_t bn = ((size_t)t * B + row0 + r0 + il) * N + u;
#pragma unroll
        for (int k = 0; k < 4; ++k) d.dgates[bn + k * H] = dg[m][k];
      }
    }
    if (!BF16 && t > a.t0) {  // fp32: dgates_t is the next operand
      bar.arrive();
      if (t - 1 >= 0) fetch(t - 1);
    }
  }
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int e = threadIdx.x + kThreads * m, il = e / kN, u = u0 + e % kN;
    if (il >= rq || u >= H) continue;
    const size_t bh = (size_t)(row0 + r0 + il) * H + u;
    d.dh_acc[bh] = dh[m];
    d.dc_acc[bh] = dc[m];
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// The barrier alone, `steps` times, over groups of gridDim.x blocks: its
// cost a step is the floor of the kernels above. Only chip_smoke.py's phase
// 15 calls it, to measure that floor; no layer runs it.
__global__ void __launch_bounds__(kThreads, 1) lstm_sync_probe(unsigned* sync, int steps) {
  GroupSync bar(sync + blockIdx.y * kSyncStride, gridDim.x, blockIdx.x == 0);
  for (int s = 0; s < steps; ++s) {
    bar.arrive();
    bar.wait();
  }
}

// Rows a tile. 48 lets the backward's clusters, of which an H100 holds 30
// at once (120 blocks: three row groups of 32), cover B = 100 in one launch
// (fp32's decoder with the operand in four chunks).
constexpr int kTileRows[4] = {16, 32, 48, 64};

template <bool FWD, bool BF16>
const void* lstm_kernel(int tm) {
  if constexpr (FWD)
    return tm == 16   ? (const void*)lstm_fwd<16, BF16>
           : tm == 32 ? (const void*)lstm_fwd<32, BF16>
           : tm == 48 ? (const void*)lstm_fwd<48, BF16>
                      : (const void*)lstm_fwd<64, BF16>;
  else
    return tm == 16   ? (const void*)lstm_bwd<16, BF16>
           : tm == 32 ? (const void*)lstm_bwd<32, BF16>
           : tm == 48 ? (const void*)lstm_bwd<48, BF16>
                      : (const void*)lstm_bwd<64, BF16>;
}

const void* lstm_kernel(bool fwd, bool bf16, int tm) {
  return fwd ? (bf16 ? lstm_kernel<true, true>(tm) : lstm_kernel<true, false>(tm))
             : (bf16 ? lstm_kernel<false, true>(tm) : lstm_kernel<false, false>(tm));
}

// Blocks of a kernel that are resident at once at `smem` bytes: one a SM
// (more would share an SM's cores and shared-memory bandwidth), and for the
// backward whole clusters of four, as many as the device places together.
// Cached per (device, kernel, bytes), like vae::launch_info.
cudaError_t resident_blocks(bool fwd, const void* fn, int smem, int* blocks) {
  struct Entry {
    int dev;
    const void* fn;
    int smem, blocks;
  };
  static std::mutex mu;
  static Entry seen[64];
  static int n_seen = 0;
  int dev = 0, per_sm = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_seen; ++i)
      if (seen[i].dev == dev && seen[i].fn == fn && seen[i].smem == smem) {
        *blocks = seen[i].blocks;
        return cudaSuccess;
      }
  }
  e = vae::launch_info(fn, smem, &per_sm);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int n = per_sm > 0 ? n_sm : 0;
  if (!fwd && n > 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 1, 4);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 4;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (e != cudaSuccess) return e;
    n = std::min(n, 4 * clusters);
  }
  std::lock_guard<std::mutex> lock(mu);
  if (n_seen < 64) seen[n_seen++] = Entry{dev, fn, smem, n};
  *blocks = n;
  return cudaSuccess;
}

// A launch's split: TM rows a tile, `rows` a row group (<= TM), `chunk`
// rows a launch (all B where they fit at once), `per_group` blocks a row
// group and direction(s), the operand's chunks of k (two, or four where two
// leave no room), shared memory and the resident blocks it was planned
// for. The smallest TM whose row groups cover B in one launch; else the
// largest that fits, over several launches.
struct Plan {
  int tm, rows, chunk, per_group, nc, smem, resident;
};

cudaError_t lstm_plan(bool fwd, int n_dirs, int B, int H, bool bf16, Plan* p) {
  p->per_group = n_dirs * (fwd ? H / kUnitsF : 4 * ((H + kN - 1) / kN));
  bool found = false;
  for (int tm : kTileRows) {
    int nc = 2, smem = lstm_layout(fwd, tm, H, bf16, nc).total;
    if (smem > vae::kSmemLimit) nc = 4, smem = lstm_layout(fwd, tm, H, bf16, nc).total;
    if (smem > vae::kSmemLimit) break;
    int resident = 0;
    const cudaError_t e = resident_blocks(fwd, lstm_kernel(fwd, bf16, tm), smem, &resident);
    if (e != cudaSuccess) return e;
    const int groups = resident / p->per_group;
    if (groups < 1) break;
    found = true;
    p->tm = tm, p->nc = nc, p->smem = smem, p->resident = resident;
    p->chunk = std::min(B, tm * groups);
    if (p->chunk == B) break;
  }
  if (!found) return cudaErrorInvalidValue;  // H too wide for the SMs' shared memory
  const int groups = p->resident / p->per_group;
  p->rows = (p->chunk + groups - 1) / groups;
  return cudaSuccess;
}

int run_lstm(bool fwd, const LstmDir* dirs, int n_dirs, const void* xrow, const void* lengths,
             void* sync, int n_sync, int t0, int t1, int T, int B, int H, int bf16, void* stream,
             int* launches) {
  *launches = 0;
  if (B <= 0 || T <= 0 || H <= 0 || H % 16 != 0 || n_dirs < 1 || n_dirs > 2 || t1 > T ||
      t0 >= t1 || t0 < (fwd ? 0 : -1) || sync == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n_dirs; ++k)
    if (bf16 && dirs[k].stage == nullptr) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = lstm_plan(fwd, n_dirs, B, H, bf16 != 0, &p);
  if (e != cudaSuccess) return (int)e;
  const void* fn = lstm_kernel(fwd, bf16 != 0, p.tm);
  LstmArgs args = {};
  for (int k = 0; k < n_dirs; ++k) args.d[k] = dirs[k];
  args.xrow = static_cast<const float*>(xrow);
  args.lengths = static_cast<const int*>(lengths);
  args.sync = static_cast<unsigned*>(sync);
  args.t0 = t0, args.t1 = t1, args.T = T, args.B = B, args.H = H, args.nc = p.nc;
  const int max_groups = p.resident / p.per_group;
  for (int b0 = 0; b0 < B; b0 += p.chunk) {
    args.b0 = b0;
    args.b1 = std::min(B, b0 + p.chunk);
    args.rows = (args.b1 - b0 + max_groups - 1) / max_groups;  // p.rows in the first
    const int groups = (args.b1 - b0 + args.rows - 1) / args.rows;
    if (groups * n_dirs > n_sync) return (int)cudaErrorInvalidValue;
    void* kargs[] = {&args};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = fwd ? dim3(H / kUnitsF, groups, n_dirs)
                      : dim3((H + kN - 1) / kN, groups, 4 * n_dirs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeCooperative;  // every block resident, or refused
    attrs[0].val.cooperative = 1;
    attrs[1].id = cudaLaunchAttributeClusterDimension;  // backward: the four gates of a tile
    attrs[1].val.clusterDim.x = 1;
    attrs[1].val.clusterDim.y = 1;
    attrs[1].val.clusterDim.z = 4;
    cfg.attrs = attrs;
    cfg.numAttrs = fwd ? 1 : 2;
    e = cudaLaunchKernelExC(&cfg, fn, kargs);
    const cudaError_t last = cudaGetLastError();  // clears a refused launch
    if (e == cudaSuccess) e = last;
    if (e != cudaSuccess) return (int)e;
    ++*launches;
  }
  return (int)cudaSuccess;
}

}  // namespace

// Steps [t0, t1) of `n_dirs` LSTM directions (their LstmDir rows at
// `dirs`, a host array) over B rows of width H (a multiple of 16): lstm_fwd
// walks t0 .. t1 - 1 (0 <= t0 < t1 <= T), lstm_bwd t1 - 1 down to t0 (t0 =
// -1 adds dh of the initial state). `xrow` (direction 0's per-row addend)
// and `lengths` (int32 [B]) may be null. `sync` holds `n_sync` barrier
// counters kSyncStride words apart, zero at first (kernels/lstm.py keeps
// them; each barrier leaves them as it found them). Launches on `stream`
// without synchronising, one launch a chunk of rows (one where B fits),
// counted in *launches, and returns the first CUDA error.
extern "C" int vae_lstm_fwd(const void* dirs, int n_dirs, const void* xrow, const void* lengths,
                            void* sync, int n_sync, int t0, int t1, int T, int B, int H,
                            int bf16, void* stream, int* launches) {
  return run_lstm(true, static_cast<const LstmDir*>(dirs), n_dirs, xrow, lengths, sync, n_sync,
                  t0, t1, T, B, H, bf16, stream, launches);
}

extern "C" int vae_lstm_bwd(const void* dirs, int n_dirs, const void* lengths, void* sync,
                            int n_sync, int t0, int t1, int T, int B, int H, int bf16,
                            void* stream, int* launches) {
  return run_lstm(false, static_cast<const LstmDir*>(dirs), n_dirs, nullptr, lengths, sync,
                  n_sync, t0, t1, T, B, H, bf16, stream, launches);
}

// The split run_lstm takes, into out[8]: rows a tile, rows a group, rows a
// launch, blocks a row group, the operand's chunks of k, shared memory
// bytes, resident blocks, and the launches it makes.
extern "C" int vae_lstm_plan(int fwd, int n_dirs, int B, int H, int bf16, int* out) {
  if (B <= 0 || H <= 0 || H % 16 != 0 || n_dirs < 1 || n_dirs > 2)
    return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = lstm_plan(fwd != 0, n_dirs, B, H, bf16 != 0, &p);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {p.tm, p.rows, p.chunk, p.per_group, p.nc, p.smem, p.resident,
                    (B + p.chunk - 1) / p.chunk};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}

// The barrier alone: `steps` of it over `groups` groups of `per_group`
// blocks (lstm_sync_probe), on `stream`.
extern "C" int vae_lstm_sync_probe(void* sync, int n_sync, int groups, int per_group, int steps,
                                   void* stream) {
  if (groups < 1 || groups > n_sync || per_group < 1 || steps < 1)
    return (int)cudaErrorInvalidValue;
  lstm_sync_probe<<<dim3(per_group, groups), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(sync), steps);
  return (int)cudaGetLastError();
}
