// Online-softmax grouped-query attention, fp32, for prefill (S > 1).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention :98, pallas_call at :124).  There the grid is
// (batch, q_head, q_block, k_block) with the k_block axis sequential on
// one core, carrying the running max m, sum l and accumulator acc in
// VMEM scratch, and a k block that every (q, k) pair of it masks is
// skipped with @pl.when.  Blocks on Hopper run in parallel and in no
// order, so here the k axis is a loop inside the block and m, l, acc live
// in registers.  What it computes is repro_torch/kernels/ref.py
// attention, with v of width Dv (equal to D: 16, 32, 64, 112 for
// zamba2, 128, 224 for the published Zamba2's shared blocks; or 128 at
// D = 192 for the materialized MLA prefill):
//
//   s[q, t] = scale * q[b, q, h, :] . k[b, t, h / g, :]
//   visible = kpos[t] >= 0  &&  (!causal || kpos[t] <= qpos[q])
//                           &&  (!window || qpos[q] - kpos[t] < window)
//   out[b, q, h, :] = softmax_t(visible ? s : -1e30) @ v[b, :, h / g, :]
//
// Masked scores are -1e30, never -inf: a tile whose keys a row cannot
// see gives exp(-1e30 - -1e30) = 1, and the first visible key later
// wipes that with alpha = exp(-1e30 - m) = 0.  The softmax runs in
// base 2 (exp2f of scores multiplied by scale * log2 e), which is the
// same function.
//
// What bounds it on the card: the operations, 2 (D + Dv) FLOPs per
// visible (q, k) pair and head.  At the qwen3-4b prefill shape (B = 4,
// S = T = 2048, Hq = 32, Hkv = 8, D = 128, causal) 137.4 GFLOP a layer:
// 2.05 ms at the 67 TFLOP/s of fp32 FMAs on the CUDA cores, where the
// first version of this kernel ran (46 % of that rate, 4.43 ms on an
// H100 at 700 W).  Here both products run on the tensor cores as
// 3xTF32 (hopper.cuh: each operand split into a TF32 big part and the
// TF32 of its remainder, small * big + big * small + big * big summed by
// mma.sync.m16n8k8 in fp32), three TF32 products for each fp32 one:
// 3 x 137.4 GFLOP at 495 TFLOP/s is 0.833 ms at qwen's shape, 0.521 ms
// at the DeepSeek-V2-Lite MLA prefill (Hq = Hkv = 16, D = 192, Dv =
// 128) and 0.364 ms under a 512-token window.  Plain TF32 (one product)
// would move a D = 128 output by ~1e-3, beyond the port's 1e-4.  The
// bytes (q, k, v read once and o written once) are ~0.1 ms.
//
// The design, for that bound:
// * A block takes BQ = 128 query rows of one (query head, batch): 8
//   warps, each owning 16 rows (the m16 of the mma), so the scores S =
//   Q K^T of a key tile are a warp's accumulator fragments and the online
//   softmax runs in registers: row max and row sum over the 4 lanes of a
//   quad (__shfl_xor_sync 1, 2), the sum kept per lane and added over
//   the quad once, at the end.  P V goes into the warp's 16 x Dv output
//   fragment.
// * P reaches the A operand of P V without shared memory: a lane's
//   accumulator holds keys 2t and 2t + 1 of each k8 step, the A fragment
//   wants t and t + 4, so each k8 step takes its keys in the order 0, 2,
//   4, 6 | 1, 3, 5, 7 and reads V's rows in that order (as
//   decode_attention.cu does).
// * Precision: the tensor cores truncate as they add, so Q K^T sums into
//   a fresh fragment for 32 of D and each such stage is added into the
//   fp32 scores on the CUDA cores (moe_gmm.cu, ssd.cu); where 32 does not
//   divide D (zamba2's D = 112 = 3 x 32 + 16) the last stage takes the
//   16 left, in a fresh fragment of its own (qk_stage).  P V sums one key
//   tile into a fresh fragment, added as o = o * alpha + part, in passes
//   of VCH n8 tiles of Dv: 8, or 7 at Dv = 112 (two passes of 14).
// * Operands are split on the fly (split_tf32: two integer ops a value)
//   from fp32 tiles in shared memory, rows padded to 4 mod 32 floats so
//   that every fragment load is free of bank conflicts; the Q and K
//   fragments come in by ldmatrix, four 8 x 4 fp32 tiles an instruction
//   (3 % faster than scalar loads at qwen's shape), V's by scalar loads
//   (its fragments run down the columns of a row-major tile).  Q is
//   staged once; K and V go through a two-slot cp.async ring, the next
//   live tile in flight while this one is multiplied, with one barrier a
//   tile.  BK = 64 keys a tile for D <= 128 (203 KB of shared memory at
//   D = 128, and at D = 112, whose rows pad to the same 132 floats), 32
//   at D = 192 (185 KB): one block of 8 warps an SM.  At D = Dv = 224
//   (rows of 228 floats) 128 query rows and two 32-key slots would take
//   233,728 bytes, over the 232,448 a block may have, so the tiles take
//   BK = 16 keys (171 KB, one block of 8 warps an SM; a lane of the
//   kpos passes past BK reads none).  At B = 4, S = T = 3584 causal,
//   on an H100 (700 W), that is 16.64 ms a call against 22.59 for 64
//   query rows in 4 warps with 32-key tiles, which also spilled 84
//   bytes a thread to this plan's 8 (both 255 registers: a warp's
//   16 x 224 output fragment, 112 floats a lane, is why the warps are
//   not also halved along Dv).
//   Unrolling the stages of Q K^T was slower (2.68 against 2.55 ms).
// * Which tiles are live is known before the loop: the block first reads
//   the kpos of every tile (all at once, a pass of up to 1024 tiles) and
//   keeps a bit a tile; a tile is live when some key of it is valid and,
//   causal, its least position is at most the block's greatest query
//   position, and, windowed, its greatest position is less than
//   `window` behind the block's least query position.  A dead tile is
//   neither copied nor waited for, so causal prefill does about half the
//   work of a dense sweep.  Inside a live tile, a warp skips a tile no
//   row of its own can see, and masks only tiles some of whose pairs it
//   cannot see.
// * The grid is one-dimensional with the query tiles slowest and taken
//   from the last: the heaviest causal tiles start first, and the grid
//   does not end on a tail of heavy blocks.
// * One block writes each output, in a fixed order, with no atomics and
//   no split over T: a call is bitwise repeatable at a fixed shape.
// On an H100 (700 W) qwen3-4b's prefill shape takes 2.55-2.59 ms here,
// 3.1x its 3xTF32 bound (chip_smoke.py phase 2); the next step is wgmma,
// whose 32-bit operands must be K-major in shared memory (V transposed
// on the way in).
//
// A row that sees no key at all in the tiles its warp visits gets the
// mean of v over those tiles, counting the rows past T as zeros
// (ref.attention gives the mean over all T); no row of the LM path has
// one, since a query always sees its own key.  A single decode token
// (S = 1) is the work of decode_attention.cu, whose wrapper ops.attention
// calls instead.  Ragged edges (S, T not multiples of the tiles) are
// masked in the kernel: K/V rows past T are zero-filled by cp.async and
// read as empty slots (kpos = -1), rows past S are computed and not
// stored.  Nothing is padded by the wrapper.
#include <cuda_runtime.h>

#include <atomic>
#include <climits>

namespace {

#include "hopper.cuh"

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PASS_TILES = 1024;   // key tiles whose liveness a pass holds

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* qpos;
  const int* kpos;
  float* o;
  int B, S, T, Hq, Hkv, g, causal, window, n_qt;
  float scale_log2;            // scale * log2(e)
};

// rows of a tile: 4 mod 32 floats (conflict-free fragment loads)
constexpr int pad_ld(int width) { return width + (36 - width % 32) % 32; }

// the largest divisor of n that is at most m
constexpr int largest_divisor(int n, int m) {
  return n % m == 0 ? m : largest_divisor(n, m - 1);
}

template <int D, int DV>
struct Cfg {
  static constexpr int BQ = 128;                  // query rows a block
  static constexpr int NW = BQ / 16;              // warps, 16 rows each
  static constexpr int NT = 32 * NW;
  static constexpr int BK = D > 192 ? 16 : D > 128 ? 32 : 64;  // keys a tile
  static constexpr int KPL = (BK + 31) / 32;      // kpos a lane reads a tile
  static constexpr int LDQ = pad_ld(D);           // rows of Q and K
  static constexpr int LDV = pad_ld(DV);
  static constexpr int NT8 = BK / 8;              // score n8 tiles a warp
  static constexpr int KS = D / 8;                // k8 steps of Q K^T
  static constexpr int STG = KS < 4 ? KS : 4;     // k8 steps a stage (32)
  static constexpr int N_STG = KS / STG;          // whole stages
  static constexpr int TAIL = KS % STG;           // k8 steps of a short
                                                  // last stage (2 at 112)
  static constexpr int VT8 = DV / 8;              // output n8 tiles
  static constexpr int VCH = largest_divisor(VT8, 8);   // n8 tiles a P V
                                                        // pass (7 at 112)
  static constexpr int K_FL = BK * LDQ, V_FL = BK * LDV;
  static constexpr int SLOT_FL = K_FL + V_FL + BK;   // K, V, kpos
  static constexpr int BYTES = 4 * (BQ * LDQ + 2 * SLOT_FL);
  static_assert(D % 8 == 0 && DV % 8 == 0, "dims");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// rows [r0, r0 + R) of a [rows, H, W] tensor (row stride `row_stride`
// floats, `base` already offset to the head) into R x LD floats of
// shared memory; rows >= n_rows are zero-filled
template <int W, int LD, int R, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* base,
                                           long long row_stride, int r0,
                                           int n_rows) {
  constexpr int V4 = W / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < R * V4; i += NT) {
    const int r = i / V4, c = (i - r * V4) * 4;
    const int row = r0 + r;
    const bool in = row < n_rows;
    cp_async<16>(dst + r * LD + c, in ? base + row * row_stride + c : base,
                 in);
  }
}

// may some pair of (keys [kmin, kmax], queries [lo, hi]) be visible?
// kmax < 0: no valid key; lo > hi: no query
__device__ __forceinline__ bool tile_live(int kmin, int kmax, int lo, int hi,
                                          const Params& p) {
  bool live = kmax >= 0 && lo <= hi;
  if (p.causal) live = live && kmin <= hi;
  if (p.window)
    live = live && static_cast<long long>(kmax) >
                       static_cast<long long>(lo) - p.window;
  return live;
}

__device__ __forceinline__ bool visible(int qp, int kp, const Params& p) {
  bool ok = kp >= 0;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window) ok = ok && static_cast<long long>(qp) - kp < p.window;
  return ok;
}

// four 8 x 4 fp32 tiles of shared memory in one instruction (ldmatrix of
// 8 x 8 b16): lanes 8m .. 8m + 7 give the rows of tile m, and lane
// (g, t) gets word t of row g of each tile, which is where the m16n8k8
// A and B fragments want an fp32 value
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const float* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void split4(const unsigned (&x)[4],
                                       unsigned (&big)[4],
                                       unsigned (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32(__uint_as_float(x[i]), big[i], small[i]);
}

// one stage of S = Q K^T: NKS k8 steps of D from column k0, 3xTF32
// (small * big + big * small + big * big), summed in a fresh fragment
// and added into the fp32 scores s
template <int NKS, int NT8, int LDQ>
__device__ __forceinline__ void qk_stage(float (&s)[NT8][4],
                                         const float* qrow,
                                         const float* krow, int k0) {
  float part[NT8][4];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) part[nt][r] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int k = k0 + 8 * ks;
    unsigned x[4], ab[4], as[4];
    ldsm4(x, qrow + k);              // (g, t) (g+8, t) (g, t+4) (g+8, t+4)
    split4(x, ab, as);
    unsigned bb[NT8][2], bs[NT8][2];
#pragma unroll
    for (int nt = 0; nt < NT8; nt += 2) {   // K[key][d], two n8 tiles
      unsigned y[4], yb[4], ys[4];
      ldsm4(y, krow + nt * 8 * LDQ + k);    // (t, g) (t+4, g) of each
      split4(y, yb, ys);
      bb[nt][0] = yb[0];
      bb[nt][1] = yb[1];
      bb[nt + 1][0] = yb[2];
      bb[nt + 1][1] = yb[3];
      bs[nt][0] = ys[0];
      bs[nt][1] = ys[1];
      bs[nt + 1][0] = ys[2];
      bs[nt + 1][1] = ys[3];
    }
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) mma(part[nt], as, bb[nt]);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) mma(part[nt], ab, bs[nt]);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) mma(part[nt], ab, bb[nt]);
  }
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[nt][r] += part[nt][r];
}

// the first live tile after j (n when none)
__device__ __forceinline__ int next_live(const unsigned* bits, int j, int n) {
  for (int i = j + 1; i < n; i = (i | 31) + 1) {
    const unsigned w = bits[i >> 5] >> (i & 31);
    if (w) return i + __ffs(static_cast<int>(w)) - 1;
  }
  return n;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int D, int DV>
__global__ void __launch_bounds__(Cfg<D, DV>::NT, 1)
    flash_prefill_kernel(Params p) {
  using C = Cfg<D, DV>;
  constexpr int BK = C::BK, NW = C::NW, NT = C::NT, LDQ = C::LDQ,
                LDV = C::LDV, NT8 = C::NT8, KPL = C::KPL;
  extern __shared__ __align__(16) float sm[];
  __shared__ unsigned live_bits[PASS_TILES / 32];
  __shared__ int wq_lo[NW], wq_hi[NW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  int bid = blockIdx.x;                  // (head fastest, batch, q tile)
  const int h = bid % p.Hq;
  bid /= p.Hq;
  const int b = bid % p.B;
  const int s0 = (p.n_qt - 1 - bid / p.B) * C::BQ;   // last tiles first
  const int kh = h / p.g;
  const long long k_stride = static_cast<long long>(p.Hkv) * D;
  const long long v_stride = static_cast<long long>(p.Hkv) * DV;
  const float* kb = p.k + (static_cast<long long>(b) * p.T * p.Hkv + kh) * D;
  const float* vb =
      p.v + (static_cast<long long>(b) * p.T * p.Hkv + kh) * DV;
  float* Qs = sm;                                    // [BQ][LDQ]
  float* ring = sm + C::BQ * LDQ;                    // 2 x (K, V, kpos)

  stage_rows<D, LDQ, C::BQ, NT>(
      Qs, p.q + (static_cast<long long>(b) * p.S * p.Hq + h) * D,
      static_cast<long long>(p.Hq) * D, s0, p.S);
  cp_async_commit();

  // this lane's rows (g and g + 8 of the warp's 16) and the warp's and
  // block's query position ranges over the rows that exist
  const int row0 = s0 + 16 * warp + g, row1 = row0 + 8;
  const int qp0 = row0 < p.S ? p.qpos[row0] : 0;
  const int qp1 = row1 < p.S ? p.qpos[row1] : 0;
  int wlo = min(row0 < p.S ? qp0 : INT_MAX, row1 < p.S ? qp1 : INT_MAX);
  int whi = max(row0 < p.S ? qp0 : INT_MIN, row1 < p.S ? qp1 : INT_MIN);
  wlo = warp_min(wlo);
  whi = warp_max(whi);
  if (lane == 0) {
    wq_lo[warp] = wlo;
    wq_hi[warp] = whi;
  }
  __syncthreads();
  int q_lo = INT_MAX, q_hi = INT_MIN;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    q_lo = min(q_lo, wq_lo[w]);
    q_hi = max(q_hi, wq_hi[w]);
  }

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[C::VT8][4];
#pragma unroll
  for (int n = 0; n < C::VT8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.f;

  // K, V and kpos of tile j into ring slot `slot`, one copy group
  auto issue = [&](int j, int slot) {
    float* Ks = ring + slot * C::SLOT_FL;
    float* Vs = Ks + C::K_FL;
    float* kps = Vs + C::V_FL;
    const int t0 = j * BK;
    stage_rows<D, LDQ, BK, NT>(Ks, kb, k_stride, t0, p.T);
    stage_rows<DV, LDV, BK, NT>(Vs, vb, v_stride, t0, p.T);
    for (int u = tid; u < BK; u += NT) {
      if (t0 + u < p.T)
        cp_async<4>(kps + u, reinterpret_cast<const float*>(p.kpos) + t0 + u,
                    true);
      else
        reinterpret_cast<int*>(kps)[u] = -1;
    }
    cp_async_commit();
  };

  const int n_tiles = (p.T + BK - 1) / BK;
  for (int p0 = 0; p0 < n_tiles; p0 += PASS_TILES) {
    const int n = min(PASS_TILES, n_tiles - p0);
    // one bit a live tile of this pass: a warp takes 4 tiles at a time,
    // their kpos loads all in flight together
    for (int i = tid; i < PASS_TILES / 32; i += NT) live_bits[i] = 0u;
    __syncthreads();
    for (int j0 = warp; j0 < n; j0 += 4 * NW) {
      int kp[4][KPL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
          const int j = j0 + u * NW;
          const int tk = (p0 + j) * BK + 32 * e + lane;
          kp[u][e] = j < n && tk < p.T && 32 * e + lane < BK
                         ? __ldg(p.kpos + tk) : -1;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int kmin = INT_MAX, kmax = -1;
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
          if (kp[u][e] >= 0) kmin = min(kmin, kp[u][e]);
          kmax = max(kmax, kp[u][e]);
        }
        kmin = warp_min(kmin);
        kmax = warp_max(kmax);
        const int j = j0 + u * NW;
        if (lane == 0 && j < n && tile_live(kmin, kmax, q_lo, q_hi, p))
          atomicOr(&live_bits[j >> 5], 1u << (j & 31));
      }
    }
    __syncthreads();

    int cur = next_live(live_bits, -1, n), slot = 0;
    if (cur < n) issue(p0 + cur, 0);
    while (cur < n) {
      const int nxt = next_live(live_bits, cur, n);
      cp_async_wait<0>();
      __syncthreads();            // tile cur is in; the other slot is free
      if (nxt < n) issue(p0 + nxt, slot ^ 1);
      const float* Ks = ring + slot * C::SLOT_FL;
      const float* Vs = Ks + C::K_FL;
      const int* kps = reinterpret_cast<const int*>(Vs + C::V_FL);
      cur = nxt;
      slot ^= 1;

      // can any row of this warp see a key of the tile?  all of them?
      int kmin = INT_MAX, kmax = -1;
      bool all = true;
#pragma unroll
      for (int e = 0; e < KPL; ++e) {
        if (32 * e + lane >= BK) continue;
        const int kp = kps[32 * e + lane];
        if (kp >= 0) kmin = min(kmin, kp);
        kmax = max(kmax, kp);
        all = all && kp >= 0;
      }
      kmin = warp_min(kmin);
      kmax = warp_max(kmax);
      all = __all_sync(0xffffffffu, all);
      if (!tile_live(kmin, kmax, wlo, whi, p)) continue;  // uniform
      bool full = all;
      if (p.causal) full = full && kmax <= wlo;
      if (p.window)
        full = full && static_cast<long long>(whi) - kmin < p.window;

      // S = Q K^T: this warp's 16 rows x BK keys, 3xTF32, each stage of
      // 32 of D (and a last stage of D % 32, 16 at D = 112) summed in a
      // fresh fragment and added in fp32
      float s[NT8][4];
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
      // ldmatrix rows: Q's tiles (rows 0-7 | 8-15) x (d k.. | k+4..),
      // K's (keys nt*8.. | (nt+1)*8..) x (d k.. | k+4..)
      const int lm = lane >> 3, lr = lane & 7;
      const float* qrow = Qs + (16 * warp + lr + 8 * (lm & 1)) * LDQ
                          + 4 * (lm >> 1);
      const float* krow = Ks + (lr + 8 * (lm >> 1)) * LDQ + 4 * (lm & 1);
#pragma unroll 1
      for (int k0 = 0; k0 < 8 * C::STG * C::N_STG; k0 += 8 * C::STG)
        qk_stage<C::STG, NT8, LDQ>(s, qrow, krow, k0);
      if constexpr (C::TAIL > 0)
        qk_stage<C::TAIL, NT8, LDQ>(s, qrow, krow, 8 * C::STG * C::N_STG);

      // scale and mask; lane holds rows g (r = 0, 1) and g + 8 (r = 2,
      // 3), keys nt * 8 + 2t (r = 0, 2) and + 1 (r = 1, 3)
      const float c = p.scale_log2;
      if (full) {
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[nt][r] *= c;
      } else {
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt) {
          const int2 kk = *reinterpret_cast<const int2*>(kps + nt * 8 + 2 * t);
          s[nt][0] = visible(qp0, kk.x, p) ? s[nt][0] * c : NEG_INF;
          s[nt][1] = visible(qp0, kk.y, p) ? s[nt][1] * c : NEG_INF;
          s[nt][2] = visible(qp1, kk.x, p) ? s[nt][2] * c : NEG_INF;
          s[nt][3] = visible(qp1, kk.y, p) ? s[nt][3] * c : NEG_INF;
        }
      }

      // online softmax, base 2: row max over the quad, p in place
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - mn0);
        s[nt][1] = exp2f(s[nt][1] - mn0);
        s[nt][2] = exp2f(s[nt][2] - mn1);
        s[nt][3] = exp2f(s[nt][3] - mn1);
        ls0 += s[nt][0] + s[nt][1];
        ls1 += s[nt][2] + s[nt][3];
      }
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;

      // o = o * alpha + P V, VCH n8 tiles of Dv a pass; k8 step kk takes
      // keys kk*8 + {0, 2, 4, 6 | 1, 3, 5, 7}: P straight from s
#pragma unroll
      for (int c0 = 0; c0 < C::VT8; c0 += C::VCH) {
        float part[C::VCH][4];
#pragma unroll
        for (int nt = 0; nt < C::VCH; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[nt][r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NT8; ++kk) {
          unsigned ab[4], as[4];
          split_tf32(s[kk][0], ab[0], as[0]);   // (g, key 2t)
          split_tf32(s[kk][2], ab[1], as[1]);   // (g+8, key 2t)
          split_tf32(s[kk][1], ab[2], as[2]);   // (g, key 2t+1)
          split_tf32(s[kk][3], ab[3], as[3]);   // (g+8, key 2t+1)
          unsigned bb[C::VCH][2], bs[C::VCH][2];
          const float* vrow = Vs + (kk * 8 + 2 * t) * LDV + c0 * 8 + g;
#pragma unroll
          for (int nt = 0; nt < C::VCH; ++nt) {             // V[key][col]
            split_tf32(vrow[nt * 8], bb[nt][0], bs[nt][0]);
            split_tf32(vrow[nt * 8 + LDV], bb[nt][1], bs[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < C::VCH; ++nt) mma(part[nt], as, bb[nt]);
#pragma unroll
          for (int nt = 0; nt < C::VCH; ++nt) mma(part[nt], ab, bs[nt]);
#pragma unroll
          for (int nt = 0; nt < C::VCH; ++nt) mma(part[nt], ab, bb[nt]);
        }
#pragma unroll
        for (int nt = 0; nt < C::VCH; ++nt) {
          o[c0 + nt][0] = o[c0 + nt][0] * al0 + part[nt][0];
          o[c0 + nt][1] = o[c0 + nt][1] * al0 + part[nt][1];
          o[c0 + nt][2] = o[c0 + nt][2] * al1 + part[nt][2];
          o[c0 + nt][3] = o[c0 + nt][3] * al1 + part[nt][3];
        }
      }
    }
    __syncthreads();              // the bits and the ring are free again
  }
  cp_async_wait<0>();             // Q, when no tile was live

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  const long long ostride = static_cast<long long>(p.Hq) * DV;
  float* ob = p.o + (static_cast<long long>(b) * p.S * p.Hq + h) * DV + 2 * t;
  if (row0 < p.S) {
#pragma unroll
    for (int nt = 0; nt < C::VT8; ++nt)
      *reinterpret_cast<float2*>(ob + row0 * ostride + nt * 8) =
          make_float2(o[nt][0] * i0, o[nt][1] * i0);
  }
  if (row1 < p.S) {
#pragma unroll
    for (int nt = 0; nt < C::VT8; ++nt)
      *reinterpret_cast<float2*>(ob + row1 * ostride + nt * 8) =
          make_float2(o[nt][2] * i1, o[nt][3] * i1);
  }
}

// more than 48 KB of dynamic shared memory is allowed once per kernel and
// device (hopper.cuh allow_smem), not at every launch
template <int D, int DV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<D, DV>;
  cudaError_t e = allow_smem<flash_prefill_kernel<D, DV>>(C::BYTES);
  if (e != cudaSuccess) return e;
  Params q = p;
  q.n_qt = (p.S + C::BQ - 1) / C::BQ;
  const long long blocks = static_cast<long long>(q.n_qt) * p.B * p.Hq;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_prefill_kernel<D, DV><<<static_cast<unsigned>(blocks), C::NT,
                                C::BYTES, stream>>>(q);
  return cudaGetLastError();
}

}  // namespace

// q [B, S, Hq, D], k [B, T, Hkv, D], v [B, T, Hkv, Dv], qpos [S], kpos
// [T] int32, out [B, S, Hq, Dv]; all f32, contiguous, 16-byte aligned
// (checked by the caller, with Hkv | Hq, T > 0 and (D, Dv) one of the
// instantiations below).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, const int* qpos,
                                   const int* kpos, float* out, int B, int S,
                                   int T, int Hq, int Hkv, int D, int Dv,
                                   int causal, int window, float scale,
                                   void* stream) {
  if (B == 0 || S == 0) return 0;
  if (T <= 0 || Hkv <= 0 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, qpos, kpos, out, B, S, T, Hq, Hkv, Hq / Hkv,
           causal, window, 0, scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D == 16 && Dv == 16) e = launch<16, 16>(p, st);
  else if (D == 32 && Dv == 32) e = launch<32, 32>(p, st);
  else if (D == 64 && Dv == 64) e = launch<64, 64>(p, st);
  else if (D == 112 && Dv == 112) e = launch<112, 112>(p, st);  // zamba2
  else if (D == 128 && Dv == 128) e = launch<128, 128>(p, st);
  else if (D == 192 && Dv == 128) e = launch<192, 128>(p, st);  // MLA
  else if (D == 224 && Dv == 224) e = launch<224, 224>(p, st);  // Zamba2
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
