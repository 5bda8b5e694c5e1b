// Mamba-2 SSD (state-space duality) chunked scan, fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd :74,
// pallas_call at :94).  There the grid is (batch, heads, chunks) with
// the chunk axis sequential on one core and the [P, N] state carried in
// VMEM scratch from one grid step to the next.  What it computes is
// repro_torch/kernels/ref.py ssd_chunked:
//
//   per chunk c of Lc steps (rows i, j), with g = h / (H / G):
//   seg_i   = sum_{r <= i} dt_r * A                    (<= 0)
//   W[i,j]  = (C_i . B_j) * exp(seg_i - seg_j) * dt_j   for j <= i, else 0
//   s_c     = sum_j (exp(total - seg_j) dt_j B_j)^T x_j  (the chunk's own
//             end state; total = seg of the chunk's last step)
//   h_c     = exp(total_c) h_{c-1} + s_c                 (h_{-1} = h0)
//   y_i     = (W x)_i + exp(seg_i) * (C h_{c-1}^T)_i + D * x_i
//
// exp(seg_i - seg_j) is taken of the difference and only for j <= i:
// exp(seg_i) * exp(-seg_j) overflows over a 128-step chunk (seg reaches
// -100 and below) and gives inf * 0.
//
// The TPU's chain of chunks is broken so that the card fills: only the
// recurrence h_c needs the chunks in order, and it is elementwise.  One
// call is four launches (and counts as one launch of ssd):
//   1. state: one block per (chunk, head, batch) computes s_c into the
//      scratch st [B, H, n_chunks, P, N] and total_c into tot;
//   2. cb: one block per (chunk, group, batch) computes C B^T over its
//      causal half into the scratch cb; it does not depend on the head,
//      so the H / G heads of a group share it (at the served shape 64
//      blocks form what 5120 would otherwise each form again);
//   3. pass: one thread per 4 elements of a (batch, head)'s [P, N] state
//      walks the chunks in order, replacing s_c by the state entering
//      chunk c, h_{c-1}, and writing hT: the reference's recurrence in
//      its own order, h * exp(total) + s rounded as two operations;
//   4. output: one block per (chunk, head, batch) scales its chunk's
//      C B^T into W in place (exp of the difference, only where j <= i)
//      and computes y from x, C, W and h_{c-1}.
// At the served mamba2-2.7b shape (B = 4, S = 2048, H = 80, P = 64,
// N = 128, chunk 128) launches 1 and 4 have 5120 blocks each (the first
// version had 320, one per (batch, head), in 2.4 waves on 132 SMs), and
// the scratch is 172 MB.
//
// Inside a block the four products (x^T (wgt B) in launch 1, C B^T in
// launch 2, C h^T and W x in launch 4), each 128 deep, run on the tensor
// cores as 3xTF32 mma.sync.m16n8k8 (hopper.cuh): fp32 FMAs top out at
// 67 TFLOP/s and the first version, scalar FMAs fed by scalar
// shared-memory loads, reached ~12; 3xTF32 does three TF32 products for
// each fp32 one, 3 x 37.7 GFLOP at 495 TFLOP/s, 0.23 ms, below the 0.56
// ms the fp32 rate would allow.  As in moe_gmm.cu, each product's mma's
// sum into a fresh accumulator for 32 of k and that partial sum is
// added, rounded to nearest, into an fp32 sum (the tensor cores truncate
// as they add).  The causal products split their work evenly: 8 warps
// as 4 pairs, pair s owns the 16-row strips s and 7 - s (the two
// together hold 9 of the 16 x 16 tiles with j <= i); in launch 4 the
// pair's two warps split the P columns of C h^T and W x.  Launch 4
// keeps two regions of shared memory, each used twice (C, then C B^T and
// W; h, then x): 105 KB, so two blocks share an SM and one block's
// cp.async loads run while the other computes (with all four tiles
// resident, 207 KB, one block fits an SM and its loads are waited on
// alone).  The cumsum of dt * A (in step order: see chunk_scan) runs
// while C and h are in flight.
//
// Shared-memory rows are padded so that every fragment load of a warp
// hits 32 distinct banks: rows read as (row g, column t) sit 132 floats
// apart (4g + t), rows read as (row t, column g) 72 or 136 apart (8t +
// g).  Tiles are the maximal ones (128 steps, P = 64, N = 128), zero
// beyond the shape, so smaller shapes compute on zeros.
//
// Numerics: fixed summation order, no atomics, no split over blocks of
// any sum: a result is bitwise repeatable at a fixed shape.
//
// What bounds it on the card: at the served shape the operations, ~7.36
// MFLOP per (b, h, chunk) with C B^T and W x over their causal half
// (37.7 GFLOP, 0.56 ms at the 67 TFLOP/s fp32 rate; 0.23 ms as 3xTF32),
// against ~0.37 GB of x, y, B, C, dt and the state (0.11 ms at 3.35
// TB/s); the scratch adds 4 x 168 MB of traffic (launch 1 writes the
// states, launch 3 reads and writes them, launch 4 reads them; ~0.2 ms).
#include <cuda_runtime.h>

#include <atomic>

namespace {

#include "hopper.cuh"

constexpr int NT = 256;
constexpr int MAXC = 128, MAXP = 64, MAXN = 128;
constexpr int LDX = MAXP + 8;    // x rows: read as (t, g)
constexpr int LDS = MAXN + 8;    // B rows in launch 1: read as (t, g)
constexpr int LDC = MAXN + 4;    // C, B, W and h rows in launches 2, 4: (g, t)
constexpr int STAGE_K = 32;      // k of one promoted partial sum

struct SsdParams {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* D;
  const float* h0;     // null: zeros
  float* y;
  float* hT;
  float* st;           // [B, H, nc, P, N]: s_c, then h_{c-1}
  float* tot;          // [B, H, nc]: total_c
  float* cb;           // [B, nc, G, MAXC, MAXC]: C B^T, causal tiles
  int S, H, P, G, N, Lc, nc;
  int vec;             // rows of x, B, C and the state 16-byte aligned
};

constexpr int state_smem_floats() { return MAXC * (LDX + LDS) + 3 * MAXC; }
constexpr int cb_smem_floats() { return 2 * MAXC * LDC; }
// launch 4's second region: h [MAXP][LDC], then x [MAXC][LDX]
constexpr int REGION_HX = MAXP * LDC > MAXC * LDX ? MAXP * LDC : MAXC * LDX;
constexpr int output_smem_floats() {
  return MAXC * LDC + REGION_HX + 2 * MAXC;
}

// Rows [0, ROWS) of a tile at stride ld from `src` (row r at src + r *
// rstride, `width` floats of it): rows >= n_rows and columns >= width
// read as zeros.  vec: width, rstride and src are multiples of 4 floats.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src,
                                          long long rstride, int width,
                                          int n_rows, bool vec) {
  if (vec) {
    constexpr int C4 = COLS / 4;
    for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
      const int r = i / C4, c = (i - r * C4) * 4;
      const bool ok = r < n_rows && c < width;
      cp_async<16>(dst + r * ld + c, ok ? src + r * rstride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i - r * COLS;
      const bool ok = r < n_rows && c < width;
      cp_async<4>(dst + r * ld + c, ok ? src + r * rstride + c : src, ok);
    }
  }
}

// seg and dt of the chunk's MAXC rows (rows >= n_rows: dt = 0, so seg
// stays at its last value), by warp 0: the lanes load dt, then lane 0
// sums dt * A in step order, as the reference's cumsum does.  A warp
// scan (a tree of adds) missed 1e-4 on the card at the served shape:
// seg reaches -1400 within a chunk, where one rounding is ~6e-5, and in
// step order the roundings made before step j cancel in seg_i - seg_j,
// which a tree's do not.  The 128 dependent adds run while the block's
// copies are in flight.
__device__ __forceinline__ void chunk_scan(const SsdParams& p, int b, int h,
                                           int s0, int n_rows, float* seg,
                                           float* dts) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const float* src = p.dt + (static_cast<long long>(b) * p.S + s0) * p.H + h;
#pragma unroll
  for (int u = 0; u < MAXC / 32; ++u) {
    const int r = 32 * u + lane;
    dts[r] = r < n_rows ? src[static_cast<long long>(r) * p.H] : 0.0f;
  }
  __syncwarp();
  if (lane == 0) {
    const float A = p.A[h];
    float run = 0.0f;
#pragma unroll 8
    for (int r = 0; r < MAXC; ++r) {
      run = __fadd_rn(run, __fmul_rn(dts[r], A));
      seg[r] = run;
    }
  }
}

// ---- launch 1: s_c = (wgt * B)^T x over the chunk, into st; total_c
__global__ void __launch_bounds__(NT) ssd_state_kernel(SsdParams p) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                        // [MAXC][LDX]  x
  float* bs = xs + MAXC * LDX;           // [MAXC][LDS]  B, then wgt * B
  float* seg = bs + MAXC * LDS;          // [MAXC]
  float* dts = seg + MAXC;               // [MAXC]
  float* wgt = dts + MAXC;               // [MAXC] exp(total - seg) * dt
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * p.Lc, rows = min(p.Lc, p.S - s0);
  const int grp = h / (p.H / p.G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_rows<MAXC, MAXP>(
      xs, LDX,
      p.x + (static_cast<long long>(b) * p.S + s0) * p.H * p.P
          + static_cast<long long>(h) * p.P,
      static_cast<long long>(p.H) * p.P, p.P, rows, p.vec);
  load_rows<MAXC, MAXN>(
      bs, LDS,
      p.Bm + (static_cast<long long>(b) * p.S + s0) * p.G * p.N
          + static_cast<long long>(grp) * p.N,
      static_cast<long long>(p.G) * p.N, p.N, rows, p.vec);
  cp_async_commit();
  chunk_scan(p, b, h, s0, rows, seg, dts);
  __syncthreads();
  const float total = seg[MAXC - 1];
  if (threadIdx.x < MAXC)
    wgt[threadIdx.x] = __fmul_rn(expf(__fsub_rn(total, seg[threadIdx.x])),
                                 dts[threadIdx.x]);
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < MAXC * MAXN; i += NT) {
    const int r = i / MAXN, n = i - r * MAXN;
    bs[r * LDS + n] = __fmul_rn(bs[r * LDS + n], wgt[r]);
  }
  __syncthreads();

  // warp: rows p0.. (16 of P) x columns n0.. (64 of N); k = the steps j
  const int p0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);
  float acc[8][4], part[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
  for (int k0 = 0; k0 < MAXC; k0 += STAGE_K) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[nt][r] = 0.0f;
#pragma unroll
    for (int kk = k0; kk < k0 + STAGE_K; kk += 8) {
      Frag8A a;                          // x^T: (p, j) = xs[j][p]
      const float* ap = xs + (kk + t) * LDX + p0 + g;
      a.set(ap[0], ap[8], ap[4 * LDX], ap[4 * LDX + 8]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        Frag8B bf;                       // (j, n) = bs[j][n]
        const float* bp = bs + (kk + t) * LDS + n0 + nt * 8 + g;
        bf.set(bp[0], bp[4 * LDS]);
        mma3(part[nt], a, bf);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] += part[nt][r];
  }

  const long long bhc = (static_cast<long long>(b) * p.H + h) * p.nc + c;
  float* dst = p.st + bhc * p.P * p.N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pr = p0 + g + 8 * hh, col = n0 + nt * 8 + 2 * t;
      if (pr >= p.P) continue;
      float* o = dst + static_cast<long long>(pr) * p.N + col;
      if (p.vec && col + 1 < p.N) {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
      } else {
        if (col < p.N) o[0] = acc[nt][2 * hh];
        if (col + 1 < p.N) o[1] = acc[nt][2 * hh + 1];
      }
    }
  if (threadIdx.x == 0) p.tot[bhc] = total;
}

// ---- launch 2: C B^T of each (chunk, group), over its causal half
// (the 16 x 16 tiles with j <= i), into the scratch cb [B, nc, G, MAXC,
// MAXC]: it does not depend on the head, so it is formed once for the
// H / G heads of a group.  8 warps as 4 pairs: pair s owns the 16-row
// strips s and 7 - s, 9 of the 16 x 16 tiles with j <= i, and its two
// warps take 9 of their 18 column tiles of 8 each.
__global__ void __launch_bounds__(NT, 1) ssd_cb_kernel(SsdParams p) {
  extern __shared__ __align__(16) float sm[];
  float* cs = sm;                        // [MAXC][LDC]  C
  float* bs = cs + MAXC * LDC;           // [MAXC][LDC]  B
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int s0 = c * p.Lc, rows = min(p.Lc, p.S - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long brow = static_cast<long long>(p.G) * p.N;
  const long long boff = (static_cast<long long>(b) * p.S + s0) * brow
                         + static_cast<long long>(grp) * p.N;
  load_rows<MAXC, MAXN>(cs, LDC, p.Cm + boff, brow, p.N, rows, p.vec);
  load_rows<MAXC, MAXN>(bs, LDC, p.Bm + boff, brow, p.N, rows, p.vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int s = warp & 3, half = warp >> 2, n_first = 2 * (s + 1);
  float cb[9][4], part[9][4];
#pragma unroll
  for (int q = 0; q < 9; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) cb[q][r] = 0.0f;
  for (int k0 = 0; k0 < MAXN; k0 += STAGE_K) {
#pragma unroll
    for (int q = 0; q < 9; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[q][r] = 0.0f;
#pragma unroll
    for (int kk = k0; kk < k0 + STAGE_K; kk += 8) {
      Frag8A a[2];                       // (i, n) = C[i][n]
#pragma unroll
      for (int si = 0; si < 2; ++si) {
        const float* ap = cs + (16 * (si ? 7 - s : s) + g) * LDC + kk + t;
        a[si].set(ap[0], ap[8 * LDC], ap[4], ap[8 * LDC + 4]);
      }
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const int it = 9 * half + q;
        const int si = it < n_first ? 0 : 1;
        const int jt = si ? it - n_first : it;
        Frag8B bf;                       // (n, j) = B[j][n]
        const float* bp = bs + (jt * 8 + g) * LDC + kk + t;
        bf.set(bp[0], bp[4]);
        Frag8A af;                       // the item's strip, selected
#pragma unroll                           // register by register
        for (int r = 0; r < 4; ++r) {
          af.big[r] = si ? a[1].big[r] : a[0].big[r];
          af.small[r] = si ? a[1].small[r] : a[0].small[r];
        }
        mma3(part[q], af, bf);
      }
    }
#pragma unroll
    for (int q = 0; q < 9; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) cb[q][r] += part[q][r];
  }
  float* dst = p.cb + ((static_cast<long long>(b) * p.nc + c) * p.G + grp)
                      * MAXC * MAXC;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int it = 9 * half + q;
    const int si = it < n_first ? 0 : 1;
    const int jt = si ? it - n_first : it;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 16 * (si ? 7 - s : s) + g + 8 * hh;
      *reinterpret_cast<float2*>(dst + i * MAXC + jt * 8 + 2 * t) =
          make_float2(cb[q][2 * hh], cb[q][2 * hh + 1]);
    }
  }
}

// ---- launch 3: the state entering each chunk, in chunk order; hT.  A
// thread's loads of PASS_BATCH chunks are issued before its stores.
constexpr int PASS_BATCH = 8;

template <int VEC>
__global__ void __launch_bounds__(NT) ssd_pass_kernel(SsdParams p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int pn = p.P * p.N;
  const int e = (blockIdx.x * NT + threadIdx.x) * VEC;
  if (e >= pn) return;
  const long long bh = static_cast<long long>(b) * p.H + h;
  float* st = p.st + bh * p.nc * pn + e;
  const float* tot = p.tot + bh * p.nc;
  float hv[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u)
    hv[u] = p.h0 != nullptr ? p.h0[bh * pn + e + u] : 0.0f;
  for (int c0 = 0; c0 < p.nc; c0 += PASS_BATCH) {
    float s[PASS_BATCH][VEC];
#pragma unroll
    for (int q = 0; q < PASS_BATCH; ++q) {
      if (c0 + q >= p.nc) break;
      const float* sc = st + static_cast<long long>(c0 + q) * pn;
      if constexpr (VEC == 4) {
        const float4 v = *reinterpret_cast<const float4*>(sc);
        s[q][0] = v.x; s[q][1] = v.y; s[q][2] = v.z; s[q][3] = v.w;
      } else {
        s[q][0] = sc[0];
      }
    }
#pragma unroll
    for (int q = 0; q < PASS_BATCH; ++q) {
      if (c0 + q >= p.nc) break;
      float* sc = st + static_cast<long long>(c0 + q) * pn;
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(sc) = make_float4(hv[0], hv[1], hv[2],
                                                     hv[3]);
      else
        sc[0] = hv[0];
      const float decay = expf(tot[c0 + q]);
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        hv[u] = __fadd_rn(__fmul_rn(hv[u], decay), s[q][u]);
    }
  }
#pragma unroll
  for (int u = 0; u < VEC; ++u) p.hT[bh * pn + e + u] = hv[u];
}

// ---- launch 4: y = W x + exp(seg) C h_{c-1}^T + D x over the chunk
__global__ void __launch_bounds__(NT, 2) ssd_output_kernel(SsdParams p) {
  // two regions, each used twice, so that two blocks fit on an SM (one
  // loads while the other computes): C, then C B^T and W; h, then x
  extern __shared__ __align__(16) float sm[];
  float* cs = sm;                        // [MAXC][LDC]  C
  float* ws = sm;                        // [MAXC][LDC]  C B^T, then W
  float* hs = sm + MAXC * LDC;           // [MAXP][LDC]  h_{c-1}
  float* xs = hs;                        // [MAXC][LDX]  x
  float* seg = hs + REGION_HX;           // [MAXC]
  float* dts = seg + MAXC;               // [MAXC]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * p.Lc, rows = min(p.Lc, p.S - s0);
  const int grp = h / (p.H / p.G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long brow = static_cast<long long>(p.G) * p.N;
  const long long boff = (static_cast<long long>(b) * p.S + s0) * brow
                         + static_cast<long long>(grp) * p.N;
  const long long xrow = static_cast<long long>(p.H) * p.P;
  const long long xoff = (static_cast<long long>(b) * p.S + s0) * xrow
                         + static_cast<long long>(h) * p.P;
  const long long bhc = (static_cast<long long>(b) * p.H + h) * p.nc + c;

  load_rows<MAXC, MAXN>(cs, LDC, p.Cm + boff, brow, p.N, rows, p.vec);
  load_rows<MAXP, MAXN>(hs, LDC, p.st + bhc * p.P * p.N, p.N, p.N, p.P,
                        p.vec);
  cp_async_commit();
  chunk_scan(p, b, h, s0, rows, seg, dts);

  // warp pair s = warp % 4 owns the row strips s and 7 - s; its two
  // warps split the P columns (pc0..pc0 + 31) of C h^T and W x
  const int s = warp & 3, half = warp >> 2, pc0 = 32 * half;
  const int strip[2] = {s, 7 - s};

  // ---- C h^T for both strips
  cp_async_wait<0>();
  __syncthreads();
  float yo[2][4][4], part[2][4][4];
#pragma unroll
  for (int si = 0; si < 2; ++si)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) yo[si][nt][r] = 0.0f;
  for (int k0 = 0; k0 < MAXN; k0 += STAGE_K) {
#pragma unroll
    for (int si = 0; si < 2; ++si)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[si][nt][r] = 0.0f;
#pragma unroll
    for (int kk = k0; kk < k0 + STAGE_K; kk += 8) {
      Frag8A a[2];                       // (i, n) = cs[i][n]
#pragma unroll
      for (int si = 0; si < 2; ++si) {
        const float* ap = cs + (16 * strip[si] + g) * LDC + kk + t;
        a[si].set(ap[0], ap[8 * LDC], ap[4], ap[8 * LDC + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        Frag8B bf;                       // (n, q) = hs[q][n]
        const float* bp = hs + (pc0 + nt * 8 + g) * LDC + kk + t;
        bf.set(bp[0], bp[4]);
#pragma unroll
        for (int si = 0; si < 2; ++si) mma3(part[si][nt], a[si], bf);
      }
    }
#pragma unroll
    for (int si = 0; si < 2; ++si)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) yo[si][nt][r] += part[si][nt][r];
  }

  // ---- C B^T over C and x over h, then W = C B^T * exp(seg_i - seg_j)
  // * dt_j where j <= i, else 0, in place, on the tiles W x reads (j
  // below the end of i's 16-row strip)
  __syncthreads();                       // every read of C and h is done
  load_rows<MAXC, MAXC>(
      ws, LDC,
      p.cb + ((static_cast<long long>(b) * p.nc + c) * p.G + grp) * MAXC
                 * MAXC,
      MAXC, MAXC, MAXC, true);
  load_rows<MAXC, MAXP>(xs, LDX, p.x + xoff, xrow, p.P, rows, p.vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < MAXC * MAXC; e += NT) {
    const int i = e / MAXC, j = e - i * MAXC;
    if (j >= (i | 15) + 1) continue;
    float* w = ws + i * LDC + j;
    *w = j <= i ? __fmul_rn(__fmul_rn(*w, expf(__fsub_rn(seg[i], seg[j]))),
                            dts[j])
                : 0.0f;
  }
  __syncthreads();                       // W written

  // ---- W x over j < the strip's end, then the output
  float yd[4][4];
#pragma unroll
  for (int si = 0; si < 2; ++si) {
    const int i0 = 16 * strip[si], nk = i0 + 16;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) yd[nt][r] = 0.0f;
    for (int k0 = 0; k0 < nk; k0 += STAGE_K) {
      float pw[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) pw[nt][r] = 0.0f;
      const int kend = min(k0 + STAGE_K, nk);
      for (int kk = k0; kk < kend; kk += 8) {
        Frag8A a;                        // (i, j) = W[i][j]
        const float* ap = ws + (i0 + g) * LDC + kk + t;
        a.set(ap[0], ap[8 * LDC], ap[4], ap[8 * LDC + 4]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          Frag8B bf;                     // (j, q) = xs[j][q]
          const float* bp = xs + (kk + t) * LDX + pc0 + nt * 8 + g;
          bf.set(bp[0], bp[4 * LDX]);
          mma3(pw[nt], a, bf);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) yd[nt][r] += pw[nt][r];
    }
    const float Dh = p.D[h];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + g + 8 * hh;
      if (i >= rows) continue;
      const float es = expf(seg[i]);
      float* yrow = p.y + xoff + i * xrow;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int q = pc0 + nt * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qe = min(q + e, MAXP - 1);
          v[e] = __fadd_rn(__fadd_rn(yd[nt][2 * hh + e],
                                     __fmul_rn(yo[si][nt][2 * hh + e], es)),
                           __fmul_rn(xs[i * LDX + qe], Dh));
        }
        if (p.vec && q + 1 < p.P) {
          *reinterpret_cast<float2*>(yrow + q) = make_float2(v[0], v[1]);
        } else {
          if (q < p.P) yrow[q] = v[0];
          if (q + 1 < p.P) yrow[q + 1] = v[1];
        }
      }
    }
  }
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], A and D [H], Bm and Cm [B, S, G, N],
// h0 [B, H, P, N] or null, y [B, S, H, P], hT [B, H, P, N]; scratch of
// B * nc * (G * 128 * 128 + H * (P * N + 1)) floats, 16-byte aligned,
// with nc = ceil(S / chunk); all f32, contiguous.  The caller checks
// G | H, 0 < chunk <= 128, 0 < P <= 64, 0 < N <= 128.  Launches the
// four kernels on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int ssd_f32(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* D,
                       const float* h0, float* y, float* hT, float* scratch,
                       int batch, int S, int H, int P, int G, int N,
                       int chunk, void* stream) {
  const auto aligned = [](const void* q) {
    return reinterpret_cast<unsigned long long>(q) % 16 == 0;
  };
  if (batch == 0 || H == 0) return 0;
  if (chunk <= 0 || chunk > MAXC || P <= 0 || P > MAXP || N <= 0 ||
      N > MAXN || G <= 0 || H % G || !aligned(scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = S > 0 ? (S + chunk - 1) / chunk : 0;
  const long long n_cb = static_cast<long long>(batch) * nc * G * MAXC * MAXC;
  const long long n_st = static_cast<long long>(batch) * H * nc * P * N;
  const int vec = P % 4 == 0 && N % 4 == 0 && aligned(x) && aligned(Bm) &&
                  aligned(Cm) && aligned(y);
  SsdParams p{x, dt, A, Bm, Cm, D, h0, y, hT, scratch + n_cb,
              scratch + n_cb + n_st, scratch, S, H, P, G, N, chunk, nc, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int state_bytes = state_smem_floats() * 4;
  constexpr int cb_bytes = cb_smem_floats() * 4;
  constexpr int output_bytes = output_smem_floats() * 4;
  cudaError_t e = allow_smem<ssd_state_kernel>(state_bytes);
  if (e == cudaSuccess) e = allow_smem<ssd_cb_kernel>(cb_bytes);
  if (e == cudaSuccess) e = allow_smem<ssd_output_kernel>(output_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nc > 0) {
    ssd_state_kernel<<<dim3(nc, H, batch), NT, state_bytes, st>>>(p);
    ssd_cb_kernel<<<dim3(nc, G, batch), NT, cb_bytes, st>>>(p);
  }
  const int pn = P * N;
  if (pn % 4 == 0 && aligned(hT) && (h0 == nullptr || aligned(h0)))
    ssd_pass_kernel<4><<<dim3((pn / 4 + NT - 1) / NT, H, batch), NT, 0,
                         st>>>(p);
  else
    ssd_pass_kernel<1><<<dim3((pn + NT - 1) / NT, H, batch), NT, 0, st>>>(
        p);
  if (nc > 0)
    ssd_output_kernel<<<dim3(nc, H, batch), NT, output_bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
