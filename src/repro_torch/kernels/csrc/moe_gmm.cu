// Grouped expert SwiGLU ("MoE grouped matmul"), fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py (moe_gmm :48,
// pallas_call at :69).  There the grid is (experts, token blocks,
// f blocks) with the f axis sequential on one core: each f tile's gate
// and up products are activated and contracted at once into a [C, d]
// accumulator in VMEM, so the [C, f] activations never reach HBM.  What
// it computes is repro_torch/kernels/ref.py moe_gmm:
//
//   H[e, c, :] = silu(x[e, c, :] Wg[e]) * (x[e, c, :] Wu[e])    [E, C, f]
//   y[e, c, :] = H[e, c, :] Wd[e]                               [E, C, d]
//
// Two launches per path: H with the SwiGLU in the epilogue, then y.
// Keeping H on chip, as the TPU kernel does, would save little here: its
// round trip through device memory is E * C * f floats, 0.53 GB at
// phi3.5-moe's prefill (~0.3 ms of a ~45 ms call) and 5 MB at decode,
// while a fused block would need a [BM, d] accumulator (d = 4096 does
// not fit beside the operand tiles) or a split over f with a
// cross-block reduction (atomics, or a third pass).
//
// The wrapper picks the path from C (a shape, known on the host: no
// sync).  Neither path uses atomics or splits a sum over blocks: every
// output is summed over k in a fixed order, so a result is bitwise
// repeatable at a fixed shape.
//
// Prefill (C > 64; phi3.5-moe 1296, deepseek-v2-lite 976): bounded by
// operations, 6 E C d f (3.26 TFLOP a phi layer).  fp32 FMAs on the CUDA
// cores top out at 67 TFLOP/s (the first version reached ~31), and plain
// TF32 would cost three decimal digits against the port's 1e-4.  So the
// products run as 3xTF32 on the tensor cores: each operand is split into
// big = tf32(a) (rounded to nearest, ties away, as cvt.rna.tf32.f32)
// and small = a - big, and small*big + big*small + big*big is
// accumulated in fp32 by mma.sync.m16n8k8 (a_small*b_small, ~2^-22
// relative, is dropped; see split_tf32), which keeps fp32-level accuracy
// (~1e-6 relative) at up to 495 / 3 TFLOP/s.
// The tensor cores add into their accumulator with truncation, so a sum
// kept there over all of K drifts by ~2^-24 of itself an add (measured:
// 3.6e-4 on outputs of ~3 at phi's K = 4096 and 6400, beyond 1e-4); each
// stage's 12 mma's therefore sum into a fresh accumulator that is then
// added, rounded to nearest, into the fp32 sum on the CUDA cores.
// Block tiles are 128 x 64 for the gate/up pair (two accumulators) and
// 128 x 128 for the down projection, 8 warps, BK = 32, fed by a 4-stage
// ring of 16-byte cp.async copies in dynamic shared memory (4-byte
// copies when d or f is not a multiple of 4); rows and columns past an
// edge read zeros and are not stored.  The row tile is the grid's
// fastest axis, so the blocks that share a weight slab run together and
// the slab is read from device memory about once.  Next step: wgmma,
// which for 32-bit operands needs both tiles K-major in shared memory;
// the weights are [E, d, f] with f contiguous (N-major for x Wg), so
// they would be transposed on the way in.
//
// Decode (C <= 64; phi 16, deepseek 24 at B = 4): bounded by the bytes of
// the expert weights, and a step routes B * top_k choices, so most
// experts hold no token (deepseek: at most 24 of 64).  A pre-pass finds
// each expert's rows that hold a nonzero value and compacts their
// indices; an expert without one reads no weight and writes zeros (its
// rows are zeros, and silu(0) * 0 = 0).  Each block streams one [K, 128]
// column slab of one expert's weights through a 4-stage ring of 16-byte
// cp.async copies and multiplies it, in fp32 FMAs, into the occupied
// rows only (a thread owns two columns and every fourth row; the rows'
// values arrive four k at a time in one 16-byte shared-memory load, and
// a warp whose rows are all empty skips the products).  One call is
// three launches and counts as one.
#include <cuda_runtime.h>

#include <atomic>

namespace {

#include "hopper.cuh"

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.0f + expf(-g)) * u;
}

// --------------------------------------------------- prefill: 3xTF32 mma
namespace tc {

constexpr int NT = 256, BM = 128, BK = 32, STAGES = 4, LDA = BK + 4;

template <bool SWIGLU> struct Cfg {
  static constexpr int BN = SWIGLU ? 64 : 128;
  static constexpr int NB = SWIGLU ? 2 : 1;        // right-hand operands
  static constexpr int WM = SWIGLU ? 4 : 2;        // warps along m
  static constexpr int WN = 8 / WM;                // warps along n
  static constexpr int TM = BM / WM, TN = BN / WN; // a warp's tile
  static constexpr int MT = TM / 16, NT8 = TN / 8; // mma tiles a warp
  static constexpr int LDB = BN + 8;               // conflict-free rows
  static constexpr int A_FL = BM * LDA, B_FL = BK * LDB;
  static constexpr int STAGE_FL = A_FL + NB * B_FL;
  static constexpr int SMEM = STAGES * STAGE_FL * 4;
};

// out[e] (M x N) = A[e] (M x K) @ B1[e] (K x N), or with SWIGLU
// silu(A[e] @ B1[e]) * (A[e] @ B2[e]); all row-major.  VEC = 4 needs
// K % 4 == 0 and N % 4 == 0.
template <bool SWIGLU, int VEC>
__global__ void __launch_bounds__(NT, 1) gmm_kernel_tc(
    const float* __restrict__ A, const float* __restrict__ B1,
    const float* __restrict__ B2, float* __restrict__ out, int M, int K,
    int N) {
  using G = Cfg<SWIGLU>;
  extern __shared__ __align__(16) float sm[];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * G::BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % G::WM, wn = warp / G::WM;
  const float* Ae = A + static_cast<long long>(e) * M * K;
  const float* Be[G::NB];
  Be[0] = B1 + static_cast<long long>(e) * K * N;
  if (SWIGLU) Be[G::NB - 1] = B2 + static_cast<long long>(e) * K * N;

  // what each thread copies, worked out once: with 16-byte copies its
  // A chunks share one k offset (kc) and its B chunks one column (nc),
  // so a stage only adds k0
  constexpr int AL = BM * BK / 4 / NT;             // A chunks a thread
  constexpr int BL = BK * G::BN / 4 / NT;          // B chunks a thread
  constexpr int BKR = NT / (G::BN / 4);            // k rows between them
  const int kc = (tid % (BK / 4)) * 4, ar0 = tid / (BK / 4);
  const int nc = (tid % (G::BN / 4)) * 4, kr0 = tid / (G::BN / 4);
  const float* a_src[AL];
  bool a_ok[AL];
#pragma unroll
  for (int l = 0; l < AL; ++l) {
    const int row = m0 + ar0 + l * (NT / (BK / 4));
    a_ok[l] = row < M;
    a_src[l] = Ae + (a_ok[l] ? static_cast<long long>(row) * K + kc : 0);
  }
  const bool b_ok = n0 + nc < N;
  const long long b_off = static_cast<long long>(kr0) * N + n0 + nc;

  auto load_stage = [&](int s, int k0) {
    float* As = sm + s * G::STAGE_FL;
    if (VEC == 4) {
#pragma unroll
      for (int l = 0; l < AL; ++l) {
        const bool ok = a_ok[l] && k0 + kc < K;
        cp_async<16>(As + (ar0 + l * (NT / (BK / 4))) * LDA + kc,
                     ok ? a_src[l] + k0 : Ae, ok);
      }
#pragma unroll
      for (int nb = 0; nb < G::NB; ++nb) {
        float* Bs = As + G::A_FL + nb * G::B_FL;
#pragma unroll
        for (int l = 0; l < BL; ++l) {
          const int kr = kr0 + l * BKR;
          const bool ok = b_ok && k0 + kr < K;
          cp_async<16>(Bs + kr * G::LDB + nc,
                       ok ? Be[nb] + b_off
                                + static_cast<long long>(k0 + l * BKR) * N
                          : Be[nb], ok);
        }
      }
      return;
    }
    for (int i = tid; i < BM * BK; i += NT) {
      const int row = i / BK, kk = i % BK;
      const bool ok = m0 + row < M && k0 + kk < K;
      cp_async<4>(As + row * LDA + kk,
                  ok ? Ae + static_cast<long long>(m0 + row) * K + k0 + kk
                     : Ae, ok);
    }
#pragma unroll
    for (int nb = 0; nb < G::NB; ++nb) {
      float* Bs = As + G::A_FL + nb * G::B_FL;
      for (int i = tid; i < BK * G::BN; i += NT) {
        const int kr = i / G::BN, nn = i % G::BN;
        const bool ok = k0 + kr < K && n0 + nn < N;
        cp_async<4>(Bs + kr * G::LDB + nn,
                    ok ? Be[nb] + static_cast<long long>(k0 + kr) * N
                             + n0 + nn
                       : Be[nb], ok);
      }
    }
  };

  // acc: the fp32 sum, one add a stage; part: the tensor cores' sum over
  // the stage's BK = 32 columns (12 mma's), promoted into acc and reset
  float acc[G::NB][G::MT][G::NT8][4], part[G::NB][G::MT][G::NT8][4];
#pragma unroll
  for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nb][mt][nt][r] = 0.0f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();     // tile kt has landed
    __syncthreads();                 // ... for every thread; slot kt-1 free
    if (kt + STAGES - 1 < nk)
      load_stage((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();
    const float* As = sm + (kt % STAGES) * G::STAGE_FL;
#pragma unroll
    for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[nb][mt][nt][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      unsigned ab[G::MT][4], as[G::MT][4];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        const float* ap = As + (wm * G::TM + mt * 16 + g) * LDA + kk + t;
        split_tf32(ap[0], ab[mt][0], as[mt][0]);             // (g, t)
        split_tf32(ap[8 * LDA], ab[mt][1], as[mt][1]);       // (g+8, t)
        split_tf32(ap[4], ab[mt][2], as[mt][2]);             // (g, t+4)
        split_tf32(ap[8 * LDA + 4], ab[mt][3], as[mt][3]);   // (g+8, t+4)
      }
#pragma unroll
      for (int nb = 0; nb < G::NB; ++nb) {
        unsigned bb[G::NT8][2], bs[G::NT8][2];
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt) {
          const float* bp = As + G::A_FL + nb * G::B_FL
              + (kk + t) * G::LDB + wn * G::TN + nt * 8 + g;
          split_tf32(bp[0], bb[nt][0], bs[nt][0]);             // (t, g)
          split_tf32(bp[4 * G::LDB], bb[nt][1], bs[nt][1]);    // (t+4, g)
        }
        // the small terms first, then big * big, each pass over every
        // tile (independent mma's back to back)
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < G::NT8; ++nt)
            mma(part[nb][mt][nt], as[mt], bb[nt]);
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < G::NT8; ++nt)
            mma(part[nb][mt][nt], ab[mt], bs[nt]);
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < G::NT8; ++nt)
            mma(part[nb][mt][nt], ab[mt], bb[nt]);
      }
    }
#pragma unroll
    for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[nb][mt][nt][r] += part[nb][mt][nt][r];
  }
  cp_async_wait<0>();

  float* oe = out + static_cast<long long>(e) * M * N;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * G::TM + mt * 16 + g + 8 * h;
        const int col = n0 + wn * G::TN + nt * 8 + 2 * t;
        if (row >= M) continue;
        float v0 = acc[0][mt][nt][2 * h], v1 = acc[0][mt][nt][2 * h + 1];
        if (SWIGLU) {
          v0 = silu_mul(v0, acc[G::NB - 1][mt][nt][2 * h]);
          v1 = silu_mul(v1, acc[G::NB - 1][mt][nt][2 * h + 1]);
        }
        float* o = oe + static_cast<long long>(row) * N + col;
        if (VEC == 4) {                    // N % 4 == 0: col + 1 < N too
          if (col < N) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (col < N) o[0] = v0;
          if (col + 1 < N) o[1] = v1;
        }
      }
}

template <bool SWIGLU, int VEC>
cudaError_t launch(const float* A, const float* B1, const float* B2,
                   float* out, int E, int M, int K, int N, cudaStream_t st) {
  using G = Cfg<SWIGLU>;
  auto kern = gmm_kernel_tc<SWIGLU, VEC>;
  const cudaError_t e = allow_smem<gmm_kernel_tc<SWIGLU, VEC>>(G::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, (N + G::BN - 1) / G::BN, E);
  kern<<<grid, NT, G::SMEM, st>>>(A, B1, B2, out, M, K, N);
  return cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------- decode: routed weight stream
namespace routed {

constexpr int NT = 256, BN = 128, BK = 16, STAGES = 4;
constexpr int CPT = 2;                     // columns a thread
constexpr int Q = NT / (BN / CPT);         // row groups
constexpr int CMAX = 64, RPT = CMAX / Q;   // rows; rows a thread at most

template <bool SWIGLU> struct Cfg {
  static constexpr int NB = SWIGLU ? 2 : 1;
  static constexpr int W_FL = NB * BK * BN;      // weight floats a stage
  static int smem(int C) { return STAGES * (W_FL + C * BK) * 4; }
};

// Row bookkeeping in `rows` (int32): idx [E][C] (an expert's occupied
// rows, compacted in order), slot [E][C] (each row's place in idx, or
// -1), count [E].  One block of 32 warps per expert, a warp a row at a
// time, eight 16-byte loads in flight a lane.
constexpr int ROWS_NT = 1024;

__global__ void __launch_bounds__(ROWS_NT) gmm_kernel_rows(
    const float* __restrict__ x, int* __restrict__ rows, int C, int d) {
  __shared__ int flag[CMAX];
  const int E = gridDim.x, e = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < C; r += ROWS_NT / 32) {
    const float* xr = x + (static_cast<long long>(e) * C + r) * d;
    bool nz = false;
    if (d % 4 == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
#pragma unroll 8
      for (int i = lane; i < d / 4; i += 32) {
        const float4 v = x4[i];
        nz |= v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
      }
    } else {
#pragma unroll 8
      for (int i = lane; i < d; i += 32) nz |= xr[i] != 0.0f;
    }
    nz = __any_sync(0xffffffffu, nz);
    if (lane == 0) flag[r] = nz;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int r = 0; r < C; ++r) {
      rows[E * C + e * C + r] = flag[r] ? n : -1;
      if (flag[r]) rows[e * C + n++] = r;
    }
    rows[2 * E * C + e] = n;
  }
}

// SWIGLU: H[e, j, :] = silu(x[e, idx[j]] Wg[e]) * (x[e, idx[j]] Wu[e])
// for the occupied rows j < count[e] (H compacted); otherwise
// y[e, idx[j], :] = H[e, j] Wd[e] and zeros in every other row of y.
// A is x [E, C, K] or H [E, C, K]; B1, B2 [E, K, N]; grid (N / BN, E).
// A thread owns CPT adjacent columns and the rows q, q + Q, ...
template <bool SWIGLU, int VEC>
__global__ void __launch_bounds__(NT) gmm_kernel_stream(
    const float* __restrict__ A, const float* __restrict__ B1,
    const float* __restrict__ B2, float* __restrict__ out,
    const int* __restrict__ rows, int C, int K, int N) {
  using G = Cfg<SWIGLU>;
  const int E = gridDim.y, e = blockIdx.y, n0 = blockIdx.x * BN;
  const int* idx = rows + e * C;
  const int* slot = rows + E * C + e * C;
  const int n_e = rows[2 * E * C + e];
  const int tid = threadIdx.x, cp = tid % (BN / CPT), q = tid / (BN / CPT);
  const int col = n0 + CPT * cp;
  float* oe = out + static_cast<long long>(e) * C * N;
  if (n_e == 0) {                          // no token: read no weight
    if (!SWIGLU)
      for (int r = q; r < C; r += Q)
#pragma unroll
        for (int u = 0; u < CPT; ++u)
          if (col + u < N) oe[static_cast<long long>(r) * N + col + u] = 0.0f;
    return;
  }
  extern __shared__ __align__(16) float sm[];
  const int stage_fl = G::W_FL + C * BK;
  const float* Ae = A + static_cast<long long>(e) * C * K;
  const float* Be[G::NB];
  Be[0] = B1 + static_cast<long long>(e) * K * N;
  if (SWIGLU) Be[G::NB - 1] = B2 + static_cast<long long>(e) * K * N;

  auto load_stage = [&](int s, int k0) {
    float* Ws = sm + s * stage_fl;
    float* Xs = Ws + G::W_FL;
#pragma unroll
    for (int nb = 0; nb < G::NB; ++nb) {
      if (VEC == 4) {
#pragma unroll
        for (int i = tid; i < BK * BN / 4; i += NT) {
          const int kr = i / (BN / 4), nc = (i % (BN / 4)) * 4;
          const bool ok = k0 + kr < K && n0 + nc < N;
          cp_async<16>(Ws + nb * BK * BN + kr * BN + nc,
                       ok ? Be[nb] + static_cast<long long>(k0 + kr) * N
                                + n0 + nc
                          : Be[nb], ok);
        }
      } else {
        for (int i = tid; i < BK * BN; i += NT) {
          const int kr = i / BN, nn = i % BN;
          const bool ok = k0 + kr < K && n0 + nn < N;
          cp_async<4>(Ws + nb * BK * BN + kr * BN + nn,
                      ok ? Be[nb] + static_cast<long long>(k0 + kr) * N
                               + n0 + nn
                         : Be[nb], ok);
        }
      }
    }
    if (VEC == 4) {
      for (int i = tid; i < n_e * (BK / 4); i += NT) {
        const int j = i / (BK / 4), kc = (i % (BK / 4)) * 4;
        const int src = SWIGLU ? idx[j] : j;
        const bool ok = k0 + kc < K;
        cp_async<16>(Xs + j * BK + kc,
                     ok ? Ae + static_cast<long long>(src) * K + k0 + kc : Ae,
                     ok);
      }
    } else {
      for (int i = tid; i < n_e * BK; i += NT) {
        const int j = i / BK, kk = i % BK;
        const int src = SWIGLU ? idx[j] : j;
        const bool ok = k0 + kk < K;
        cp_async<4>(Xs + j * BK + kk,
                    ok ? Ae + static_cast<long long>(src) * K + k0 + kk : Ae,
                    ok);
      }
    }
  };

  float acc[G::NB][RPT][CPT];
#pragma unroll
  for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < CPT; ++u) acc[nb][i][u] = 0.0f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk)
      load_stage((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();
    const float* Ws = sm + (kt % STAGES) * stage_fl;
    const float* Xs = Ws + G::W_FL;
    if (q < n_e) {                       // warp-uniform: a warp is one q
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        float2 w[G::NB][4];
#pragma unroll
        for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            w[nb][u] = *reinterpret_cast<const float2*>(
                Ws + nb * BK * BN + (kk + u) * BN + CPT * cp);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int j = q + Q * i;
          if (j >= n_e) break;
          const float4 xv = *reinterpret_cast<const float4*>(Xs + j * BK + kk);
          const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int nb = 0; nb < G::NB; ++nb)
#pragma unroll
            for (int u = 0; u < 4; ++u) {         // k in order
              acc[nb][i][0] = fmaf(xk[u], w[nb][u].x, acc[nb][i][0]);
              acc[nb][i][1] = fmaf(xk[u], w[nb][u].y, acc[nb][i][1]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int j = q + Q * i;
    if (j >= n_e) break;
    float* o = oe + static_cast<long long>(SWIGLU ? j : idx[j]) * N + col;
#pragma unroll
    for (int u = 0; u < CPT; ++u)
      if (col + u < N)
        o[u] = SWIGLU ? silu_mul(acc[0][i][u], acc[G::NB - 1][i][u])
                      : acc[0][i][u];
  }
  if (!SWIGLU)
    for (int r = q; r < C; r += Q)
      if (slot[r] < 0)
#pragma unroll
        for (int u = 0; u < CPT; ++u)
          if (col + u < N) oe[static_cast<long long>(r) * N + col + u] = 0.0f;
}

template <bool SWIGLU, int VEC>
cudaError_t launch(const float* A, const float* B1, const float* B2,
                   float* out, const int* rows, int E, int C, int K, int N,
                   cudaStream_t st) {
  auto kern = gmm_kernel_stream<SWIGLU, VEC>;
  const cudaError_t e = allow_smem<gmm_kernel_stream<SWIGLU, VEC>>(
      Cfg<SWIGLU>::smem(CMAX));
  if (e != cudaSuccess) return e;
  kern<<<dim3((N + BN - 1) / BN, E), NT, Cfg<SWIGLU>::smem(C), st>>>(
      A, B1, B2, out, rows, C, K, N);
  return cudaGetLastError();
}

}  // namespace routed

template <int VEC>
cudaError_t run(const float* x, const float* wg, const float* wu,
                const float* wd, float* hbuf, int* rows, float* y, int E,
                int C, int d, int f, cudaStream_t st) {
  cudaError_t e;
  if (C <= routed::CMAX) {
    routed::gmm_kernel_rows<<<E, routed::ROWS_NT, 0, st>>>(x, rows, C, d);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if ((e = routed::launch<true, VEC>(x, wg, wu, hbuf, rows, E, C, d, f,
                                       st)) != cudaSuccess) return e;
    return routed::launch<false, VEC>(hbuf, wd, nullptr, y, rows, E, C, f,
                                      d, st);
  }
  if ((e = tc::launch<true, VEC>(x, wg, wu, hbuf, E, C, d, f, st))
      != cudaSuccess) return e;
  return tc::launch<false, VEC>(hbuf, wd, nullptr, y, E, C, f, d, st);
}

}  // namespace

// xbuf [E, C, d], w_gate and w_up [E, d, f], w_down [E, f, d], hbuf
// [E, C, f] (scratch), rows (int32 scratch of 2 E C + E, when C <= 64;
// else unused), y [E, C, d]; all f32 but rows, contiguous.  The caller
// keeps E * C * f, E * C * d and E * d * f below 2^31.  Launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int moe_gmm_f32(const float* xbuf, const float* w_gate,
                           const float* w_up, const float* w_down,
                           float* hbuf, int* rows, float* y, int E, int C,
                           int d, int f, void* stream) {
  if (E == 0 || C == 0 || d == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f == 0)                          // an empty sum: y = 0
    return static_cast<int>(cudaMemsetAsync(
        y, 0, sizeof(float) * static_cast<size_t>(E) * C * d, st));
  if (C <= routed::CMAX && rows == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = d % 4 == 0 && f % 4 == 0
      ? run<4>(xbuf, w_gate, w_up, w_down, hbuf, rows, y, E, C, d, f, st)
      : run<1>(xbuf, w_gate, w_up, w_down, hbuf, rows, y, E, C, d, f, st);
  return static_cast<int>(e);
}
