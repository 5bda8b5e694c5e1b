// Mamba-2 SSD (state-space duality) chunked scan, fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd :74,
// pallas_call at :94).  There the grid is (batch, heads, chunks) with
// the chunk axis sequential on one core and the [P, N] state carried in
// VMEM scratch from one grid step to the next.  Blocks on Hopper run in
// parallel and in no order, so here one block owns one (batch, head)
// and loops over the chunks itself, keeping the state on chip.  What it
// computes is repro_torch/kernels/ref.py ssd_chunked:
//
//   per chunk of Lc steps (rows i, j), with g = h / (H / G):
//   seg_i   = sum_{r <= i} dt_r * A                    (<= 0)
//   W[i,j]  = (C_i . B_j) * exp(seg_i - seg_j) * dt_j   for j <= i, else 0
//   y_i     = sum_j W[i,j] x_j + exp(seg_i) * (h C_i) + D * x_i
//   h'      = exp(seg_last) * h + sum_j (exp(seg_last - seg_j) dt_j x_j) B_j^T
//
// exp(seg_i - seg_j) is taken of the difference and only for j <= i:
// exp(seg_i) * exp(-seg_j) overflows over a 128-step chunk (seg reaches
// -100 and below) and gives inf * 0.
//
// On-chip layout for one block (Lc <= 128, P <= 64, N <= 128; the
// served mamba2-2.7b shape is exactly Lc = 128, P = 64, N = 128, G = 1):
//   Bs [Lc][N+1], Cs [Lc][max(N,Lc)+1], xs [Lc][P+1], hs [P][N+1]  and
//   four [Lc] vectors (seg, dt, exp(seg), exp(total - seg) * dt):
//   200,448 bytes at the served shape, under the 227 KB a block may use.
// B, C, x and W (the [Lc, Lc] decay-weighted C B^T) do not all fit
// next to the state (~256 KB), so W is built in registers while C is
// still needed for it, and then written over C, which is dead by then.
// Rows are padded by one float so the column reads of the products hit
// 16 or 32 distinct banks.
//
// Per chunk, 256 threads as a 16 x 16 grid (ty, tx):
//   1. load dt, x, B, C of the chunk (rows past S read as dt = 0, x = B
//      = C = 0: a step with dt = 0 leaves the state as it is, and such
//      rows are not stored); thread 0 runs the cumsum of dt * A in step
//      order;
//   2. y = exp(seg) * C h^T: rows ty*8.., columns tx + 16c, in registers;
//   3. W = C B^T masked and scaled: rows ty*8.., columns tx + 16c (64 a
//      thread), in registers; then written over Cs;
//   4. y += W x (the causal half only: a thread's rows end at ty*8+7),
//      plus D x; stored;
//   5. h = exp(total) h + (x * wgt)^T B: each thread updates its own
//      4 x 8 elements of the state in place.
// After the last chunk the state is written out as hT.
//
// Numerics: fp32 FMAs on the CUDA cores, no tensor cores (the port is
// held to 1e-4 of the plain fp32 version), fixed summation order and no
// atomics, so a result is deterministic at a fixed shape.
//
// What bounds it on the card: at the served shape (B = 4, S = 2048,
// H = 80) the operations, ~7.36 MFLOP per (b, h, chunk) with C B^T and
// W x over their causal half, the pairs j <= i (5120 of them, 37.7
// GFLOP, 0.56 ms at the 67 TFLOP/s fp32 rate), against ~0.37 GB of x,
// y, B, C, dt, the state (0.11 ms at 3.35 TB/s).  This first version
// builds W over all 128 x 128 pairs in step 3 and masks j > i away,
// loads each chunk before computing on it (one block a SM: nothing
// hides the loads) and has 320 blocks for 132 SMs; building only the
// causal half, overlapping the next chunk's loads (cp.async or TMA into
// a second buffer) and splitting a head's rows over two blocks are the
// later work.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int MAXC = 128, MAXP = 64, MAXN = 128;

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
  int S, H, P, G, N, Lc;
};

__host__ __device__ inline int w_stride(int N, int Lc) {
  return (N > Lc ? N : Lc) + 1;
}

__host__ __device__ inline int smem_floats(int Lc, int P, int N) {
  return Lc * (N + 1) + Lc * w_stride(N, Lc) + Lc * (P + 1)
         + P * (N + 1) + 4 * Lc;
}

__global__ void __launch_bounds__(NT, 1) ssd_chunk_kernel(SsdParams p) {
  extern __shared__ float smem[];
  const int Lc = p.Lc, P = p.P, N = p.N;
  const int ldN = N + 1, ldW = w_stride(N, Lc), ldP = P + 1;
  float* Bs = smem;                    // [Lc][ldN]
  float* Cs = Bs + Lc * ldN;           // [Lc][ldW]: C, then W
  float* xs = Cs + Lc * ldW;           // [Lc][ldP]
  float* hs = xs + Lc * ldP;           // [P][ldN]
  float* seg = hs + P * ldN;           // [Lc]
  float* dts = seg + Lc;               // [Lc]
  float* eseg = dts + Lc;              // exp(seg)
  float* wgt = eseg + Lc;              // exp(total - seg) * dt

  const int bh = blockIdx.x;           // b * H + h
  const int b = bh / p.H, h = bh % p.H;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float A = p.A[h], Dh = p.D[h];

  const long long xrow = static_cast<long long>(p.H) * P;
  const long long brow = static_cast<long long>(p.G) * N;
  const float* xb = p.x + static_cast<long long>(b) * p.S * xrow
                    + static_cast<long long>(h) * P;
  float* yb = p.y + (xb - p.x);
  const float* dtb = p.dt + static_cast<long long>(b) * p.S * p.H + h;
  const long long boff = static_cast<long long>(b) * p.S * brow
                         + static_cast<long long>(g) * N;
  const float* Bb = p.Bm + boff;
  const float* Cb = p.Cm + boff;
  const long long hoff = static_cast<long long>(bh) * P * N;

  for (int i = tid; i < P * N; i += NT)
    hs[(i / N) * ldN + i % N] = p.h0 != nullptr ? p.h0[hoff + i] : 0.0f;

  // this thread's rows and columns, clamped so that every shared read is
  // in bounds; results of clamped rows and columns are never stored
  int ir[8], qc[4], jc[8], qr[4], nc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) ir[r] = min(ty * 8 + r, Lc - 1);
#pragma unroll
  for (int c = 0; c < 4; ++c) qc[c] = min(tx + 16 * c, P - 1);
#pragma unroll
  for (int c = 0; c < 8; ++c) jc[c] = min(tx + 16 * c, Lc - 1);
#pragma unroll
  for (int r = 0; r < 4; ++r) qr[r] = min(ty * 4 + r, P - 1);
#pragma unroll
  for (int c = 0; c < 8; ++c) nc[c] = min(tx + 16 * c, N - 1);

  const int nchunks = (p.S + Lc - 1) / Lc;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int s0 = ch * Lc;
    // ---- 1. load the chunk
    for (int i = tid; i < Lc * N; i += NT) {
      const int r = i / N, n = i % N;
      const bool ok = s0 + r < p.S;
      const long long o = static_cast<long long>(s0 + r) * brow + n;
      Bs[r * ldN + n] = ok ? Bb[o] : 0.0f;
      Cs[r * ldW + n] = ok ? Cb[o] : 0.0f;
    }
    for (int i = tid; i < Lc * P; i += NT) {
      const int r = i / P, q = i % P;
      xs[r * ldP + q] = s0 + r < p.S
          ? xb[static_cast<long long>(s0 + r) * xrow + q] : 0.0f;
    }
    for (int r = tid; r < Lc; r += NT)
      dts[r] = s0 + r < p.S ? dtb[static_cast<long long>(s0 + r) * p.H]
                            : 0.0f;
    __syncthreads();
    if (tid == 0) {
      float acc = 0.0f;
      for (int r = 0; r < Lc; ++r) {
        acc = __fadd_rn(acc, __fmul_rn(dts[r], A));
        seg[r] = acc;
      }
    }
    __syncthreads();
    const float total = seg[Lc - 1];
    for (int r = tid; r < Lc; r += NT) {
      eseg[r] = expf(seg[r]);
      wgt[r] = expf(total - seg[r]) * dts[r];
    }
    __syncthreads();

    // ---- 2. y = exp(seg) * C h^T (the carried state's contribution)
    float yacc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) yacc[r][c] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float cv[8], hv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) cv[r] = Cs[ir[r] * ldW + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) hv[c] = hs[qc[c] * ldN + n];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          yacc[r][c] = fmaf(cv[r], hv[c], yacc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float e = eseg[ir[r]];
#pragma unroll
      for (int c = 0; c < 4; ++c) yacc[r][c] *= e;
    }

    // ---- 3. W = (C B^T) * exp(seg_i - seg_j) * dt_j, j <= i
    float w[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) w[r][c] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float cv[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) cv[r] = Cs[ir[r] * ldW + n];
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = Bs[jc[c] * ldN + n];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) w[r][c] = fmaf(cv[r], bv[c], w[r][c]);
    }
    __syncthreads();                   // every read of C is done
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty * 8 + r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = tx + 16 * c;
        if (i < Lc && j < Lc)
          Cs[i * ldW + j] = j <= i
              ? w[r][c] * expf(seg[i] - seg[j]) * dts[j] : 0.0f;
      }
    }
    __syncthreads();

    // ---- 4. y += W x (rows ty*8.. see j <= ty*8+7 only), + D x
    const int jmax = min(Lc, ty * 8 + 8);
    for (int j = 0; j < jmax; ++j) {
      float wv[8], xv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) wv[r] = Cs[ir[r] * ldW + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = xs[j * ldP + qc[c]];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          yacc[r][c] = fmaf(wv[r], xv[c], yacc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty * 8 + r;
      if (i >= Lc || s0 + i >= p.S) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = tx + 16 * c;
        if (q < P)
          yb[static_cast<long long>(s0 + i) * xrow + q] =
              yacc[r][c] + Dh * xs[i * ldP + q];
      }
    }

    // ---- 5. h = exp(total) h + (x * wgt)^T B, this thread's elements
    float sacc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) sacc[r][c] = 0.0f;
    for (int j = 0; j < Lc; ++j) {
      const float wj = wgt[j];
      float xv[4], bv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[j * ldP + qr[r]] * wj;
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = Bs[j * ldN + nc[c]];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          sacc[r][c] = fmaf(xv[r], bv[c], sacc[r][c]);
    }
    const float et = expf(total);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = tx + 16 * c;
        if (q < P && n < N)
          hs[q * ldN + n] = hs[q * ldN + n] * et + sacc[r][c];
      }
    }
    __syncthreads();                   // before the next chunk's loads
  }
  __syncthreads();                     // S = 0: the state as loaded

  for (int i = tid; i < P * N; i += NT)
    p.hT[hoff + i] = hs[(i / N) * ldN + i % N];
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], A and D [H], Bm and Cm [B, S, G, N],
// h0 [B, H, P, N] or null, y [B, S, H, P], hT [B, H, P, N]; all f32,
// contiguous.  The caller checks G | H, 0 < chunk <= 128, 0 < P <= 64,
// 0 < N <= 128.  One block per (batch, head).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int ssd_f32(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* D,
                       const float* h0, float* y, float* hT, int batch,
                       int S, int H, int P, int G, int N, int chunk,
                       void* stream) {
  if (batch == 0 || H == 0) return 0;
  if (chunk > MAXC || P > MAXP || N > MAXN)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdParams p{x, dt, A, Bm, Cm, D, h0, y, hT, S, H, P, G, N, chunk};
  const int bytes = smem_floats(chunk, P, N) * static_cast<int>(sizeof(float));
  // more than 48 KB of dynamic shared memory must be allowed per kernel
  // (and per device, so it is set at every launch)
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(MAXC, MAXP, MAXN) * static_cast<int>(sizeof(float)));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_kernel<<<batch * H, NT, bytes,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
