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
// What bounds it on the card depends on C.  At decode (phi3.5-moe,
// B = 4: C = 16 rows an expert) the expert weights: 3 * 16 * 4096 * 6400
// floats, 5.03 GB a layer, ~1.5 ms at 3.35 TB/s; every SM has to stream
// its share of them, and a grid of (expert, C tile) blocks would have
// only 16.  At prefill (C = 1296 rows an expert) the operations:
// 6 * 16 * 1296 * 4096 * 6400 = 3.26 TFLOP a layer, ~49 ms at the
// 67 TFLOP/s fp32 rate.
//
// Design: two launches of one tiled fp32 SIMT GEMM, with no atomics and
// no split-K (deterministic at a fixed shape):
//   1. H = silu(x Wg) * (x Wu), grid (f tiles, C tiles, E): a block
//      holds the gate and the up accumulator of a BM x 64 tile and
//      applies the SwiGLU in its epilogue;
//   2. y = H Wd, grid (d tiles, C tiles, E).
// At the decode shape that is 1600 and 1024 blocks, each streaming a
// [K, 64] slice of one expert's weights, so the weight stream is spread
// over every SM.  The price is the H round trip through device memory
// (E * C * f floats: 5.3 MB at decode, 0.53 GB at prefill) that the
// TPU kernel avoids; fusing it back (an on-chip H tile per block, with
// the down projection split over d) is later work.
//
// Tiles: 256 threads as 16 x 16; BN = 64 columns, BK = 16 of the
// contraction a step; BM = 64 rows (a thread computes 4 x 4) or, when an
// expert has at most 16 rows as at decode, BM = 16 (1 x 4), so no FMA
// is spent on empty rows.  The next k step's tiles are loaded into
// registers while the current one is multiplied from shared memory.
// Every edge (C, f, d not multiples of a tile) is masked: loads past an
// edge read zero and stores past it are dropped.  fp32 FMAs on the CUDA
// cores: the port is held to 1e-4 of the plain fp32 version, which TF32
// tensor cores would not keep.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256, BN = 64, BK = 16;

// out[e] (M x N) = A[e] (M x K) @ B1[e] (K x N), or with SWIGLU
// silu(A[e] @ B1[e]) * (A[e] @ B2[e]); all row-major.
template <int BM, bool SWIGLU>
__global__ void __launch_bounds__(NT) gmm_kernel(
    const float* __restrict__ A, const float* __restrict__ B1,
    const float* __restrict__ B2, float* __restrict__ out, int M, int K,
    int N) {
  constexpr int TM = BM / 16;          // rows a thread computes
  constexpr int NB = SWIGLU ? 2 : 1;   // right-hand operands
  constexpr int LDA = BM + 4;          // 16-byte rows, fewer conflicts
  __shared__ __align__(16) float As[BK][LDA];
  __shared__ __align__(16) float Bs[NB][BK][BN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* Ae = A + static_cast<long long>(e) * M * K;
  const float* Be[NB];
  Be[0] = B1 + static_cast<long long>(e) * K * N;
  if (SWIGLU) Be[NB - 1] = B2 + static_cast<long long>(e) * K * N;

  // loads: A tile element tid + 256 l is (row, kk) = (/BK, %BK); B tile
  // element tid + 256 l is (kk, col) = (/BN, %BN)
  float ra[TM], rb[NB][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < TM; ++l) {
      const int i = tid + NT * l, row = m0 + i / BK, k = k0 + i % BK;
      ra[l] = row < M && k < K ? Ae[static_cast<long long>(row) * K + k]
                               : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < NB; ++t)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int i = tid + NT * l, k = k0 + i / BN, col = n0 + i % BN;
        rb[t][l] = k < K && col < N
            ? Be[t][static_cast<long long>(k) * N + col] : 0.0f;
      }
  };
  auto store = [&]() {
#pragma unroll
    for (int l = 0; l < TM; ++l) {
      const int i = tid + NT * l;
      As[i % BK][i / BK] = ra[l];
    }
#pragma unroll
    for (int t = 0; t < NB; ++t)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int i = tid + NT * l;
        Bs[t][i / BN][i % BN] = rb[t][l];
      }
  };

  float acc[NB][TM][4];
#pragma unroll
  for (int t = 0; t < NB; ++t)
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][r][c] = 0.0f;

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) {
    load(0);
    store();
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      if (TM == 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
      } else {
        a[0] = As[kk][ty];
      }
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(&Bs[t][kk][tx * 4]);
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[t][r][c] = fmaf(a[r], b[c], acc[t][r][c]);
      }
    }
    __syncthreads();
    if (kt + 1 < nk) {
      store();
      __syncthreads();
    }
  }

  float* oe = out + static_cast<long long>(e) * M * N;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = m0 + ty * TM + r;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + tx * 4 + c;
      if (col >= N) continue;
      float v = acc[0][r][c];
      if (SWIGLU) v = v / (1.0f + expf(-v)) * acc[NB - 1][r][c];
      oe[static_cast<long long>(row) * N + col] = v;
    }
  }
}

template <int BM>
cudaError_t launch(const float* x, const float* wg, const float* wu,
                   const float* wd, float* hbuf, float* y, int E, int C,
                   int d, int f, cudaStream_t stream) {
  const unsigned mt = (C + BM - 1) / BM;
  gmm_kernel<BM, true><<<dim3((f + BN - 1) / BN, mt, E), NT, 0, stream>>>(
      x, wg, wu, hbuf, C, d, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gmm_kernel<BM, false><<<dim3((d + BN - 1) / BN, mt, E), NT, 0, stream>>>(
      hbuf, wd, nullptr, y, C, f, d);
  return cudaGetLastError();
}

}  // namespace

// xbuf [E, C, d], w_gate and w_up [E, d, f], w_down [E, f, d], hbuf
// [E, C, f] (scratch), y [E, C, d]; all f32, contiguous.  The caller
// keeps E * C * f and E * d * f below 2^31.  Two launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int moe_gmm_f32(const float* xbuf, const float* w_gate,
                           const float* w_up, const float* w_down,
                           float* hbuf, float* y, int E, int C, int d,
                           int f, void* stream) {
  if (E == 0 || C == 0 || d == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f == 0)                          // an empty sum: y = 0
    return static_cast<int>(cudaMemsetAsync(
        y, 0, sizeof(float) * static_cast<size_t>(E) * C * d, st));
  const cudaError_t e = C <= 16
      ? launch<16>(xbuf, w_gate, w_up, w_down, hbuf, y, E, C, d, f, st)
      : launch<64>(xbuf, w_gate, w_up, w_down, hbuf, y, E, C, d, f, st);
  return static_cast<int>(e);
}
