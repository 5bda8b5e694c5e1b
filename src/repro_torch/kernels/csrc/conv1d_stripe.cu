// Member-stacked grouped 1-D "stripe" convolution, channels last, fp32.
//
// Replaces the Pallas TPU kernels repro/kernels/conv1d_stripe.py
// conv1d_stripe_stacked (:99, pallas_call at :127) and conv1d_stripe
// (:62, pallas_call at :81; here the M = 1 case).  On the TPU each grid
// step (member, batch, group) holds the whole padded [Lp, cin_g] stripe
// in VMEM and sums K shifted [L_out, cin_g] @ [cin_g, cout_g] products
// on the MXU.
//
//   y[m, b, l, co] = bias[m, co]
//       + sum_k sum_ci x[m, b, l*stride + k - lo, g*cin_g + ci]
//                     * w[m, k, ci, co],          g = co / cout_g
//
// with x read as zero outside [0, L) (SAME padding in the lax split,
// lo = pad_total // 2, or CAUSAL, lo = K - 1; the caller passes lo and
// L_out).
//
// What bounds it on the card: the channels are narrow (the ECG zoo's
// cin_g is 1 to 8 in the grouped stripes, at most 128 in the 1x1 convs;
// mamba's short conv is depthwise), so the products are far too thin
// for tensor cores and the conv stays fp32 (the reference is fp32; TF32
// would cost three decimal digits).  The depthwise convs and most of the
// zoo's are bounded by the bytes of x and y; at B = 1 (the per-member
// oracle query) a call is a few microseconds of device work and the
// wrapper's host time sets its cost (kernels/conv1d_stripe.py keeps that
// short).
//
// Three paths, one summation order.  Every output is
// bias + sum over k (outer) and ci (inner) of x * w, summed in that
// order by one thread with no atomics and no split-K, so a result is
// bitwise repeatable at a fixed shape:
//   * depthwise (cin_g = cout_g = 1, K <= 8, stride <= 2: mamba's three
//     short convs, the ECG stripes whose inner width is their
//     cardinality): a thread owns 4 consecutive channels (one float4,
//     when C % 4 == 0) and a run of RUN output positions; it loads the
//     run's (RUN - 1) * stride + K input rows once into registers, so
//     each x element is read once by the run (the K - stride rows two
//     runs share come from L2), with 16-byte loads, and writes each
//     output once, bias fused;
//   * tiled (the rest when the tile fits in shared memory: the stems,
//     the 1x1 convs, cin_g 2 to 8): a block stages the
//     [BL * stride + K - 1, span] x tile its channels read (span = the
//     input channels of the groups its BC output channels cover) and
//     their [K, cin_g, BC] weights in shared memory, zero-padded at the
//     signal's edges; each thread computes TL positions x 4 channels in
//     registers;
//   * direct (anything else, and on request): one thread per output,
//     co on the fastest thread index so the channels-last stores
//     coalesce.  It is the first version of this kernel.
// The entry point picks depthwise, then tiled, then direct by shape
// unless the caller asks for direct.
#include <cuda_runtime.h>

namespace {

__global__ void conv1d_stripe_direct_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y, unsigned total,
    int B, int L, int Cin, int K, int cin_g, int Cout, int cout_g,
    int stride, int lo, int L_out) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const unsigned co = i % Cout;
    unsigned r = i / Cout;
    const unsigned l = r % L_out;
    r /= L_out;                                   // m * B + b
    const unsigned m = r / B;
    const int g = co / cout_g;
    const float* xm = x + static_cast<long long>(r) * L * Cin + g * cin_g;
    const float* wm = w + static_cast<long long>(m) * K * cin_g * Cout + co;
    const int base = static_cast<int>(l) * stride - lo;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int li = base + k;
      if (li < 0 || li >= L) continue;            // zero padding
      const float* xr = xm + static_cast<long long>(li) * Cin;
      const float* wr = wm + static_cast<long long>(k) * cin_g * Cout;
      for (int ci = 0; ci < cin_g; ++ci)
        acc = fmaf(xr[ci], wr[static_cast<long long>(ci) * Cout], acc);
    }
    if (bias != nullptr) acc += bias[static_cast<long long>(m) * Cout + co];
    y[i] = acc;
  }
}

// ---------------------------------------------------------------- depthwise
constexpr int DW_THREADS = 256, DW_RUN = 8;

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ T zero() { return 0.0f; }
  static __device__ float get(const T& v, int) { return v; }
  static __device__ void set(T& v, int, float s) { v = s; }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ float get(const T& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  }
  static __device__ void set(T& v, int q, float s) {
    if (q == 0) v.x = s; else if (q == 1) v.y = s;
    else if (q == 2) v.z = s; else v.w = s;
  }
};

// x [M, B, L, C], w [M, K, 1, C], y [M, B, L_out, C]; C % V == 0.
template <int V, int KMAX, int S>
__global__ void __launch_bounds__(DW_THREADS) conv1d_stripe_depthwise_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y, unsigned total,
    int B, int L, int C, int K, int lo, int L_out) {
  using VT = typename Vec<V>::T;
  constexpr int NW = (DW_RUN - 1) * S + KMAX;     // input rows of a run
  const unsigned i = blockIdx.x * DW_THREADS + threadIdx.x;
  if (i >= total) return;
  const int nq = C / V;
  const unsigned runs = (L_out + DW_RUN - 1) / DW_RUN;
  const int cq = i % nq;
  const unsigned r = i / nq;
  const int l0 = (r % runs) * DW_RUN;
  const unsigned mb = r / runs;                   // m * B + b
  const unsigned m = mb / B;
  const VT* xv = reinterpret_cast<const VT*>(x + static_cast<long long>(mb)
                                             * L * C) + cq;
  const VT* wv = reinterpret_cast<const VT*>(w + static_cast<long long>(m)
                                             * K * C) + cq;
  VT wk[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    wk[k] = k < K ? wv[static_cast<long long>(k) * nq] : Vec<V>::zero();
  const int p0 = l0 * S - lo;
  const int nin = (DW_RUN - 1) * S + K;
  VT win[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int p = p0 + j;
    win[j] = j < nin && p >= 0 && p < L
        ? xv[static_cast<long long>(p) * nq] : Vec<V>::zero();
  }
  VT bv = Vec<V>::zero();
  if (bias != nullptr)
    bv = reinterpret_cast<const VT*>(bias + static_cast<long long>(m) * C)
        [cq];
  VT* yv = reinterpret_cast<VT*>(y + static_cast<long long>(mb) * L_out * C)
      + cq;
#pragma unroll
  for (int t = 0; t < DW_RUN; ++t) {
    if (l0 + t >= L_out) break;
    VT out;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K)
          acc = fmaf(Vec<V>::get(win[t * S + k], q), Vec<V>::get(wk[k], q),
                     acc);
      if (bias != nullptr) acc += Vec<V>::get(bv, q);
      Vec<V>::set(out, q, acc);
    }
    yv[static_cast<long long>(l0 + t) * nq] = out;
  }
}

template <int V, int KMAX>
cudaError_t launch_depthwise_s(int S, const float* x, const float* w,
                               const float* b, float* y, unsigned total,
                               int B, int L, int C, int K, int lo,
                               int L_out, cudaStream_t st) {
  const unsigned blocks = (total + DW_THREADS - 1) / DW_THREADS;
  if (S == 1)
    conv1d_stripe_depthwise_kernel<V, KMAX, 1><<<blocks, DW_THREADS, 0, st>>>(
        x, w, b, y, total, B, L, C, K, lo, L_out);
  else
    conv1d_stripe_depthwise_kernel<V, KMAX, 2><<<blocks, DW_THREADS, 0, st>>>(
        x, w, b, y, total, B, L, C, K, lo, L_out);
  return cudaGetLastError();
}

cudaError_t launch_depthwise(const float* x, const float* w, const float* b,
                             float* y, int M, int B, int L, int C, int K,
                             int S, int lo, int L_out, cudaStream_t st) {
  const int V = C % 4 == 0 ? 4 : 1;
  const unsigned runs = (L_out + DW_RUN - 1) / DW_RUN;
  const unsigned total = static_cast<unsigned>(M) * B * runs * (C / V);
  if (V == 4)
    return K <= 4 ? launch_depthwise_s<4, 4>(S, x, w, b, y, total, B, L, C,
                                             K, lo, L_out, st)
                  : launch_depthwise_s<4, 8>(S, x, w, b, y, total, B, L, C,
                                             K, lo, L_out, st);
  return K <= 4 ? launch_depthwise_s<1, 4>(S, x, w, b, y, total, B, L, C, K,
                                           lo, L_out, st)
                : launch_depthwise_s<1, 8>(S, x, w, b, y, total, B, L, C, K,
                                           lo, L_out, st);
}

// -------------------------------------------------------------------- tiled
constexpr int TI_THREADS = 128;
constexpr int TI_MAX_SMEM = 100 * 1024;          // bytes a block may stage

// Block tile: BL = (128 / (BC / 4)) * TL output positions x BC channels.
template <int BC> struct TiledCfg {
  static constexpr int NQ = BC / 4;                // channel quads
  static constexpr int NLL = TI_THREADS / NQ;      // position lanes
  static constexpr int TL = BC == 8 ? 2 : BC == 64 ? 8 : 4;
  static constexpr int BL = NLL * TL;
};

__host__ __device__ inline int tiled_rows(int BL, int S, int K) {
  return (BL - 1) * S + K;
}

// Floats of the x tile, rounded up so the weights behind it stay 16-byte
// aligned (they are read as float4).
__host__ __device__ inline int tiled_x_floats(int rows, int ld) {
  return (rows * ld + 3) & ~3;
}

// The widest input-channel span a BC-channel tile can read: the groups
// its channels touch, times cin_g.
__host__ __device__ inline int tiled_span(int BC, int cin_g, int cout_g,
                                          int Cout) {
  const int groups_max = (BC + cout_g - 2) / cout_g + 1;
  const int groups = Cout / cout_g;
  return (groups_max < groups ? groups_max : groups) * cin_g;
}

template <int BC, bool SHARED>
__global__ void __launch_bounds__(TI_THREADS) conv1d_stripe_tiled_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y, int B, int L,
    int Cin, int K, int cin_g, int Cout, int cout_g, int S, int lo,
    int L_out, int ld) {
  using Cfg = TiledCfg<BC>;
  constexpr int TL = Cfg::TL, NQ = Cfg::NQ, NLL = Cfg::NLL, BL = Cfg::BL;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int mb = blockIdx.z, m = mb / B;
  const int c0 = blockIdx.y * BC;
  const int cend = min(c0 + BC, Cout);
  const int g0 = c0 / cout_g, g1 = (cend - 1) / cout_g;
  const int ci0 = g0 * cin_g, span = (g1 - g0 + 1) * cin_g;
  const int l0 = blockIdx.x * BL;
  const int rows = tiled_rows(BL, S, K);
  const int p0 = l0 * S - lo;
  float* xs = sm;                                  // [rows][ld]
  float* ws = sm + tiled_x_floats(rows, ld);       // [K * cin_g][BC]

  const float* xm = x + static_cast<long long>(mb) * L * Cin + ci0;
  for (int i = tid; i < rows * span; i += TI_THREADS) {
    const int r = i / span, c = i - r * span, p = p0 + r;
    xs[r * ld + c] = p >= 0 && p < L
        ? xm[static_cast<long long>(p) * Cin + c] : 0.0f;
  }
  const float* wm = w + static_cast<long long>(m) * K * cin_g * Cout + c0;
  for (int i = tid; i < K * cin_g * BC; i += TI_THREADS) {
    const int t = i / BC, j = i - t * BC;
    ws[i] = c0 + j < Cout ? wm[static_cast<long long>(t) * Cout + j] : 0.0f;
  }
  __syncthreads();

  const int lc = tid % NQ, ll = tid / NQ;
  const int cb = c0 + 4 * lc;                      // this thread's channels
  int xoff[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = min(cb + q, Cout - 1);
    xoff[q] = (c / cout_g - g0) * cin_g;
  }
  float acc[TL][4];
#pragma unroll
  for (int j = 0; j < TL; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;

  for (int k = 0; k < K; ++k) {
    for (int ci = 0; ci < cin_g; ++ci) {
      const float4 wv = *reinterpret_cast<const float4*>(
          ws + (k * cin_g + ci) * BC + 4 * lc);
      const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int j = 0; j < TL; ++j) {
        const float* xr = xs + ((ll + j * NLL) * S + k) * ld + ci;
        if (SHARED) {
          const float xv = xr[xoff[0]];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] = fmaf(xv, wq[q], acc[j][q]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[j][q] = fmaf(xr[xoff[q]], wq[q], acc[j][q]);
        }
      }
    }
  }

  float bq[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias != nullptr)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (cb + q < Cout) bq[q] = bias[static_cast<long long>(m) * Cout + cb + q];
  float* ym = y + static_cast<long long>(mb) * L_out * Cout;
  const bool vec = Cout % 4 == 0 && cb < Cout;
#pragma unroll
  for (int j = 0; j < TL; ++j) {
    const int l = l0 + ll + j * NLL;
    if (l >= L_out) continue;
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[q] = acc[j][q];
      if (bias != nullptr) o[q] += bq[q];
    }
    float* yr = ym + static_cast<long long>(l) * Cout + cb;
    if (vec) {
      *reinterpret_cast<float4*>(yr) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (cb + q < Cout) yr[q] = o[q];
    }
  }
}

template <int BC>
int tiled_smem(int S, int K, int cin_g, int cout_g, int Cout, int* ld) {
  const int span = tiled_span(BC, cin_g, cout_g, Cout);
  *ld = span + 1;                                  // odd row stride
  return 4 * (tiled_x_floats(tiled_rows(TiledCfg<BC>::BL, S, K), *ld)
              + K * cin_g * BC);
}

template <int BC, bool SHARED>
cudaError_t launch_tiled_bc(const float* x, const float* w, const float* b,
                            float* y, int M, int B, int L, int Cin, int K,
                            int cin_g, int Cout, int cout_g, int S, int lo,
                            int L_out, cudaStream_t st) {
  int ld;
  const int smem = tiled_smem<BC>(S, K, cin_g, cout_g, Cout, &ld);
  auto kern = conv1d_stripe_tiled_kernel<BC, SHARED>;
  static bool raised = false;          // the opt-in above 48 KB, once
  if (smem > 48 * 1024 && !raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TI_MAX_SMEM);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const dim3 grid((L_out + TiledCfg<BC>::BL - 1) / TiledCfg<BC>::BL,
                  (Cout + BC - 1) / BC, M * B);
  kern<<<grid, TI_THREADS, smem, st>>>(x, w, b, y, B, L, Cin, K, cin_g, Cout,
                                       cout_g, S, lo, L_out, ld);
  return cudaGetLastError();
}

template <int BC>
cudaError_t launch_tiled(const float* x, const float* w, const float* b,
                         float* y, int M, int B, int L, int Cin, int K,
                         int cin_g, int Cout, int cout_g, int S, int lo,
                         int L_out, cudaStream_t st) {
  if (cout_g % 4 == 0)      // a thread's 4 channels share one group
    return launch_tiled_bc<BC, true>(x, w, b, y, M, B, L, Cin, K, cin_g,
                                     Cout, cout_g, S, lo, L_out, st);
  return launch_tiled_bc<BC, false>(x, w, b, y, M, B, L, Cin, K, cin_g, Cout,
                                    cout_g, S, lo, L_out, st);
}

int tiled_bc(int Cout) {
  return Cout <= 8 ? 8 : Cout <= 16 ? 16 : Cout <= 32 ? 32 : 64;
}

int tiled_smem_for(int bc, int S, int K, int cin_g, int cout_g, int Cout) {
  int ld;
  switch (bc) {
    case 8: return tiled_smem<8>(S, K, cin_g, cout_g, Cout, &ld);
    case 16: return tiled_smem<16>(S, K, cin_g, cout_g, Cout, &ld);
    case 32: return tiled_smem<32>(S, K, cin_g, cout_g, Cout, &ld);
    default: return tiled_smem<64>(S, K, cin_g, cout_g, Cout, &ld);
  }
}

enum Path { kDirect = 0, kDepthwise = 1, kTiled = 2 };

int pick_path(int M, int B, int K, int cin_g, int Cout, int cout_g,
              int stride) {
  if (cin_g == 1 && cout_g == 1 && K <= 8 && stride <= 2) return kDepthwise;
  const int bc = tiled_bc(Cout);
  if (M * B <= 65535 &&
      tiled_smem_for(bc, stride, K, cin_g, cout_g, Cout) <= TI_MAX_SMEM)
    return kTiled;
  return kDirect;
}

}  // namespace

// The path conv1d_stripe_f32 takes at this shape when force_direct is 0:
// 0 direct, 1 depthwise, 2 tiled.
extern "C" int conv1d_stripe_path(int M, int B, int Cin, int K, int cin_g,
                                  int Cout, int groups, int stride) {
  return pick_path(M, B, K, cin_g, Cout, Cout / groups, stride);
}

// x [M, B, L, Cin], w [M, K, cin_g, Cout], b [M, Cout] or null,
// y [M, B, L_out, Cout]; all f32, contiguous.  dims holds M, B, L, Cin,
// K, cin_g, Cout, groups, stride, lo, L_out (one host array, so a call
// passes seven arguments: at B = 1 the host's cost of a call is most of
// it).  The caller keeps M * B * L_out * Cout below 2^31.
// force_direct = 1 takes the direct path whatever the shape.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int conv1d_stripe_f32(const float* x, const float* w,
                                 const float* b, float* y, const int* dims,
                                 int force_direct, void* stream) {
  const int M = dims[0], B = dims[1], L = dims[2], Cin = dims[3],
            K = dims[4], cin_g = dims[5], Cout = dims[6], groups = dims[7],
            stride = dims[8], lo = dims[9], L_out = dims[10];
  const unsigned total = static_cast<unsigned>(M) * B * L_out * Cout;
  if (total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cout_g = Cout / groups;
  const int path = force_direct ? kDirect
      : pick_path(M, B, K, cin_g, Cout, cout_g, stride);
  if (path == kDepthwise)
    return static_cast<int>(launch_depthwise(x, w, b, y, M, B, L, Cin, K,
                                             stride, lo, L_out, st));
  if (path == kTiled) {
    cudaError_t e;
    switch (tiled_bc(Cout)) {
      case 8: e = launch_tiled<8>(x, w, b, y, M, B, L, Cin, K, cin_g, Cout,
                                  cout_g, stride, lo, L_out, st); break;
      case 16: e = launch_tiled<16>(x, w, b, y, M, B, L, Cin, K, cin_g, Cout,
                                    cout_g, stride, lo, L_out, st); break;
      case 32: e = launch_tiled<32>(x, w, b, y, M, B, L, Cin, K, cin_g, Cout,
                                    cout_g, stride, lo, L_out, st); break;
      default: e = launch_tiled<64>(x, w, b, y, M, B, L, Cin, K, cin_g, Cout,
                                    cout_g, stride, lo, L_out, st);
    }
    return static_cast<int>(e);
  }
  const int threads = 256;
  unsigned blocks = (total + threads - 1) / threads;
  if (blocks > (1u << 20)) blocks = 1u << 20;     // grid-stride beyond
  conv1d_stripe_direct_kernel<<<blocks, threads, 0, st>>>(
      x, w, b, y, total, B, L, Cin, K, cin_g, Cout, cout_g, stride, lo,
      L_out);
  return static_cast<int>(cudaGetLastError());
}
