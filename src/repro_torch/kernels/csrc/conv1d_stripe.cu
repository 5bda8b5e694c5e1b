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
// What bounds it on the card: the zoo's channels are narrow (cin_g is
// 1 or 8 in the grouped stripe, at most 128 in the 1x1 convs), so the
// products are far too thin for wgmma and the conv must stay fp32
// (the reference is fp32; TF32 tensor cores would cost three decimal
// digits).  It is an fp32 FMA kernel bounded by the CUDA cores' 67
// TFLOP/s, and for the small cin_g shapes by the bytes of x and y.
// This first version is the simple one the port asks for: one thread
// per output element (m, b, l, co), co on the fastest thread index so
// the channels-last stores coalesce and the threads of a warp share
// their x row (a broadcast load) while reading consecutive w columns.
// The padding is handled in the kernel (no padded copy of x), the bias
// is fused, and each sum runs in a fixed order (k outer, ci inner) with
// no atomics and no split-K, so a result is deterministic at a fixed
// shape.  Tiling x through shared memory and register-blocking over co
// are later work.
#include <cuda_runtime.h>

namespace {

__global__ void conv1d_stripe_kernel(const float* __restrict__ x,
                                     const float* __restrict__ w,
                                     const float* __restrict__ bias,
                                     float* __restrict__ y,
                                     unsigned total, int B, int L, int Cin,
                                     int K, int cin_g, int Cout,
                                     int cout_g, int stride, int lo,
                                     int L_out) {
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

}  // namespace

// x [M, B, L, Cin], w [M, K, cin_g, Cout], b [M, Cout] or null,
// y [M, B, L_out, Cout]; all f32, contiguous.  The caller keeps
// M * B * L_out * Cout below 2^31.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int conv1d_stripe_f32(const float* x, const float* w,
                                 const float* b, float* y, int M, int B,
                                 int L, int Cin, int K, int cin_g,
                                 int Cout, int groups, int stride, int lo,
                                 int L_out, void* stream) {
  const unsigned total = static_cast<unsigned>(M) * B * L_out * Cout;
  if (total == 0) return 0;
  const int threads = 256;
  unsigned blocks = (total + threads - 1) / threads;
  if (blocks > (1u << 20)) blocks = 1u << 20;     // grid-stride beyond
  conv1d_stripe_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, w, b, y, total, B, L, Cin, K, cin_g, Cout, Cout / groups, stride,
      lo, L_out);
  return static_cast<int>(cudaGetLastError());
}
