// Ring-buffer window gather: the flush side of device-resident ingest.
//
// Replaces the Pallas TPU kernel repro/kernels/window_gather.py
// (window_gather :55, pallas_call at :71).  There, one grid step per
// flush row DMAs the patient's whole [C, cap] ring stripe into VMEM and
// unwraps it with a one-hot [cap, L] matmul on the MXU.  On Hopper that
// would read cap/L times the bytes it needs and spend tensor-core work
// on a copy, so this is a plain indexed gather:
//
//   out[i, c, j] = j < L - valid[i] ? 0
//                : buf[patients[i], c, (ends[i] - L + j) mod cap]
//
// What bounds it on the card: bytes.  It does no arithmetic beyond the
// index; each kept output element is one 4-byte load and one 4-byte
// store, each zeroed element a store without a load.  At the ECG flush
// (P = 64 rows, C = 3, L = 7500) that is at most 11.5 MB, 3.4 us at
// 3.35 TB/s (10 MB and 3.0 us in chip_smoke.py's flush, whose padding
// and partial rows read less);
// the first version (one block of 256 threads per (row, channel), 192
// blocks, ~30 scalar load/store pairs a thread with a 64-bit modulo on
// the wrap) took 0.0112 ms of device time on an H100 at 700 W, this one
// 0.0053 (chip_smoke.py phase 2; event-timed, both are set by the
// wrapper's host time, 0.02-0.04 ms a call).  Here:
// * each (row, channel) is cut along L into chunks of one block each
//   (1024 outputs when L % 4 == 0, else 256), so the ECG flush is 1536
//   blocks rather than 192;
// * when L % 4 == 0 every output row starts 16-byte aligned, and each
//   thread stores one float4 of it from four scalar ring loads (the
//   warp's loads cover consecutive ring positions, so they coalesce);
//   otherwise (vitals: L = 30) a thread stores one float;
// * the ring offset of the chunk's first output is reduced mod cap once
//   per block, in 64 bits (ends - L is negative when ends < L, and C's %
//   truncates toward zero); when L <= cap no later position in the chunk
//   is more than one ring length past it, so the wrap is one compare and
//   subtract in the loop.  L > cap (a window longer than the ring, which
//   the reference allows) takes the exact modulo an element instead.
//
// Pure data movement: the result is bitwise equal to the plain version
// (repro_torch/kernels/ref.py window_gather).
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int NT = 256;          // threads of a full block

// VEC: one float4 of output a thread (L % 4 == 0); WRAP: L > cap, the
// exact modulo per element.  Block = (row i * C + c, chunk of the row).
template <bool VEC, bool WRAP>
__global__ void __launch_bounds__(NT)
    window_gather_kernel(const float* __restrict__ buf,
                         const int* __restrict__ patients,
                         const int* __restrict__ ends,
                         const int* __restrict__ valid,
                         float* __restrict__ out, int C, int cap, int L,
                         int n_chunks) {
  constexpr int PER = VEC ? 4 : 1;                  // outputs a thread
  const int row = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - row * n_chunks;
  const int i = row / C;
  const int c = row - i * C;
  const int j = chunk * PER * blockDim.x + PER * threadIdx.x;
  if (j >= L) return;
  const int j0 = chunk * PER * blockDim.x;
  long long first = (static_cast<long long>(ends[i]) - L + j0) % cap;
  if (first < 0) first += cap;                      // floor-mod: [0, cap)
  const int zero_before = L - valid[i];             // j < this -> zero
  const float* src =
      buf + (static_cast<long long>(patients[i]) * C + c) * cap;
  float* dst = out + static_cast<long long>(row) * L + j;
  // this thread's first ring position, before the wrap: < 2 cap unless
  // WRAP (first < cap and j - j0 < L <= cap)
  const unsigned off = static_cast<unsigned>(first) + (j - j0);

  float r[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    r[e] = 0.0f;
    if (j + e >= zero_before) {
      unsigned pos;
      if constexpr (WRAP) {
        pos = static_cast<unsigned>((first + (j - j0) + e) % cap);
      } else {
        pos = off + e;
        pos = pos >= static_cast<unsigned>(cap) ? pos - cap : pos;
      }
      r[e] = src[pos];
    }
  }
  if constexpr (VEC)
    *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
  else
    dst[0] = r[0];
}

template <bool VEC, bool WRAP>
cudaError_t launch(const float* buf, const int* patients, const int* ends,
                   const int* valid, float* out, int C, int cap, int L,
                   int P, cudaStream_t stream) {
  const int units = VEC ? L / 4 : L;                // threads a row needs
  const int threads = units >= NT ? NT : (units + 31) / 32 * 32;
  const int n_chunks = (units + threads - 1) / threads;
  const long long blocks = static_cast<long long>(P) * C * n_chunks;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  window_gather_kernel<VEC, WRAP>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          buf, patients, ends, valid, out, C, cap, L, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// buf [N, C, cap] f32; patients/ends/valid [P] int32 (patients in
// [0, N), checked by the caller); out [P, C, L] f32, 16-byte aligned;
// dims (int[5]): N, C, cap, P, L (one pointer rather than five ints:
// each argument of a ctypes call costs host time).  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int window_gather_f32(const float* buf, const int* patients,
                                 const int* ends, const int* valid,
                                 float* out, const int* dims, void* stream) {
  const int C = dims[1], cap = dims[2], P = dims[3], L = dims[4];
  if (P == 0 || L == 0 || C == 0) return 0;
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = L % 4 == 0, wrap = L > cap;
  cudaError_t e;
  if (vec)
    e = wrap ? launch<true, true>(buf, patients, ends, valid, out, C, cap, L,
                                  P, st)
             : launch<true, false>(buf, patients, ends, valid, out, C, cap,
                                   L, P, st);
  else
    e = wrap ? launch<false, true>(buf, patients, ends, valid, out, C, cap,
                                   L, P, st)
             : launch<false, false>(buf, patients, ends, valid, out, C, cap,
                                    L, P, st);
  return static_cast<int>(e);
}
