// Ring-buffer window gather: the flush side of device-resident ingest.
//
// Replaces the Pallas TPU kernel repro/kernels/window_gather.py
// (window_gather, pallas_call at :71).  There, one grid step per flush
// row DMAs the patient's whole [C, cap] ring stripe into VMEM and
// unwraps it with a one-hot [cap, L] matmul on the MXU.  On Hopper that
// would read cap/L times the bytes it needs and spend tensor-core work
// on a copy, so this is a plain indexed gather:
//
//   out[i, c, j] = j < L - valid[i] ? 0
//                : buf[patients[i], c, (ends[i] - L + j) mod cap]
//
// What bounds it on the card: bytes.  It does no arithmetic beyond the
// index; each kept output element is one 4-byte load and one 4-byte
// store, each zeroed element one store.  The design keeps every access
// coalesced: one block per (row, channel), its threads striding over
// j, so a warp reads 32 consecutive ring positions (at most one wrap
// splits the run in two) and writes 32 consecutive outputs.  The ring
// offset is reduced once per block with a floor-mod (ends - L is
// negative whenever ends < L, and C's % truncates toward zero).
//
// Pure data movement: the result is bitwise equal to the plain version
// (repro_torch/kernels/ref.py window_gather).
#include <cuda_runtime.h>

namespace {

__global__ void window_gather_kernel(const float* __restrict__ buf,
                                     const int* __restrict__ patients,
                                     const int* __restrict__ ends,
                                     const int* __restrict__ valid,
                                     float* __restrict__ out,
                                     int C, int cap, int L) {
  const int row = blockIdx.x;                  // i * C + c
  const int i = row / C;
  const int c = row - i * C;
  const long long start_raw = static_cast<long long>(ends[i]) - L;
  long long start = start_raw % cap;           // floor-mod into [0, cap)
  if (start < 0) start += cap;
  const int zero_before = L - valid[i];        // j < this -> zero
  const float* src =
      buf + (static_cast<long long>(patients[i]) * C + c) * cap;
  float* dst = out + static_cast<long long>(row) * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    float v = 0.0f;
    if (j >= zero_before) {
      long long pos = start + j;
      if (pos >= cap) pos %= cap;
      v = src[pos];
    }
    dst[j] = v;
  }
}

}  // namespace

// buf [N, C, cap] f32; patients/ends/valid [P] int32 (patients in
// [0, N), checked by the caller); out [P, C, L] f32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int window_gather_f32(const float* buf, const int* patients,
                                 const int* ends, const int* valid,
                                 float* out, int N, int C, int cap, int P,
                                 int L, void* stream) {
  (void)N;
  if (P == 0 || L == 0) return 0;
  int threads = L >= 256 ? 256 : ((L + 31) / 32) * 32;
  window_gather_kernel<<<P * C, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      buf, patients, ends, valid, out, C, cap, L);
  return static_cast<int>(cudaGetLastError());
}
