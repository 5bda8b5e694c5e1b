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
// attention, with v of width Dv (equal to D, or 128 at D = 192 for the
// materialized MLA prefill):
//
//   s[q, t] = scale * q[b, q, h, :] . k[b, t, h / g, :]
//   visible = kpos[t] >= 0  &&  (!causal || kpos[t] <= qpos[q])
//                           &&  (!window || qpos[q] - kpos[t] < window)
//   out[b, q, h, :] = softmax_t(visible ? s : -1e30) @ v[b, :, h / g, :]
//
// Masked scores are -1e30, never -inf: a tile whose keys a row cannot
// see gives exp(-1e30 - -1e30) = 1, and the first visible key later
// wipes that with alpha = exp(-1e30 - m) = 0.  The softmax runs in
// base 2 (exp2f of scores pre-multiplied by scale * log2 e), which is
// the same function.  A row that sees no key at all in the tiles the
// block visits gets the mean of v over those tiles (ref.attention gives
// the mean over all T); no row of the LM path has one, since a query
// always sees its own key.
//
// One block of 256 threads per (q tile of 64 rows, query head, batch).
// Q, K and V tiles are staged in shared memory with cp.async (rows padded
// to D + 4 and Dv + 4 floats, so the float4 reads of 16 consecutive rows
// hit distinct banks); each thread holds a 4 x 4 block of scores (rows
// 4*ty.., keys tx + 16*j) and a 4 x Dv/16 block of the accumulator.  Row
// max and sum are reduced over the 16 threads of a row with shuffles.
// The probabilities go back through shared memory (over the K tile,
// which is dead by then) for the P @ V product.  A k tile is skipped, for
// the whole block, when no key of it is live for any row: no valid key,
// or (causal) its least valid position is past the block's last query,
// or (window) its greatest position is at least `window` behind the
// block's first query.  Causal prefill thereby does about half the work
// of a dense sweep.  A single decode token (S = 1) is the work of
// decode_attention.cu, whose wrapper ops.attention calls instead.
//
// Ragged edges (S, T not multiples of the tile) are masked in the
// kernel: K/V rows past T are zero-filled by cp.async and read as empty
// slots (kpos = -1), rows past S are computed and not stored.  Nothing
// is padded by the wrapper.
//
// Both products are fp32 FMAs on the CUDA cores, in a fixed order with
// no atomics, so a result is deterministic at a fixed shape.  The port
// is held to rtol = atol = 1e-4 against the plain fp32 version; tensor
// cores would need 3xTF32 (split each operand into a TF32 high part and
// a TF32 remainder, three products) to stay inside that, since plain
// TF32 keeps 10 mantissa bits and moves a D = 128 dot product by ~1e-3.
//
// What bounds it on the card: the operations, 2 (D + Dv) FLOPs per
// visible (q, k) pair and head.  At the qwen3-4b prefill shape (B=4,
// S=T=2048, Hq=32, Hkv=8, D=128, causal) 137 GFLOP per layer, ~2.05 ms
// at the 67 TFLOP/s fp32 rate, against ~0.1 ms for the bytes (q, k, v
// read once and o written once); at the DeepSeek-V2-Lite MLA prefill
// (Hq = Hkv = 16, D = 192, Dv = 128) 85.9 GFLOP, ~1.28 ms.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* qpos;
  const int* kpos;
  float* o;
  int B, S, T, Hq, Hkv, g, causal, window;
  float scale_log2;            // scale * log2(e)
};

__device__ __forceinline__ bool visible(int qp, int kp, const Params& p) {
  bool ok = kp >= 0;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window) ok = ok && (qp - kp) < p.window;
  return ok;
}

// 16-byte global -> shared copy; src_bytes = 0 zero-fills the target
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows [r0, r0 + R) of a [rows, H, D] tensor (row stride H * D floats,
// `base` already offset to the head) into R x LD floats of shared
// memory; rows >= n_rows are zero-filled
template <int D, int LD, int R, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* base,
                                           long long row_stride, int r0,
                                           int n_rows) {
  constexpr int V4 = D / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < R * V4; i += NT) {
    const int r = i / V4, c = (i - r * V4) * 4;
    const int row = r0 + r;
    const bool in = row < n_rows;
    const float* src = in ? base + row * row_stride + c : base;
    cp_async16(dst + r * LD + c, src, in ? 16 : 0);
  }
}

__device__ __forceinline__ float fma4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

// ------------------------------------------------------------- prefill
constexpr int BQ = 64, BK = 64, NT = 256, PLD = BK + 4;

// Q and K tiles are [64][D + 4] floats, V [64][DV + 4]; at (192, 128)
// they take 134 KB, so that instantiation runs one block an SM (and may
// use up to 255 registers a thread) where the square ones run two.
template <int D, int DV>
struct PrefillSmem {
  static constexpr int LD = D + 4;
  static constexpr int LDV = DV + 4;
  static constexpr int KREG = (BK * LD > BQ * PLD) ? BK * LD : BQ * PLD;
  static constexpr int FLOATS = BQ * LD + KREG + BK * LDV;
  static constexpr int BYTES = FLOATS * 4;
  static constexpr int MIN_BLOCKS = 2 * BYTES <= 232448 ? 2 : 1;
};

template <int D, int DV>
__global__ void __launch_bounds__(NT, (PrefillSmem<D, DV>::MIN_BLOCKS))
    flash_prefill_kernel(Params p) {
  constexpr int LD = PrefillSmem<D, DV>::LD;
  constexpr int LDV = PrefillSmem<D, DV>::LDV;
  constexpr int DC = DV / 16;               // accumulator columns / thread
  constexpr bool VEC = (DC % 4) == 0;       // float4 columns (Dv = 64, 128)
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);      // [BQ][LD]
  float* Ks = Qs + BQ * LD;                         // [BK][LD], then P
  float* Vs = Ks + PrefillSmem<D, DV>::KREG;        // [BK][LDV]
  float* Ps = Ks;                                   // [BQ][PLD]
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];
  __shared__ int q_lo, q_hi, tile_live;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int s0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.g;
  const long long q_stride = static_cast<long long>(p.Hq) * D;
  const long long k_stride = static_cast<long long>(p.Hkv) * D;
  const long long v_stride = static_cast<long long>(p.Hkv) * DV;
  const float* qb = p.q + (static_cast<long long>(b) * p.S * p.Hq + h) * D;
  const float* kb = p.k + (static_cast<long long>(b) * p.T * p.Hkv + kh) * D;
  const float* vb = p.v + (static_cast<long long>(b) * p.T * p.Hkv + kh) * DV;

  stage_rows<D, LD, BQ, NT>(Qs, qb, q_stride, s0, p.S);
  if (tid < BQ) qp_s[tid] = s0 + tid < p.S ? p.qpos[s0 + tid] : 0;
  cp_async_wait_all();
  __syncthreads();
  if (tid < 32) {                      // the block's query position range
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = tid; r < BQ; r += 32) {
      if (s0 + r < p.S) {
        lo = min(lo, qp_s[r]);
        hi = max(hi, qp_s[r]);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (tid == 0) {
      q_lo = lo;
      q_hi = hi;
    }
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = 0; t0 < p.T; t0 += BK) {
    if (tid < BK) kp_s[tid] = t0 + tid < p.T ? p.kpos[t0 + tid] : -1;
    __syncthreads();
    if (tid < 32) {                    // is any key of the tile live?
      const int a = kp_s[tid], c = kp_s[tid + 32];
      int kmin = min(a >= 0 ? a : INT_MAX, c >= 0 ? c : INT_MAX);
      int kmax = max(a, c);
      for (int off = 16; off > 0; off >>= 1) {
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
        kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
      }
      if (tid == 0) {
        bool live = kmax >= 0;
        if (p.causal) live = live && kmin <= q_hi;
        if (p.window)
          live = live && static_cast<long long>(kmax) >
                             static_cast<long long>(q_lo) - p.window;
        tile_live = live;
      }
    }
    __syncthreads();
    if (!tile_live) continue;          // uniform over the block

    stage_rows<D, LD, BK, NT>(Ks, kb, k_stride, t0, p.T);
    stage_rows<DV, LDV, BK, NT>(Vs, vb, v_stride, t0, p.T);
    cp_async_wait_all();
    __syncthreads();

    // scores: rows 4*ty + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fma4(s[i][j], qv[i], kv[j]);
    }
    int kp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kp[j] = kp_s[tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = qp_s[4 * ty + i];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(q_pos, kp[j], p) ? s[i][j] * p.scale_log2 : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();                   // every thread is done with Ks
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * ty + i) * PLD + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc += P @ V: rows 4*ty + i; columns 4*tx + 64*hh + e (VEC) or
    // tx + 16*c
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * PLD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * LDV;
        float vv[DC];
        if constexpr (VEC) {
#pragma unroll
          for (int hh = 0; hh < DC / 4; ++hh) {
            const float4 t = *reinterpret_cast<const float4*>(
                vrow + 4 * tx + 64 * hh);
            vv[4 * hh] = t.x;
            vv[4 * hh + 1] = t.y;
            vv[4 * hh + 2] = t.z;
            vv[4 * hh + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < DC; ++c) vv[c] = vrow[tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = comp(pv[i], u);
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pi, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int s = s0 + 4 * ty + i;
    if (s >= p.S) continue;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    float* orow = p.o + (static_cast<long long>(b * p.S + s) * p.Hq + h) * DV;
    if constexpr (VEC) {
#pragma unroll
      for (int hh = 0; hh < DC / 4; ++hh)
        *reinterpret_cast<float4*>(orow + 4 * tx + 64 * hh) =
            make_float4(acc[i][4 * hh] * inv, acc[i][4 * hh + 1] * inv,
                        acc[i][4 * hh + 2] * inv, acc[i][4 * hh + 3] * inv);
    } else {
#pragma unroll
      for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
    }
  }
}

// more than 48 KB of dynamic shared memory must be allowed per kernel
// (and per device, so it is set at every launch: ~1 us of host time)
template <int D, int DV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = PrefillSmem<D, DV>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((p.S + BQ - 1) / BQ, p.Hq, p.B);
  flash_prefill_kernel<D, DV><<<grid, NT, bytes, stream>>>(p);
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
  Params p{q, k, v, qpos, kpos, out, B, S, T, Hq, Hkv, Hq / Hkv,
           causal, window, scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D == 16 && Dv == 16) e = launch<16, 16>(p, st);
  else if (D == 32 && Dv == 32) e = launch<32, 32>(p, st);
  else if (D == 64 && Dv == 64) e = launch<64, 64>(p, st);
  else if (D == 128 && Dv == 128) e = launch<128, 128>(p, st);
  else if (D == 192 && Dv == 128) e = launch<192, 128>(p, st);  // MLA
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
