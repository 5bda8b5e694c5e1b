// Single-token decode attention against a (ring) KV cache, fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention :69, pallas_call at :92).  There the grid is
// (batch, kv_head, k_block) with the k-block axis sequential on one
// core: all g query heads of a KV group share each K/V block (one
// [g, D] x [D, block_k] product on the MXU) and the online-softmax
// state (m, l, acc) is carried from block to block in VMEM.  What it
// computes is repro_torch/kernels/ref.py decode_attention:
//
//   s[h, t] = scale * q[b, h, :] . k[b, t, h / g, :]
//   visible = kpos[t] >= 0  &&  (!causal || kpos[t] <= qpos)
//                           &&  (!window || qpos - kpos[t] < window)
//   out[b, h, :] = softmax_t(visible ? s : -1e30) @ v[b, :, h / g, :]
//
// with v of width Dv, which may differ from D (MLA: 192 / 128, and the
// absorbed latent form 576 / 512, where v is the first 512 columns of
// the same cache rows as k).  A row that sees no key gets zeros, as the
// Pallas kernel's (its acc and l stay 0); the plain oracle gives the
// mean of v there.  No row of the LM path has one: a query always sees
// its own key.
//
// The TPU grid is not carried over: a sequential k axis would give the
// card B x Hkv blocks, 4 for the absorbed MLA step on 132 SMs.  Two
// launches instead:
//
// * split: one block of 256 threads per (piece of `ts` keys, KV head,
//   run of up to 16 query heads of its group, batch).  The wrapper picks
//   `ts` (a multiple of the 32-key tile) so that about two blocks land
//   on every SM.  A block walks its piece in tiles of 32 keys staged in
//   shared memory with cp.async; each K/V row is read once for all the
//   heads of the run.  Warp w scores the 32 keys of a tile (key = lane)
//   for heads w and w + 8, so a head's tile max and sum are warp
//   shuffles; the probabilities go through shared memory to the P @ V
//   step, where each thread owns a few (head, column) accumulators.
//   Tiles with no visible key are skipped.  The block writes its
//   unnormalised (m, l, acc) for each head to scratch.
// * combine: one block per (query head, batch) merges the pieces in
//   their fixed order: out = sum_i w_i acc_i / sum_i w_i l_i with
//   w_i = exp2(m_i - max m).  A piece with no visible key has m = -1e30,
//   l = 0, acc = 0 and adds nothing; a row with none at all gives 0.
//
// No atomics, and the order of every sum is fixed by the shape, so the
// result is deterministic at a fixed shape.  k and v rows may be
// strided (the last dim contiguous, 16-byte aligned): the absorbed step
// reads k and v straight out of the [B, M, 512 + 64] latent cache, and
// when v is a prefix of k's rows the V tile is the K tile (`v_in_k`).
//
// Both products are fp32 FMAs on the CUDA cores (tensor cores would need
// 3xTF32 to stay within the port's 1e-4).  Masked scores are -1e30,
// never -inf, and the softmax runs in base 2 on scores pre-multiplied by
// scale * log2(e).
//
// What bounds it on the card: the bytes of the visible K/V rows.  At
// B = 4 and a 2081-slot ring: materialized MLA (Hkv = 16, 192 + 128
// floats a row) 170 MB a layer, ~51 us at 3.35 TB/s; the absorbed form
// reads the 576-float latent rows once, 19.2 MB, ~5.7 us, against
// ~4.3 us of fp32 operations (2 (D + Dv) FLOPs per visible key and
// head, 16 heads), so there the arithmetic is nearly as tight as the
// bytes.
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 256;          // threads of a split block
constexpr int BK = 32;           // keys a tile: one per lane
constexpr int NW = NT / 32;      // warps
constexpr int GMAX = 16;         // query heads a block
constexpr int HR = GMAX / NW;    // heads a warp scores
constexpr int CT = 128;          // threads of a combine block
constexpr int SMEM_MAX = 232448; // bytes of shared memory a block

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* qpos;
  const int* kpos;
  float* part;                   // [B, Hq, n_split, Dv] unnormalised acc
  float* ml;                     // [B, Hq, n_split, 2]  (m, l), base 2
  float* o;                      // [B, Hq, Dv]
  long long skb, skt, skh, svb, svt, svh;   // row strides, in floats
  int B, T, Hq, Hkv, g, runs, D, DV, ldk, ldv;
  int causal, window, ts, n_split, v_in_k;
  float scale_log2;              // scale * log2(e)
};

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

// rows [r0, r0 + BK) of `width` floats each (row stride `row_stride`
// floats) into BK x ld floats of shared memory; rows >= n_rows zeroed
__device__ __forceinline__ void stage_tile(float* dst, const float* base,
                                           long long row_stride, int width,
                                           int ld, int r0, int n_rows) {
  const int v4 = width / 4;
  for (int i = threadIdx.x; i < BK * v4; i += NT) {
    const int r = i / v4, c = (i - r * v4) * 4;
    const int row = r0 + r;
    const bool in = row < n_rows;
    const float* src = in ? base + row * row_stride + c : base;
    cp_async16(dst + r * ld + c, src, in ? 16 : 0);
  }
}

__device__ __forceinline__ float fma4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Shared memory of a split block, in floats: Q [G][D], the K tile
// [BK][ldk], the V tile [BK][ldv] (none when v_in_k), P [GMAX][BK].
__host__ __device__ inline int split_smem_floats(int G, int D, int ldk,
                                                 int DV, int v_in_k) {
  return G * D + BK * ldk + (v_in_k ? 0 : BK * DV) + GMAX * BK;
}

// DVC: Dv rounded up to a power of two (16 .. 512); it fixes how the
// (head, column) accumulators of P @ V are laid over the threads.
template <int DVC>
__global__ void __launch_bounds__(NT) decode_split_kernel(Params p) {
  constexpr int CPT = DVC > NT ? DVC / NT : 1;     // columns a thread
  constexpr int TPC = DVC < NT ? NT / DVC : 1;     // threads a column
  constexpr int JPT = (GMAX + TPC - 1) / TPC;      // heads a thread
  extern __shared__ float4 smem4[];
  __shared__ float alpha_s[GMAX];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / p.runs, run = blockIdx.y - kh * p.runs;
  const int h0 = kh * p.g + run * GMAX;            // first query head
  const int G = min(GMAX, p.g - run * GMAX);       // heads of this block
  const int D = p.D, ldk = p.ldk, ldv = p.ldv;

  float* Qs = reinterpret_cast<float*>(smem4);     // [G][D]
  float* Ks = Qs + G * D;                          // [BK][ldk]
  float* Vs = p.v_in_k ? Ks : Ks + BK * ldk;       // [BK][ldv]
  float* Ps = Ks + BK * ldk + (p.v_in_k ? 0 : BK * p.DV);  // [GMAX][BK]

  const float* qb = p.q + (static_cast<long long>(b) * p.Hq + h0) * D;
  const float* kb = p.k + b * p.skb + kh * p.skh;
  const float* vb = p.v + b * p.svb + kh * p.svh;
  const int q_pos = p.qpos[0];
  const int t_begin = split * p.ts;
  const int t_end = min(t_begin + p.ts, p.T);

  for (int i = tid; i < G * D; i += NT) Qs[i] = qb[i] * p.scale_log2;

  // the P @ V accumulators: heads jsub + TPC * jj, columns col0 + NT * ci
  const int col0 = tid % (DVC < NT ? DVC : NT);
  const int jsub = DVC < NT ? tid / DVC : 0;
  float m[HR], l[HR], acc[JPT][CPT];
#pragma unroll
  for (int r = 0; r < HR; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
#pragma unroll
  for (int jj = 0; jj < JPT; ++jj)
#pragma unroll
    for (int ci = 0; ci < CPT; ++ci) acc[jj][ci] = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += BK) {
    const int t = t0 + lane;
    const int kp = t < t_end ? p.kpos[t] : -1;
    bool vis = kp >= 0;
    if (p.causal) vis = vis && kp <= q_pos;
    if (p.window) vis = vis && (q_pos - kp) < p.window;
    // the barrier also orders the previous tile's reads before the loads
    if (!__syncthreads_or(vis)) continue;
    stage_tile(Ks, kb, p.skt, D, ldk, t0, t_end);
    if (!p.v_in_k) stage_tile(Vs, vb, p.svt, p.DV, ldv, t0, t_end);
    cp_async_wait_all();
    __syncthreads();

    // scores of key `lane` for heads warp + NW * r
    float s[HR];
#pragma unroll
    for (int r = 0; r < HR; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * ldk;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < HR; ++r) {
        const int j = warp + NW * r;
        if (j < G)
          s[r] = fma4(s[r], *reinterpret_cast<const float4*>(Qs + j * D + d),
                      kv);
      }
    }
#pragma unroll
    for (int r = 0; r < HR; ++r) {
      const int j = warp + NW * r;
      if (j >= G) continue;                        // uniform in the warp
      const float sc = vis ? s[r] : NEG_INF;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float pr = exp2f(sc - m_new);
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = exp2f(m[r] - m_new);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
      Ps[j * BK + lane] = pr;
      if (lane == 0) alpha_s[j] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int j = jsub + TPC * jj;
      if (j < G) {
        const float a = alpha_s[j];
#pragma unroll
        for (int ci = 0; ci < CPT; ++ci) acc[jj][ci] *= a;
      }
    }
#pragma unroll 4
    for (int u = 0; u < BK; ++u) {
      float vv[CPT];
#pragma unroll
      for (int ci = 0; ci < CPT; ++ci) {
        const int c = col0 + NT * ci;
        vv[ci] = c < p.DV ? Vs[u * ldv + c] : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) {
        const int j = jsub + TPC * jj;
        if (j < G) {
          const float pj = Ps[j * BK + u];
#pragma unroll
          for (int ci = 0; ci < CPT; ++ci)
            acc[jj][ci] = fmaf(pj, vv[ci], acc[jj][ci]);
        }
      }
    }
  }

  // this piece's (m, l, acc) of every head of the block
  const long long row0 = static_cast<long long>(b) * p.Hq + h0;
#pragma unroll
  for (int jj = 0; jj < JPT; ++jj) {
    const int j = jsub + TPC * jj;
    if (j >= G) continue;
    float* dst = p.part + ((row0 + j) * p.n_split + split) * p.DV;
#pragma unroll
    for (int ci = 0; ci < CPT; ++ci) {
      const int c = col0 + NT * ci;
      if (c < p.DV) dst[c] = acc[jj][ci];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < HR; ++r) {
      const int j = warp + NW * r;
      if (j >= G) continue;
      float* dst = p.ml + ((row0 + j) * p.n_split + split) * 2;
      dst[0] = m[r];
      dst[1] = l[r];
    }
  }
}

__global__ void __launch_bounds__(CT) decode_combine_kernel(Params p) {
  extern __shared__ float w_s[];                   // [n_split]
  __shared__ float inv_l;
  const int tid = threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.y) * p.Hq +
                        blockIdx.x;
  const float* ml = p.ml + row * p.n_split * 2;
  float mx = NEG_INF;
  for (int i = 0; i < p.n_split; ++i) mx = fmaxf(mx, ml[2 * i]);
  for (int i = tid; i < p.n_split; i += CT) w_s[i] = exp2f(ml[2 * i] - mx);
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < p.n_split; ++i) sum = fmaf(w_s[i], ml[2 * i + 1], sum);
    inv_l = 1.f / fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  const float* part = p.part + row * p.n_split * p.DV;
  for (int c = tid; c < p.DV; c += CT) {
    float a = 0.f;
    for (int i = 0; i < p.n_split; ++i)
      a = fmaf(w_s[i], part[static_cast<long long>(i) * p.DV + c], a);
    p.o[row * p.DV + c] = a * inv_l;
  }
}

template <int DVC>
cudaError_t launch_split(const Params& p, int smem, cudaStream_t stream) {
  // more than 48 KB of dynamic shared memory must be allowed per kernel
  // (and per device, so it is set at every launch: ~1 us of host time)
  cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<DVC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.n_split, p.Hkv * p.runs, p.B);
  decode_split_kernel<DVC><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q [B, Hq, D] contiguous; k rows at k + b*skb + t*skt + h*skh (D floats,
// contiguous), v likewise with Dv floats; qpos [1] and kpos [T] int32;
// part [B, Hq, n_split, Dv] and ml [B, Hq, n_split, 2] scratch; out
// [B, Hq, Dv].  Every pointer and stride 16-byte aligned, D and Dv
// multiples of 4, Dv <= 512, Hkv | Hq, ts a multiple of 32 and
// n_split = ceil(T / ts) (checked by the caller; refused here with
// cudaErrorInvalidValue).  v_in_k: v's rows are the first Dv columns of
// k's (same pointer and strides).  Launches the two kernels on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int decode_attention_f32(
    const float* q, const float* k, const float* v, const int* qpos,
    const int* kpos, float* part, float* ml, float* out, int B, int T,
    int Hq, int Hkv, int D, int DV, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh, int causal,
    int window, int ts, int n_split, int v_in_k, float scale, void* stream) {
  if (B == 0 || Hq == 0) return 0;
  if (T <= 0 || Hkv <= 0 || Hq % Hkv || D <= 0 || D % 4 || DV <= 0 ||
      DV % 4 || DV > 512 || (v_in_k && DV > D) || ts <= 0 || ts % BK ||
      n_split != (T + ts - 1) / ts || n_split > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, qpos, kpos, part, ml, out, skb, skt, skh, svb, svt, svh,
           B, T, Hq, Hkv, Hq / Hkv, 0, D, DV, 0, 0, causal, window, ts,
           n_split, v_in_k, scale * LOG2E};
  p.runs = (p.g + GMAX - 1) / GMAX;
  // K tile rows padded to an odd number of float4s, so the float4 reads
  // of 8 consecutive rows by a quarter warp hit distinct banks
  p.ldk = (D / 4) % 2 ? D : D + 4;
  p.ldv = v_in_k ? p.ldk : DV;
  const int G = p.g < GMAX ? p.g : GMAX;
  const int smem = 4 * split_smem_floats(G, D, p.ldk, DV, v_in_k);
  if (smem > SMEM_MAX - 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  const int dvc = DV <= 16 ? 16 : DV <= 32 ? 32 : DV <= 64 ? 64
                : DV <= 128 ? 128 : DV <= 256 ? 256 : 512;
  switch (dvc) {
    case 16: e = launch_split<16>(p, smem, st); break;
    case 32: e = launch_split<32>(p, smem, st); break;
    case 64: e = launch_split<64>(p, smem, st); break;
    case 128: e = launch_split<128>(p, smem, st); break;
    case 256: e = launch_split<256>(p, smem, st); break;
    default: e = launch_split<512>(p, smem, st); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Hq, B);
  decode_combine_kernel<<<grid, CT, 4 * n_split, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
