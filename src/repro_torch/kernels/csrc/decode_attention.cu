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
// card B x Hkv blocks, 4 for the absorbed MLA step on 132 SMs.  Instead
// T is cut into pieces of whole 32-key tiles (the wrapper's split_plan:
// about one wave of blocks, pieces of at least 4 tiles, 2 on the
// tensor-core path) and one block takes one (piece, KV head, run of 16
// query heads of its group, batch), reading each K/V row once for all
// the heads of its run.  Each block writes its piece's unnormalised
// (m, l, acc) to scratch and a second launch merges the pieces in their
// fixed order: out = sum_i w_i acc_i / sum_i w_i l_i with w_i =
// exp2(m_i - max m).  A piece with no visible key has m = -1e30, l = 0,
// acc = 0 and adds nothing; a row with none at all gives 0.  When the
// plan has one piece the block writes the normalised output itself, with
// the combine's arithmetic (w = 1), and there is no second launch.
//
// What bounds it on the card: the bytes of the visible K/V rows.  At
// B = 4 and a 2081-slot ring: materialized MLA (Hkv = 16, 192 + 128
// floats a row) 170 MB a layer, ~51 us at 3.35 TB/s; qwen3-4b (Hkv = 8,
// 128 + 128) ~20 us; the absorbed form reads the 576-float latent rows
// once, 19.2 MB, ~5.7 us, against ~4.3 us of fp32 operations (2 (D + Dv)
// FLOPs per visible key and head, 16 heads), so there the arithmetic is
// nearly as tight as the bytes.  Two paths:
//
// * CUDA cores (any g; runs of up to 16 heads): the K/V tiles of a piece
//   stream through a two-slot cp.async ring, the next tile in flight
//   while one is scored (the first version waited for each tile).  The
//   scores of a tile are split over the warps by D: warp w forms the
//   partial q . k of every head of the run over its D / 8 columns for
//   the 32 keys (key = lane) and the partials are summed in warp order,
//   so every warp scores at every g (the first version gave warp w the
//   heads w and w + 8: 1 warp of 8 at g = 1).  A warp per head then
//   runs the online softmax with shuffles.  P @ V gives each thread a
//   group of the tile's keys and 4 columns of Dv (a 16-byte read of V)
//   for every head, and adds the groups once, at the end of the piece
//   (one (head, column) pair a thread over all 32 keys left half the
//   threads idle at g = 1 and spent most instructions on guards and
//   loads, and set the kernel's time: the tiles are few bytes of work).
//   A tile's copies are a few instructions each (warp w copies rows w,
//   w + 8, ...), not a division and a 64-bit multiply.
// * tensor cores (g a multiple of 16, D and Dv multiples of 8: the
//   absorbed MLA step, 16 heads on one latent head): the 16 heads are
//   one m16 tile, so Q K^T and P V run as 3xTF32 mma.sync.m16n8k8
//   (hopper.cuh), each product's 32-deep partial sums promoted into fp32
//   as in moe_gmm.cu.  Q K^T: warp w takes keys 8 (w % 4).. and one half
//   of D, the halves summed in order; P V: warp w takes the 8-column
//   tiles w, w + 8, ...  of Dv.  The keys of a P V k-step are taken in
//   the order 0, 2, 4, 6 | 1, 3, 5, 7 so that the V fragment loads hit
//   distinct banks on rows padded to 4 mod 32 floats, the padding that
//   the K fragment loads need.  Fewer, longer pieces than the CUDA-core
//   path would take (the first version cut the absorbed step into 66
//   pieces of one tile, 8.6 MB of partial sums; now 33 of two, 4.3 MB).
//   On an H100 (700 W) the absorbed step takes 0.025 ms of device time
//   here against 0.091 ms on the CUDA-core path, which also fits it
//   (chip_smoke.py phase 2 times both on the same inputs).
//
// Which path a shape takes, and a block's shared-memory layout, are
// decided in one place, `layout` below: the wrapper asks for them once a
// shape (decode_attention_plan) and passes the path to the launcher.
//
// No atomics, and the order of every sum is fixed by the shape, so the
// result is deterministic at a fixed shape.  k and v rows may be
// strided (the last dim contiguous, 16-byte aligned): the absorbed step
// reads k and v straight out of the [B, M, 512 + 64] latent cache, and
// when v is a prefix of k's rows the V tile is the K tile (`v_in_k`).
// Masked scores are -1e30, never -inf, and the softmax runs in base 2 on
// scores pre-multiplied by scale * log2(e).
#include <cuda_runtime.h>

#include <atomic>

namespace {

#include "hopper.cuh"

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 256;          // threads of a split block
constexpr int BK = 32;           // keys a tile: one per lane
constexpr int NW = NT / 32;      // warps
constexpr int GMAX = 16;         // query heads a block
constexpr int HR = GMAX / NW;    // heads a warp runs the softmax of
constexpr int LDP = 40;          // rows of P and of the mma path's scores
constexpr int CT = 128;          // threads of a combine block
constexpr int SMEM_MAX = 232448; // bytes of shared memory a block
constexpr int MAX_SLOTS = 6;     // of the K/V ring

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
  int slots;                     // of the K/V ring, 2 .. MAX_SLOTS
  float scale_log2;              // scale * log2(e)
};

// rows [r0, r0 + BK) of `width` floats each (row stride `row_stride`
// floats) into BK x ld floats of shared memory; rows >= n_rows zeroed.
// Warp w copies rows w, w + NW, ..., its lanes 16 bytes each along the
// row: no division, a few instructions a copy.
__device__ __forceinline__ void stage_tile(float* dst, const float* base,
                                           long long row_stride, int width,
                                           int ld, int r0, int n_rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BK; r += NW) {
    const int row = r0 + r;
    const bool in = row < n_rows;
    const float* src = base + (in ? row * row_stride : 0);
    float* d = dst + r * ld;
    for (int c = 4 * lane; c < width; c += 128)
      cp_async<16>(d + c, in ? src + c : base, in);
  }
}

__device__ __forceinline__ float fma4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// floats of one ring slot: a K tile and, unless v is a prefix of k's
// rows, a V tile
__host__ __device__ inline int tile_floats(int ldk, int ldv, int v_in_k) {
  return BK * ldk + (v_in_k ? 0 : BK * ldv);
}

// wait until at most n of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<MAX_SLOTS - 2>(); break;
  }
}

// The K/V tiles of a block's piece through a ring of p.slots tiles of
// shared memory: tile j lands in slot j % slots, issued slots - 1 tiles
// ahead of the one being scored.  Which keys of a tile are visible is a
// ballot taken when it is issued (every warp reads the same 32 slots of
// kpos, so every warp takes the same ballot) and kept in vis_mask; the
// kpos a lane needs for that is read one tile earlier still, so no
// global load stands between a slot's release and its next copy.  A
// tile with no visible key is not copied.  Each issue commits one copy
// group, empty or not.
struct KeyRing {
  float* ring;
  unsigned* vis_mask;            // [MAX_SLOTS], in shared memory
  const float* kb;
  const float* vb;
  const int* kpos;
  long long skt, svt;
  int D, DV, ldk, ldv, v_in_k, slots, causal, window;
  int t_begin, t_end, n_tiles, q_pos;

  __device__ __forceinline__ KeyRing(const Params& p, float* ring_,
                                     unsigned* mask_, int b, int kh,
                                     int split)
      : ring(ring_), vis_mask(mask_), kb(p.k + b * p.skb + kh * p.skh),
        vb(p.v + b * p.svb + kh * p.svh), kpos(p.kpos), skt(p.skt),
        svt(p.svt), D(p.D), DV(p.DV), ldk(p.ldk), ldv(p.ldv),
        v_in_k(p.v_in_k), slots(p.slots), causal(p.causal),
        window(p.window), t_begin(split * p.ts),
        t_end(min(split * p.ts + p.ts, p.T)),
        n_tiles((t_end - t_begin + BK - 1) / BK), q_pos(p.qpos[0]) {}

  __device__ int slot_floats() const {
    return tile_floats(ldk, ldv, v_in_k);
  }
  __device__ const float* k_tile(int j) const {
    return ring + (j % slots) * slot_floats();
  }
  __device__ const float* v_tile(int j) const {
    return v_in_k ? k_tile(j) : k_tile(j) + BK * ldk;
  }
  __device__ bool visible(int kp) const {
    bool vis = kp >= 0;
    if (causal) vis = vis && kp <= q_pos;
    if (window) vis = vis && (q_pos - kp) < window;
    return vis;
  }
  // this lane's kpos in tile j (-1 past the piece)
  __device__ int kpos_of(int j) const {
    const int t = t_begin + j * BK + (threadIdx.x & 31);
    return j < n_tiles && t < t_end ? kpos[t] : -1;
  }
  __device__ void issue(int j, int kp) {
    const unsigned m = __ballot_sync(0xffffffffu, visible(kp));
    if (m != 0u) {
      float* Ks = ring + (j % slots) * slot_floats();
      const int t0 = t_begin + j * BK;
      stage_tile(Ks, kb, skt, D, ldk, t0, t_end);
      if (!v_in_k) stage_tile(Ks + BK * ldk, vb, svt, DV, ldv, t0, t_end);
    }
    if (threadIdx.x == 0) vis_mask[j % slots] = m;
    cp_async_commit();
  }
  // the first slots - 1 tiles; returns this lane's kpos of the next
  __device__ int start() {
    int kp[MAX_SLOTS];
#pragma unroll
    for (int j = 0; j < MAX_SLOTS; ++j) kp[j] = j < slots ? kpos_of(j) : -1;
    int next = -1;
#pragma unroll
    for (int j = 0; j < MAX_SLOTS; ++j) {
      if (j < slots - 1) issue(j, kp[j]);
      if (j == slots - 1) next = kp[j];
    }
    return next;
  }
  // wait for tile i (every thread's copies), then issue tile
  // i + slots - 1 into the slot tile i - 1 leaves; kp: this lane's kpos
  // of that tile, replaced by its kpos of the one after
  __device__ unsigned next(int i, int& kp) {
    cp_async_wait_upto(slots - 2);
    __syncthreads();
    issue(i + slots - 1, kp);
    kp = kpos_of(i + slots);
    return vis_mask[i % slots];
  }
};


// Shared memory of a block, in floats.  CUDA cores: Q [G][D], partial
// scores [NW][G][BK], P [G][BK], the ring (then the key groups' sums of
// P @ V).  Tensor cores: Q [16][ldk], scores [2][16][LDP], P [16][LDP],
// the ring.
inline int pv_groups(int DV) {                      // PvLayout<DVC>::KS
  const int dvc = DV <= 16 ? 16 : DV <= 32 ? 32 : DV <= 64 ? 64
                : DV <= 128 ? 128 : DV <= 256 ? 256 : 512;
  return NT / (dvc / 4) < BK ? NT / (dvc / 4) : BK;
}

inline int fma_smem_floats(const Params& p, int G) {
  const int ring = p.slots * tile_floats(p.ldk, p.ldv, p.v_in_k);
  const int red = pv_groups(p.DV) * G * p.DV;      // after the ring
  return G * p.D + NW * G * BK + G * BK + (ring > red ? ring : red);
}

inline int mma_smem_floats(const Params& p) {
  return GMAX * p.ldk + 3 * GMAX * LDP
         + p.slots * tile_floats(p.ldk, p.ldv, p.v_in_k);
}

// The online-softmax step of head j for the 32 keys of a tile (key =
// lane): m, l updated, p written to Ps[j], alpha to alpha_s[j].
__device__ __forceinline__ void softmax_step(float sc, bool vis, int j,
                                             float& m, float& l, float* Ps,
                                             int ldp, float* alpha_s) {
  const int lane = threadIdx.x & 31;
  sc = vis ? sc : NEG_INF;
  float mx = sc;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float m_new = fmaxf(m, mx);
  const float pr = exp2f(sc - m_new);
  float sum = pr;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float alpha = exp2f(m - m_new);
  l = l * alpha + sum;
  m = m_new;
  Ps[j * ldp + lane] = pr;
  if (lane == 0) alpha_s[j] = alpha;
}

// ------------------------------------------------------- CUDA-core path
// DVC: Dv rounded up to a power of two (16 .. 512).  P @ V lays its
// threads out as (key group ks, float4 column c4): C4 = DVC / 4 columns
// and KS = 256 / C4 groups (at most 32) of 32 / KS keys each; a thread
// keeps the running sums of every head of the block for its 4 columns
// over its keys, and the groups' sums are added in group order once, at
// the end of the piece.
template <int DVC>
struct PvLayout {
  static constexpr int C4 = DVC / 4;
  static constexpr int KS = NT / C4 < BK ? NT / C4 : BK;
  static constexpr int KPT = BK / KS;               // keys a thread
};

template <int DVC>
__global__ void __launch_bounds__(NT) decode_split_kernel(Params p) {
  using L = PvLayout<DVC>;
  extern __shared__ float4 smem4[];
  __shared__ float alpha_s[GMAX], l_s[GMAX];
  __shared__ unsigned vis_mask[MAX_SLOTS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / p.runs, run = blockIdx.y - kh * p.runs;
  const int h0 = kh * p.g + run * GMAX;            // first query head
  const int G = min(GMAX, p.g - run * GMAX);       // heads of this block
  const int D = p.D, ldk = p.ldk, ldv = p.ldv;

  float* Qs = reinterpret_cast<float*>(smem4);     // [G][D]
  float* Sp = Qs + G * D;                          // [NW][G][BK]
  float* Ps = Sp + NW * G * BK;                    // [G][BK]
  float* ring = Ps + G * BK;                       // p.slots tiles

  const float* qb = p.q + (static_cast<long long>(b) * p.Hq + h0) * D;
  KeyRing kr(p, ring, vis_mask, b, kh, split);
  int kp_next = kr.start();

  for (int i = tid; i < G * D; i += NT) Qs[i] = qb[i] * p.scale_log2;

  // this warp's columns of q . k: float4s [d_lo, d_hi) of D / 4; the
  // first n_dw warps have some
  const int d4 = D / 4, per_w = (d4 + NW - 1) / NW;
  const int d_lo = min(d4, warp * per_w), d_hi = min(d4, d_lo + per_w);
  const int n_dw = (d4 + per_w - 1) / per_w;

  // P @ V: this thread's key group and columns 4 c4 .. 4 c4 + 3
  const int c4 = tid % L::C4, ks = tid / L::C4;
  const bool pv = ks < L::KS && 4 * c4 < p.DV;
  float m[HR], l[HR], acc[GMAX][4];
#pragma unroll
  for (int r = 0; r < HR; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < GMAX; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < kr.n_tiles; ++i) {
    const unsigned mask = kr.next(i, kp_next);
    if (mask == 0u) continue;                      // the same in every warp
    const bool vis = (mask >> lane) & 1u;
    const float* Ks = kr.k_tile(i);
    const float* Vs = kr.v_tile(i);

    // partial scores of key `lane` over this warp's columns, every head
    if (warp < n_dw) {
      float s[GMAX];
#pragma unroll
      for (int j = 0; j < GMAX; ++j) s[j] = 0.f;
      const float* krow = Ks + lane * ldk;
      for (int c = d_lo; c < d_hi; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + 4 * c);
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          if (j >= G) break;
          s[j] = fma4(s[j],
                      *reinterpret_cast<const float4*>(Qs + j * D + 4 * c),
                      kv);
        }
      }
#pragma unroll
      for (int j = 0; j < GMAX; ++j) {
        if (j >= G) break;
        Sp[(warp * G + j) * BK + lane] = s[j];
      }
    }
    __syncthreads();

    // the partials summed in warp order; softmax of heads warp + NW * r
#pragma unroll
    for (int r = 0; r < HR; ++r) {
      const int j = warp + NW * r;
      if (j >= G) continue;                        // uniform in the warp
      float sc = 0.f;
      for (int w = 0; w < n_dw; ++w) sc += Sp[(w * G + j) * BK + lane];
      softmax_step(sc, vis, j, m[r], l[r], Ps, BK, alpha_s);
    }
    __syncthreads();

    // acc = acc * alpha + P @ V over this thread's keys
    if (pv) {
#pragma unroll
      for (int j = 0; j < GMAX; ++j) {
        if (j >= G) break;
        const float a = alpha_s[j];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= a;
      }
#pragma unroll
      for (int kk = 0; kk < L::KPT; ++kk) {
        const int u = ks * L::KPT + kk;
        const float4 v4 = *reinterpret_cast<const float4*>(
            Vs + u * ldv + 4 * c4);
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          if (j >= G) break;
          const float pj = Ps[j * BK + u];
          acc[j][0] = fmaf(pj, v4.x, acc[j][0]);
          acc[j][1] = fmaf(pj, v4.y, acc[j][1]);
          acc[j][2] = fmaf(pj, v4.z, acc[j][2]);
          acc[j][3] = fmaf(pj, v4.w, acc[j][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                                 // the ring is free

  // the key groups' sums, added in group order: this piece's (m, l, acc)
  // of every head of the block, or with one piece the output, as the
  // combine would form it (w = 1)
  float* red = ring;                               // [KS][G][DV]
  if (pv) {
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
      if (j >= G) break;
      *reinterpret_cast<float4*>(red + (ks * G + j) * p.DV + 4 * c4) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }
  const long long row0 = static_cast<long long>(b) * p.Hq + h0;
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < HR; ++r) {
      const int j = warp + NW * r;
      if (j >= G) continue;
      l_s[j] = l[r];
      if (p.n_split > 1) {
        float* dst = p.ml + ((row0 + j) * p.n_split + split) * 2;
        dst[0] = m[r];
        dst[1] = l[r];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * p.DV; e += NT) {
    const int j = e / p.DV, c = e - j * p.DV;
    float a = 0.f;
    for (int g2 = 0; g2 < L::KS; ++g2) a += red[(g2 * G + j) * p.DV + c];
    if (p.n_split == 1)
      p.o[(row0 + j) * p.DV + c] = a * (1.f / fmaxf(l_s[j], 1e-30f));
    else
      p.part[((row0 + j) * p.n_split + split) * p.DV + c] = a;
  }
}

// ----------------------------------------------------- tensor-core path
// Runs of exactly 16 query heads; D and Dv multiples of 8, rows of the K
// (and V) tiles at ldk (ldv) = 4 mod 32 floats.
__global__ void __launch_bounds__(NT, 1) decode_mma_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float alpha_s[GMAX], l_s[GMAX], m_s[GMAX];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / p.runs, run = blockIdx.y - kh * p.runs;
  const int h0 = kh * p.g + run * GMAX;
  const int D = p.D, ldk = p.ldk, ldv = p.ldv;

  float* Qs = sm;                                  // [16][ldk]
  float* Sp = Qs + GMAX * ldk;                     // [2][16][LDP]
  float* Ps = Sp + 2 * GMAX * LDP;                 // [16][LDP]
  float* ring = Ps + GMAX * LDP;                   // p.slots tiles
  __shared__ unsigned vis_mask[MAX_SLOTS];

  const float* qb = p.q + (static_cast<long long>(b) * p.Hq + h0) * D;
  KeyRing kr(p, ring, vis_mask, b, kh, split);
  int kp_next = kr.start();
  for (int i = tid; i < GMAX * D; i += NT) {
    const int j = i / D, d = i - j * D;
    Qs[j * ldk + d] = qb[i] * p.scale_log2;
  }

  // Q K^T: keys nt8 * 8.. of the tile, k8 steps [k_lo, k_hi) of D / 8
  const int nt8 = warp & 3, half = warp >> 2;
  const int nk8 = D / 8, k_mid = (nk8 + 1) / 2;
  const int k_lo = half ? k_mid : 0, k_hi = half ? nk8 : k_mid;
  // P V: the 8-column tiles warp + NW * u of Dv
  const int n_vt = p.DV / 8;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[u][r] = 0.f;

  for (int i = 0; i < kr.n_tiles; ++i) {
    const unsigned mask = kr.next(i, kp_next);
    if (mask == 0u) continue;
    const bool vis = (mask >> lane) & 1u;
    const float* Ks = kr.k_tile(i);
    const float* Vs = kr.v_tile(i);

    float sacc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = k_lo; s0 < k_hi; s0 += 4) {      // 32 of k a stage
      float spart[4] = {0.f, 0.f, 0.f, 0.f};
      const int s1 = min(s0 + 4, k_hi);
      for (int ks = s0; ks < s1; ++ks) {
        const int k = ks * 8;
        Frag8A a;                                  // (head, d) = Q[h][d]
        const float* ap = Qs + g * ldk + k + t;
        a.set(ap[0], ap[8 * ldk], ap[4], ap[8 * ldk + 4]);
        Frag8B bf;                                 // (d, key) = K[key][d]
        const float* bp = Ks + (nt8 * 8 + g) * ldk + k + t;
        bf.set(bp[0], bp[4]);
        mma3(spart, a, bf);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) sacc[r] += spart[r];
    }
    float* sp = Sp + half * GMAX * LDP + nt8 * 8 + 2 * t;
    *reinterpret_cast<float2*>(sp + g * LDP) = make_float2(sacc[0], sacc[1]);
    *reinterpret_cast<float2*>(sp + (g + 8) * LDP) =
        make_float2(sacc[2], sacc[3]);
    __syncthreads();

    // the two halves of D summed in order; softmax of heads 2w, 2w + 1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = 2 * warp + r;
      const float sc = Sp[j * LDP + lane] + Sp[(GMAX + j) * LDP + lane];
      softmax_step(sc, vis, j, m[r], l[r], Ps, LDP, alpha_s);
    }
    __syncthreads();

    // o = o * alpha + P V; k-step keys in the order 0, 2, 4, 6 | 1, 3, 5, 7
    Frag8A pa[BK / 8];
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const float2 lo = *reinterpret_cast<const float2*>(
          Ps + g * LDP + ks * 8 + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(
          Ps + (g + 8) * LDP + ks * 8 + 2 * t);
      pa[ks].set(lo.x, hi.x, lo.y, hi.y);
    }
    const float a_lo = alpha_s[g], a_hi = alpha_s[g + 8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int vt = warp + NW * u;
      if (vt >= n_vt) break;                       // uniform in the warp
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        Frag8B bf;                                 // (key, col) = V[key][col]
        const float* bp = Vs + (ks * 8 + 2 * t) * ldv + vt * 8 + g;
        bf.set(bp[0], bp[ldv]);
        mma3(part, pa[ks], bf);
      }
      o[u][0] = o[u][0] * a_lo + part[0];
      o[u][1] = o[u][1] * a_lo + part[1];
      o[u][2] = o[u][2] * a_hi + part[2];
      o[u][3] = o[u][3] * a_hi + part[3];
    }
  }
  cp_async_wait<0>();

  const long long row0 = static_cast<long long>(b) * p.Hq + h0;
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_s[2 * warp + r] = l[r];
      m_s[2 * warp + r] = m[r];
    }
  }
  __syncthreads();
  if (p.n_split > 1 && tid < GMAX) {
    float* dst = p.ml + ((row0 + tid) * p.n_split + split) * 2;
    dst[0] = m_s[tid];
    dst[1] = l_s[tid];
  }
  const float sc_lo = p.n_split == 1 ? 1.f / fmaxf(l_s[g], 1e-30f) : 1.f;
  const float sc_hi = p.n_split == 1 ? 1.f / fmaxf(l_s[g + 8], 1e-30f) : 1.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int vt = warp + NW * u;
    if (vt >= n_vt) break;
    const int col = vt * 8 + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = row0 + g + 8 * hh;
      const float s = hh ? sc_hi : sc_lo;
      float* dst = p.n_split == 1
          ? p.o + row * p.DV + col
          : p.part + (row * p.n_split + split) * p.DV + col;
      const float2 v = p.n_split == 1
          ? make_float2(o[u][2 * hh] * s, o[u][2 * hh + 1] * s)
          : make_float2(o[u][2 * hh], o[u][2 * hh + 1]);
      *reinterpret_cast<float2*>(dst) = v;
    }
  }
}

// one block per (query head, batch, CT columns of Dv)
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
  const int c = blockIdx.z * CT + tid;             // a column a thread
  if (c >= p.DV) return;
  float a = 0.f;
#pragma unroll 8
  for (int i = 0; i < p.n_split; ++i)
    a = fmaf(w_s[i], part[static_cast<long long>(i) * p.DV + c], a);
  p.o[row * p.DV + c] = a * inv_l;
}

template <int DVC>
cudaError_t launch_fma(const Params& p, int smem, cudaStream_t stream) {
  cudaError_t e = allow_smem<decode_split_kernel<DVC>>(smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.n_split, p.Hkv * p.runs, p.B);
  decode_split_kernel<DVC><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// rows of a tensor-core tile: 4 mod 32 floats (conflict-free fragments)
inline int mma_ld(int width) { return width + (36 - width % 32) % 32; }

// A block's layout on `path` (1 tensor cores, 0 CUDA cores) with a ring
// of p.slots tiles: sets p.ldk and p.ldv and returns the bytes of shared
// memory, or 0 when the path cannot take the shape.  The one place that
// decides it: the wrapper's plan asks through decode_attention_plan, the
// launcher through the same function.
int layout(Params& p, int path) {
  int floats;
  if (path == 1) {
    if (p.g % GMAX || p.D % 8 || p.DV % 8) return 0;
    p.ldk = mma_ld(p.D);
    p.ldv = p.v_in_k ? p.ldk : mma_ld(p.DV);
    floats = mma_smem_floats(p);
  } else {
    // K tile rows padded to an odd number of float4s, so the float4 reads
    // of 8 consecutive rows by a quarter warp hit distinct banks
    p.ldk = (p.D / 4) % 2 ? p.D : p.D + 4;
    p.ldv = p.v_in_k ? p.ldk : p.DV;
    floats = fma_smem_floats(p, p.g < GMAX ? p.g : GMAX);
  }
  return 4 * floats <= SMEM_MAX - 1024 ? 4 * floats : 0;
}

}  // namespace

// The plan of a shape (g query heads a KV head, head dims D and Dv,
// v_in_k) with a ring of `slots` tiles on `path` (-1: the tensor cores
// when they take it, else the CUDA cores).  Fills out[0] = the path,
// out[1] = a block's bytes of shared memory, out[2] = the key groups of
// the CUDA-core P @ V (1 on the tensor cores).  Returns 0, or
// cudaErrorInvalidValue when no path fits a block's shared memory.
extern "C" int decode_attention_plan(int g, int D, int DV, int v_in_k,
                                     int slots, int path, int* out) {
  Params p{};
  p.g = g;
  p.D = D;
  p.DV = DV;
  p.v_in_k = v_in_k;
  p.slots = slots;
  if (g <= 0 || D <= 0 || DV <= 0 || DV > 512 || slots < 2 ||
      slots > MAX_SLOTS || path < -1 || path > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = layout(p, path < 0 ? 1 : path);
  if (path < 0 && smem == 0) smem = layout(p, path = 0);
  if (path < 0) path = 1;
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = path;
  out[1] = smem;
  out[2] = path == 1 ? 1 : pv_groups(DV);
  return 0;
}

// q [B, Hq, D] contiguous; k rows at k + b*skb + t*skt + h*skh (D floats,
// contiguous), v likewise with Dv floats; qpos [1] and kpos [T] int32;
// scratch: part [B, Hq, n_split, Dv] then ml [B, Hq, n_split, 2] (unused
// when n_split = 1); out [B, Hq, Dv].  dims (int64[19]): B, T, Hq, Hkv,
// D, Dv, k strides (b, t, h), v strides (b, t, h), causal, window, ts,
// n_split, v_in_k, slots of the K/V ring (2 .. 6) and the path, both as
// decode_attention_plan gave them.  Every pointer and stride 16-byte
// aligned, D and Dv multiples of 4, Dv <= 512, Hkv | Hq, ts a multiple
// of 32 and n_split = ceil(T / ts) (checked by the caller; refused here
// with cudaErrorInvalidValue).  v_in_k: v's rows are the first Dv
// columns of k's (same pointer and strides).  Launches on `stream` (the
// combine only when n_split > 1) and returns cudaGetLastError() (0 on
// success).
extern "C" int decode_attention_f32(const float* q, const float* k,
                                    const float* v, const int* qpos,
                                    const int* kpos, float* scratch,
                                    float* out, const long long* dims,
                                    float scale, void* stream) {
  const int B = static_cast<int>(dims[0]), T = static_cast<int>(dims[1]);
  const int Hq = static_cast<int>(dims[2]), Hkv = static_cast<int>(dims[3]);
  const int D = static_cast<int>(dims[4]), DV = static_cast<int>(dims[5]);
  const int ts = static_cast<int>(dims[14]);
  const int n_split = static_cast<int>(dims[15]);
  const int v_in_k = static_cast<int>(dims[16]);
  const int slots = static_cast<int>(dims[17]);
  const int path = static_cast<int>(dims[18]);
  if (B == 0 || Hq == 0) return 0;
  if (T <= 0 || Hkv <= 0 || Hq % Hkv || D <= 0 || D % 4 || DV <= 0 ||
      DV % 4 || DV > 512 || (v_in_k && DV > D) || ts <= 0 || ts % BK ||
      n_split != (T + ts - 1) / ts || n_split > 8192 ||
      (n_split > 1 && scratch == nullptr) || slots < 2 ||
      slots > MAX_SLOTS || (path != 0 && path != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_part = static_cast<long long>(B) * Hq * n_split * DV;
  Params p{q, k, v, qpos, kpos, scratch,
           scratch != nullptr ? scratch + n_part : nullptr, out,
           dims[6], dims[7], dims[8], dims[9], dims[10], dims[11],
           B, T, Hq, Hkv, Hq / Hkv, 0, D, DV, 0, 0,
           static_cast<int>(dims[12]), static_cast<int>(dims[13]), ts,
           n_split, v_in_k, slots, scale * LOG2E};
  p.runs = (p.g + GMAX - 1) / GMAX;
  const int smem = layout(p, path);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (path == 1) {
    e = allow_smem<decode_mma_kernel>(smem);
    if (e == cudaSuccess) {
      decode_mma_kernel<<<dim3(n_split, Hkv * p.runs, B), NT, smem, st>>>(p);
      e = cudaGetLastError();
    }
  } else {
    const int dvc = DV <= 16 ? 16 : DV <= 32 ? 32 : DV <= 64 ? 64
                  : DV <= 128 ? 128 : DV <= 256 ? 256 : 512;
    switch (dvc) {
      case 16: e = launch_fma<16>(p, smem, st); break;
      case 32: e = launch_fma<32>(p, smem, st); break;
      case 64: e = launch_fma<64>(p, smem, st); break;
      case 128: e = launch_fma<128>(p, smem, st); break;
      case 256: e = launch_fma<256>(p, smem, st); break;
      default: e = launch_fma<512>(p, smem, st); break;
    }
  }
  if (e != cudaSuccess || n_split == 1) return static_cast<int>(e);
  decode_combine_kernel<<<dim3(Hq, B, (DV + CT - 1) / CT), CT,
                          4 * n_split, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
