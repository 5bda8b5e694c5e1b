// Helpers shared by the kernels that stage tiles with cp.async, multiply
// them as 3xTF32 on the tensor cores and need more than 48 KB of dynamic
// shared memory (moe_gmm.cu, ssd.cu, decode_attention.cu).  Header only:
// each source includes it into its own anonymous namespace, after
// <cuda_runtime.h> and <atomic>.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy BYTES (16 or 4) from global to shared memory; zeros when !valid
// (src is then not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned d = smem_u32(dst);
  const int n = valid ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// big = x rounded to TF32, to nearest with ties away (cvt.rna.tf32.f32's
// rounding, as two integer ops: cvt.rna itself compiles to several
// instructions a value on sm_90a, and the split of each operand is what
// keeps a kernel's instruction issue below the tensor cores' rate);
// small = x - big, exact in fp32, whose bits below TF32's the tensor
// cores ignore (CUTLASS's 3xTF32 "fast fp32" split, round_half_ulp_
// truncate and round_toward_zero).  |small| <= 2^-11 |x|, and what the
// tensor cores drop of it is <= 2^-21 |x|.  A NaN stays NaN (in small).
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b, one m16n8k8 TF32 product with an fp32 accumulator.  Lane
// (g, t) = (lane / 4, lane % 4) holds a at (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b at (t, g), (t + 4, g); d at (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 3xTF32 product of one k8 step from fp32 fragments: d += a_small
// b_big + a_big b_small + a_big b_big (a_small b_small, ~2^-22 relative,
// is dropped).  The tensor cores add into d with truncation, so a caller
// keeps d for one stage of k and promotes it into an fp32 sum.
struct Frag8A {
  unsigned big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
};

struct Frag8B {
  unsigned big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, big[0], small[0]);
    split_tf32(b1, big[1], small[1]);
  }
};

__device__ __forceinline__ void mma3(float (&d)[4], const Frag8A& a,
                                     const Frag8B& b) {
  mma(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// Allow KERNEL up to `bytes` of dynamic shared memory (needed above 48 KB).
// The attribute belongs to the kernel on the current device, so it is set
// once per kernel and device, not at every launch (each call costs ~1 us
// of host time); concurrent launchers may both set it, which is harmless.
template <auto KERNEL>
cudaError_t allow_smem(int bytes) {
  constexpr int MAXDEV = 64;
  static std::atomic<int> allowed[MAXDEV];         // zero: nothing set yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAXDEV && allowed[dev].load(std::memory_order_relaxed) >= bytes)
    return cudaSuccess;
  e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < MAXDEV) {
    int seen = allowed[dev].load(std::memory_order_relaxed);
    while (seen < bytes && !allowed[dev].compare_exchange_weak(seen, bytes)) {
    }
  }
  return e;
}
