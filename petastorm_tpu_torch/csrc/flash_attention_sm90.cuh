// Flash attention on Hopper's bf16 tensor cores: the forward kernel (K2), the
// dQ kernel (K3) and the dK/dV kernel (K4) for bfloat16 inputs, included by
// flash_attention.cu, whose entry points take these kernels for bfloat16 and
// keep the fp32 SIMT kernels for float32.
//
// Replaces, for bfloat16, the Pallas kernels of petastorm_tpu/ops/flash_attention.py:
//   K2 _flash_kernel via _flash_forward          (o, lse = attention(q, k, v))
//   K3 _flash_bwd_dq_kernel via _flash_backward  (dq)
//   K4 _flash_bwd_dkv_kernel via _flash_backward (dk, dv)
// with the conventions of flash_attention.cu (scale 1/sqrt(D), causal k <= q,
// packed segments with the query and key rows' ids in separate arrays, o = 0
// and lse = 0 on a row with no valid key).
//
// Bound on this card: the tensor cores. At the LM path's shape (BH 8, T 8192,
// D 128, causal) K2 does 1.4e11 FLOP, K3 2.1e11 and K4 2.7e11 over ~34 MB,
// so 0.14, 0.21 and 0.28 ms at 989 TFLOP/s against ~0.01 ms for the bytes.
//
// Design (wgmma + TMA, one CTA per SM):
//   - 384 threads: two consumer warpgroups (warps 0-7) and a producer
//     warpgroup whose first warp alone works (setmaxnreg gives the consumers
//     232 registers a thread, the producer 40). Its lane 0 streams tiles
//     with TMA through a ring of shared-memory stages (kStages of the
//     kernel's layout), each completed on an mbarrier; the
//     consumers release a stage on an "empty" mbarrier once their wgmma reads
//     of it are done. The producer's other lanes copy the small row vectors a
//     stage needs (segment ids, lse, delta) beside the tiles.
//   - Tiles are bf16 in shared memory, 64 columns (128 bytes) per swizzled
//     row, loaded through a 3-D tensor map over [BH, T, D], so that rows past
//     T read as zeros within their own head. The TMA swizzle (128B) and the
//     wgmma descriptors' layout type agree.
//   - K2: a CTA owns 128 query rows (64 per consumer warpgroup) held in shared
//     memory, and walks 128-key tiles of K and V. S = Q K^T runs as wgmma
//     into fp32 registers; the masks and the online softmax (exp2 of
//     log2e-scaled scores, row max and sum over the four threads that share a
//     row of the accumulator) run in registers; P is rounded to bf16 in
//     registers and is the register A operand of O += P V, with V the
//     MN-major B operand (the transpose bit). Causal tiles above the diagonal
//     are never visited, and the CTAs with the longest walks are numbered
//     first.
//   - K3: a CTA owns 128 query rows (64 per consumer warpgroup), Q and dO
//     resident in shared memory and each row's lse, delta and segment id in
//     registers, and walks 64-key tiles of K and V (a ring of four stages).
//     S = Q K^T and dP = dO V^T run as wgmma; P = exp(S scale - lse) and
//     dS = P (dP - delta) in registers; dQ += dS K takes dS as the bf16
//     register A operand against the MN-major K tile. The walk and its order
//     are K2's; one CTA owns each query tile, so no atomics.
//   - K4: a CTA owns 128 keys (64 per consumer warpgroup, so the dK and dV
//     fp32 accumulators fit in registers), K and V resident in shared memory,
//     and walks 64-row tiles of Q and dO with their lse, delta and segment
//     ids. S^T = K Q^T and dP^T = V dO^T run as wgmma; P^T = exp(S^T scale -
//     lse) and dS^T = P^T (dP^T - delta) in registers; dV += P^T dO and
//     dK += dS^T Q take P^T and dS^T as bf16 register A operands against the
//     MN-major Q and dO tiles. One CTA owns each key tile, so no atomics.
// Numerics: P (K2, K4) and dS (K3, K4) are rounded to bf16 before the
// second product, as in every tensor-core flash kernel; sums stay fp32 (the
// softmax denominator is summed from the unrounded P).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace sm90 {

constexpr int kConsumerWarps = 8;                      // two consumer warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 128;  // and a producer warpgroup
// registers a thread of a producer / consumer warpgroup keeps (setmaxnreg):
// 128 x 40 + 256 x 232 = 384 threads x 168, what the launch holds
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;

template <int D>
__host__ __device__ constexpr float softmax_scale() {
  return D == 64 ? 0.125f : 0.08838834764831845f;  // 1 / sqrt(D)
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// keep the compiler from touching an accumulator while a wgmma owns it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands: rows
// 128 bytes apart, 8-row groups `sbo` = 1024 bytes apart (lbo unused).
// MN-major operands: 8 rows of the K dimension per 1024-byte group (`sbo`),
// 64-column chunks of the MN dimension `lbo` bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A * B^T, A [64 x 16] and B [64 x 16] K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A * B, A [64 x 16] bf16 in registers, B [16 x 64] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= A * B^T, A [64 x 16] and B [128 x 16] K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A * B, A [64 x 16] bf16 in registers, B [16 x 128] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the products above by width N
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, accumulate);
  } else {
    static_assert(N == 128, "wgmma width");
    wgmma_ss_n128(d, a, b, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b);
  } else {
    static_assert(N == 128, "wgmma width");
    wgmma_rs_n128(d, a, b);
  }
}

// The accumulator of an m64nN wgmma: element e of a thread's N / 2 floats
// lies in row 16 * warp + lane / 4 + 8 * acc_half(e) of the warpgroup's 64
// and in column acc_col(e, lane) of the N.
__device__ __forceinline__ int acc_half(int e) { return (e % 4) / 2; }
__device__ __forceinline__ int acc_col(int e, int lane) {
  return (e / 4) * 8 + 2 * (lane % 4) + (e % 2);
}

// An fp32 accumulator of keys (or queries) as the bf16 A operand of the next
// product: k-step kk takes elements 8 kk .. 8 kk + 7, in the register order of
// wgmma's A fragment.
template <int R>
__device__ __forceinline__ void to_a_operand(uint32_t (&a)[R / 8][4], const float (&s)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ------------------------------------------------------------------ K2

template <int D>
struct FwdLayout {
  static constexpr int kM = 128;  // query rows per CTA
  static constexpr int kN = 128;  // keys per tile
  static constexpr int kStages = 2;
  static constexpr int kChunks = D / 64;
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kKVBytes = kN * D * 2;
  static constexpr int q = 0;
  static constexpr int k = q + kQBytes;
  static constexpr int v = k + kStages * kKVBytes;
  static constexpr int kseg = v + kStages * kKVBytes;
  static constexpr int bars = kseg + kStages * kN * 4;
  static constexpr int bytes = bars + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const int* __restrict__ seg,
                 const int* __restrict__ key_seg, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int t, int heads, int causal) {
  using L = FwdLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + L::kStages;
  uint64_t* empty = full_v + L::kStages;
  int* kseg = reinterpret_cast<int*>(smem + L::kseg);

  const int bh = blockIdx.x;
  const int nq = (t + L::kM - 1) / L::kM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * L::kM;  // longest rows first
  const bool segmented = seg != nullptr;
  const int* seg_row = segmented ? seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  const int* key_seg_row = segmented ? key_seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  const int k_end = causal ? min(t, q0 + L::kM) : t;
  const int n_tiles = (k_end + L::kN - 1) / L::kN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: lane 0 of its first warp issues the copies, the warp's lanes
    // copy the segment ids
    set_max_regs_dec<kProducerRegs>();
    if (warp > kConsumerWarps) return;
    if (lane == 0) {
      mbar_expect_tx(full_q, L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(smem + L::q + c * L::kM * kRowBytes, &q_map, full_q, 64 * c, q0, bh);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % L::kStages;
      const int k0 = j * L::kN;
      if (j >= L::kStages) mbar_wait(empty + s, (j / L::kStages - 1) & 1);
      if (segmented) {
        for (int i = lane; i < L::kN; i += 32)
          kseg[s * L::kN + i] = k0 + i < t ? key_seg_row[k0 + i] : 0;
        __threadfence_block();
        __syncwarp();
      }
      if (lane == 0) {
        uint8_t* ks = smem + L::k + s * L::kKVBytes;
        uint8_t* vs = smem + L::v + s * L::kKVBytes;
        mbar_expect_tx(full_k + s, L::kKVBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(ks + c * L::kN * kRowBytes, &k_map, full_k + s, 64 * c, k0, bh);
        mbar_expect_tx(full_v + s, L::kKVBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(vs + c * L::kN * kRowBytes, &v_map, full_v + s, 64 * c, k0, bh);
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread
  // rows `row` and `row` + 8 of them
  set_max_regs_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int row = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  int qseg[2] = {0, 0};
  if (segmented) {
#pragma unroll
    for (int i = 0; i < 2; ++i) qseg[i] = row + 8 * i < t ? seg_row[row + 8 * i] : 0;
  }
  constexpr float scale_log2 = softmax_scale<D>() * kLog2e;
  float acc[D / 2];
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  const uint32_t q_base = smem_u32(smem + L::q) + 64 * wg * kRowBytes;
  mbar_wait(full_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::kStages;
    const uint32_t parity = (j / L::kStages) & 1;
    const int k0 = j * L::kN;

    // S = Q K^T
    float sc[L::kN / 2];
#pragma unroll
    for (int e = 0; e < L::kN / 2; ++e) sc[e] = 0.f;
    const uint32_t k_base = smem_u32(smem + L::k + s * L::kKVBytes);
    mbar_wait(full_k + s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<L::kN>(sc, smem_desc(q_base + (kk / 4) * L::kM * kRowBytes + off, 16, 1024),
                      smem_desc(k_base + (kk / 4) * L::kN * kRowBytes + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // masks and the online softmax, in the log2 domain
    const bool need_mask =
        segmented || k0 + L::kN > t || (causal && k0 + L::kN - 1 > q0 + 64 * wg);
    if (need_mask) {
#pragma unroll
      for (int e = 0; e < L::kN / 2; ++e) {
        const int c = acc_col(e, lane);
        const int r = row + 8 * acc_half(e);
        bool ok = k0 + c < t && (!causal || k0 + c <= r);
        if (segmented) {
          const int ks = kseg[s * L::kN + c];
          ok = ok && ks == qseg[acc_half(e)] && ks > 0;
        }
        sc[e] = ok ? sc[e] * scale_log2 : kMasked;
      }
    } else {
#pragma unroll
      for (int e = 0; e < L::kN / 2; ++e) sc[e] *= scale_log2;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < L::kN / 2; ++e) mx[acc_half(e)] = fmaxf(mx[acc_half(e)], sc[e]);
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = exp2_approx(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int e = 0; e < L::kN / 2; ++e) {
      // a row whose keys are all masked so far keeps mx = kMasked: its p is 0
      const float p = sc[e] > 0.5f * kMasked ? exp2_approx(sc[e] - mx[acc_half(e)]) : 0.f;
      sc[e] = p;
      sum[acc_half(e)] += p;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= corr[acc_half(e)];

    // O += P V, P in registers as bf16
    uint32_t pa[L::kN / 16][4];
    to_a_operand<L::kN / 2>(pa, sc);
    const uint32_t v_base = smem_u32(smem + L::v + s * L::kKVBytes);
    mbar_wait(full_v + s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kN / 16; ++kk) {
      wgmma_rs<D>(acc, pa[kk], smem_desc(v_base + kk * 16 * kRowBytes, L::kN * kRowBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= t) continue;
    const bool nonempty = l[i] > 0.f;
    const float inv = nonempty ? 1.f / l[i] : 0.f;
    __nv_bfloat16* out = o + (static_cast<int64_t>(bh) * t + r) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = 8 * n + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out + c) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    }
    if (lane % 4 == 0)
      lse[static_cast<int64_t>(bh) * t + r] = nonempty ? m[i] * kLn2 + logf(l[i]) : 0.f;
  }
}

// ------------------------------------------------------------------ K3

template <int D>
struct DqLayout {
  static constexpr int kM = 128;  // query rows per CTA
  static constexpr int kN = 64;   // keys per streamed tile
  static constexpr int kStages = 4;
  static constexpr int kChunks = D / 64;
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kKVBytes = kN * D * 2;
  static constexpr int q = 0;
  static constexpr int dout = q + kQBytes;
  static constexpr int k = dout + kQBytes;
  static constexpr int v = k + kStages * kKVBytes;
  static constexpr int kseg = v + kStages * kKVBytes;
  static constexpr int bars = kseg + kStages * kN * 4;
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg,
                    const int* __restrict__ key_seg, __nv_bfloat16* __restrict__ dq, int t,
                    int heads, int causal) {
  using L = DqLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full_qdo = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = full_qdo + 1;  // a stage's K, V and key segment ids
  uint64_t* empty = full + L::kStages;
  int* kseg = reinterpret_cast<int*>(smem + L::kseg);

  const int bh = blockIdx.x;
  const int nq = (t + L::kM - 1) / L::kM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * L::kM;  // longest rows first
  const bool segmented = seg != nullptr;
  const int* seg_row = segmented ? seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  const int* key_seg_row = segmented ? key_seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  const int k_end = causal ? min(t, q0 + L::kM) : t;
  const int n_tiles = (k_end + L::kN - 1) / L::kN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_qdo, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    set_max_regs_dec<kProducerRegs>();
    if (warp > kConsumerWarps) return;
    if (lane == 0) {
      mbar_expect_tx(full_qdo, 2 * L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load(smem + L::q + c * L::kM * kRowBytes, &q_map, full_qdo, 64 * c, q0, bh);
        tma_load(smem + L::dout + c * L::kM * kRowBytes, &do_map, full_qdo, 64 * c, q0, bh);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % L::kStages;
      const int k0 = j * L::kN;
      if (j >= L::kStages) mbar_wait(empty + s, (j / L::kStages - 1) & 1);
      if (segmented) {
        for (int i = lane; i < L::kN; i += 32)
          kseg[s * L::kN + i] = k0 + i < t ? key_seg_row[k0 + i] : 0;
        __threadfence_block();
        __syncwarp();
      }
      if (lane == 0) {
        uint8_t* ks = smem + L::k + s * L::kKVBytes;
        uint8_t* vs = smem + L::v + s * L::kKVBytes;
        mbar_expect_tx(full + s, 2 * L::kKVBytes);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(ks + c * L::kN * kRowBytes, &k_map, full + s, 64 * c, k0, bh);
          tma_load(vs + c * L::kN * kRowBytes, &v_map, full + s, 64 * c, k0, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread
  // rows `row` and `row` + 8 of them, with their lse (log2 domain), delta and
  // segment id in registers
  set_max_regs_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int row = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int64_t row_base = static_cast<int64_t>(bh) * t;
  float lse2[2], dlt[2];
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row + 8 * i < t;
    lse2[i] = in ? lse[row_base + row + 8 * i] * kLog2e : 0.f;
    dlt[i] = in ? delta[row_base + row + 8 * i] : 0.f;
    qseg[i] = in && segmented ? seg_row[row + 8 * i] : 0;
  }
  constexpr float scale = softmax_scale<D>();
  constexpr float scale_log2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  const uint32_t q_base = smem_u32(smem + L::q) + 64 * wg * kRowBytes;
  const uint32_t do_base = smem_u32(smem + L::dout) + 64 * wg * kRowBytes;
  // rows past t hold zeros and lse 0, so their P must be masked too
  const bool rows_ragged = q0 + 64 * wg + 64 > t;
  mbar_wait(full_qdo, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::kStages;
    const uint32_t parity = (j / L::kStages) & 1;
    const int k0 = j * L::kN;
    const uint32_t k_base = smem_u32(smem + L::k + s * L::kKVBytes);
    const uint32_t v_base = smem_u32(smem + L::v + s * L::kKVBytes);

    // S = Q K^T and dP = dO V^T
    float sc[L::kN / 2], dp[L::kN / 2];
#pragma unroll
    for (int e = 0; e < L::kN / 2; ++e) {
      sc[e] = 0.f;
      dp[e] = 0.f;
    }
    mbar_wait(full + s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<L::kN>(sc, smem_desc(q_base + (kk / 4) * L::kM * kRowBytes + off, 16, 1024),
                      smem_desc(k_base + (kk / 4) * L::kN * kRowBytes + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<L::kN>(dp, smem_desc(do_base + (kk / 4) * L::kM * kRowBytes + off, 16, 1024),
                      smem_desc(v_base + (kk / 4) * L::kN * kRowBytes + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp(S scale - lse), masked to 0, and dS = P (dP - delta), each pair
    // of elements packed to bf16 as soon as it is made
    const bool need_mask = segmented || rows_ragged || k0 + L::kN > t ||
                           (causal && k0 + L::kN - 1 > q0 + 64 * wg);
    uint32_t da[L::kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < L::kN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float ds[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 8 * kk + 2 * r + h;
          const int c = acc_col(e, lane);  // key k0 + c
          const int i = acc_half(e);       // query row `row` + 8 i
          float p = exp2_approx(sc[e] * scale_log2 - lse2[i]);
          if (need_mask) {
            const int qr = row + 8 * i;
            bool ok = qr < t && k0 + c < t && (!causal || k0 + c <= qr);
            if (segmented) {
              const int ks = kseg[s * L::kN + c];
              ok = ok && ks == qseg[i] && ks > 0;
            }
            p = ok ? p : 0.f;
          }
          ds[h] = p * (dp[e] - dlt[i]);
        }
        da[kk][r] = pack_bf16(ds[0], ds[1]);
      }
    }

    // dQ += dS K, dS in registers as bf16, K the MN-major B operand
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kN / 16; ++kk) {
      wgmma_rs<D>(acc, da[kk], smem_desc(k_base + kk * 16 * kRowBytes, L::kN * kRowBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= t) continue;
    __nv_bfloat16* out = dq + (row_base + r) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = 8 * n + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out + c) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * scale, acc[4 * n + 2 * i + 1] * scale);
    }
  }
}

// ------------------------------------------------------------------ K4

template <int D>
struct DkvLayout {
  static constexpr int kN = 128;  // keys per CTA
  static constexpr int kM = 64;   // query rows per streamed tile
  static constexpr int kStages = 4;
  static constexpr int kChunks = D / 64;
  static constexpr int kKVBytes = kN * D * 2;
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int k = 0;
  static constexpr int v = k + kKVBytes;
  static constexpr int q = v + kKVBytes;
  static constexpr int dout = q + kStages * kQBytes;
  static constexpr int rows = dout + kStages * kQBytes;  // [stage][lse2, delta, qseg][kM]
  static constexpr int bars = rows + kStages * 3 * kM * 4;
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ seg,
                     const int* __restrict__ key_seg, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int t, int heads, int causal) {
  using L = DkvLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = full_kv + 1;  // a stage's Q, dO and row vectors
  uint64_t* empty = full + L::kStages;
  float* rows = reinterpret_cast<float*>(smem + L::rows);

  const int bh = blockIdx.x;
  // causal: key tile 0 meets every query tile, so low tiles (the most loaded) start first
  const int k0 = static_cast<int>(blockIdx.y) * L::kN;
  const bool segmented = seg != nullptr;
  const int* seg_row = segmented ? seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  const int* key_seg_row = segmented ? key_seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  // query tiles wholly above the diagonal (every q < k0) contribute nothing
  const int q_start = causal ? k0 : 0;
  const int n_tiles = (t - q_start + L::kM - 1) / L::kM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    set_max_regs_dec<kProducerRegs>();
    if (warp > kConsumerWarps) return;
    if (lane == 0) {
      mbar_expect_tx(full_kv, 2 * L::kKVBytes);
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load(smem + L::k + c * L::kN * kRowBytes, &k_map, full_kv, 64 * c, k0, bh);
        tma_load(smem + L::v + c * L::kN * kRowBytes, &v_map, full_kv, 64 * c, k0, bh);
      }
    }
    const int64_t row_base = static_cast<int64_t>(bh) * t;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % L::kStages;
      const int q0 = q_start + j * L::kM;
      if (j >= L::kStages) mbar_wait(empty + s, (j / L::kStages - 1) & 1);
      float* stage_rows = rows + s * 3 * L::kM;
      for (int i = lane; i < L::kM; i += 32) {
        const bool in = q0 + i < t;
        stage_rows[i] = in ? lse[row_base + q0 + i] * kLog2e : 0.f;
        stage_rows[L::kM + i] = in ? delta[row_base + q0 + i] : 0.f;
        reinterpret_cast<int*>(stage_rows)[2 * L::kM + i] = in && segmented ? seg_row[q0 + i] : 0;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) {
        uint8_t* qs = smem + L::q + s * L::kQBytes;
        uint8_t* dos = smem + L::dout + s * L::kQBytes;
        mbar_expect_tx(full + s, 2 * L::kQBytes);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(qs + c * L::kM * kRowBytes, &q_map, full + s, 64 * c, q0, bh);
          tma_load(dos + c * L::kM * kRowBytes, &do_map, full + s, 64 * c, q0, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns keys k0 + 64 wg .. + 63; this thread keys
  // `key` and `key` + 8 of them (rows of the transposed products)
  set_max_regs_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int key = k0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  int kseg[2] = {0, 0};
  if (segmented) {
#pragma unroll
    for (int i = 0; i < 2; ++i) kseg[i] = key + 8 * i < t ? key_seg_row[key + 8 * i] : 0;
  }
  constexpr float scale = softmax_scale<D>();
  constexpr float scale_log2 = scale * kLog2e;
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) {
    acc_dk[e] = 0.f;
    acc_dv[e] = 0.f;
  }

  const uint32_t k_base = smem_u32(smem + L::k) + 64 * wg * kRowBytes;
  const uint32_t v_base = smem_u32(smem + L::v) + 64 * wg * kRowBytes;
  mbar_wait(full_kv, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::kStages;
    const uint32_t parity = (j / L::kStages) & 1;
    const int q0 = q_start + j * L::kM;
    const uint32_t q_base = smem_u32(smem + L::q + s * L::kQBytes);
    const uint32_t do_base = smem_u32(smem + L::dout + s * L::kQBytes);
    const float* stage_rows = rows + s * 3 * L::kM;

    // S^T = K Q^T and dP^T = V dO^T
    float st[L::kM / 2], dpt[L::kM / 2];
#pragma unroll
    for (int e = 0; e < L::kM / 2; ++e) {
      st[e] = 0.f;
      dpt[e] = 0.f;
    }
    mbar_wait(full + s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<L::kM>(st, smem_desc(k_base + (kk / 4) * L::kN * kRowBytes + off, 16, 1024),
                      smem_desc(q_base + (kk / 4) * L::kM * kRowBytes + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<L::kM>(dpt, smem_desc(v_base + (kk / 4) * L::kN * kRowBytes + off, 16, 1024),
                      smem_desc(do_base + (kk / 4) * L::kM * kRowBytes + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(S^T scale - lse), masked to 0, and dS^T = P^T (dP^T - delta),
    // each pair of elements packed to bf16 as soon as it is made, so the
    // fp32 tiles die as the A operands of the next products grow
    const bool need_mask = segmented || q0 + L::kM > t || k0 + L::kN > t ||
                           (causal && k0 + 64 * wg + 63 > q0);
    uint32_t pa[L::kM / 16][4], da[L::kM / 16][4];
#pragma unroll
    for (int kk = 0; kk < L::kM / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p[2], ds[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 8 * kk + 2 * r + h;
          const int c = acc_col(e, lane);  // query row q0 + c
          p[h] = exp2_approx(st[e] * scale_log2 - stage_rows[c]);
          if (need_mask) {
            const int kr = key + 8 * acc_half(e);
            bool ok = q0 + c < t && kr < t && (!causal || kr <= q0 + c);
            if (segmented) {
              const int qs = reinterpret_cast<const int*>(stage_rows)[2 * L::kM + c];
              ok = ok && qs == kseg[acc_half(e)] && qs > 0;
            }
            p[h] = ok ? p[h] : 0.f;
          }
          ds[h] = p[h] * (dpt[e] - stage_rows[L::kM + c]);
        }
        pa[kk][r] = pack_bf16(p[0], p[1]);
        da[kk][r] = pack_bf16(ds[0], ds[1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T in registers as bf16
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kM / 16; ++kk) {
      wgmma_rs<D>(acc_dv, pa[kk],
                  smem_desc(do_base + kk * 16 * kRowBytes, L::kM * kRowBytes, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < L::kM / 16; ++kk) {
      wgmma_rs<D>(acc_dk, da[kk],
                  smem_desc(q_base + kk * 16 * kRowBytes, L::kM * kRowBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = key + 8 * i;
    if (r >= t) continue;
    const int64_t at = (static_cast<int64_t>(bh) * t + r) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = 8 * n + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(dk + at + c) = __floats2bfloat162_rn(
          acc_dk[4 * n + 2 * i] * scale, acc_dk[4 * n + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + c) =
          __floats2bfloat162_rn(acc_dv[4 * n + 2 * i], acc_dv[4 * n + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded (the library is not linked against it)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a [bh, t, d] bf16 tensor in boxes of `rows` rows x 64 columns, 128-byte
// swizzled; rows past t (within a head) read as zeros
inline bool tile_map(CUtensorMap* map, const void* base, int bh, int t, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(t) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg, const void* key_seg,
               void* o, void* lse, int bh, int t, int heads, int causal, cudaStream_t stream) {
  using L = FwdLayout<D>;
  CUtensorMap q_map, k_map, v_map;
  if (!tile_map(&q_map, q, bh, t, D, L::kM) || !tile_map(&k_map, k, bh, t, D, L::kN) ||
      !tile_map(&v_map, v, bh, t, D, L::kN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int status = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes));
  if (status != 0) return status;
  const dim3 grid(bh, (t + L::kM - 1) / L::kM);
  flash_fwd_kernel<D><<<grid, kThreads, L::bytes, stream>>>(
      q_map, k_map, v_map, static_cast<const int*>(seg), static_cast<const int*>(key_seg),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), t, heads, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* seg, const void* key_seg, void* dq, int bh, int t,
              int heads, int causal, cudaStream_t stream) {
  using L = DqLayout<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!tile_map(&q_map, q, bh, t, D, L::kM) || !tile_map(&k_map, k, bh, t, D, L::kN) ||
      !tile_map(&v_map, v, bh, t, D, L::kN) || !tile_map(&do_map, dout, bh, t, D, L::kM))
    return static_cast<int>(cudaErrorInvalidValue);
  const int status = static_cast<int>(cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes));
  if (status != 0) return status;
  const dim3 grid(bh, (t + L::kM - 1) / L::kM);
  flash_bwd_dq_kernel<D><<<grid, kThreads, L::bytes, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg),
      static_cast<const int*>(key_seg), static_cast<__nv_bfloat16*>(dq), t, heads, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* seg, const void* key_seg, void* dk, void* dv, int bh,
               int t, int heads, int causal, cudaStream_t stream) {
  using L = DkvLayout<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!tile_map(&q_map, q, bh, t, D, L::kM) || !tile_map(&k_map, k, bh, t, D, L::kN) ||
      !tile_map(&v_map, v, bh, t, D, L::kN) || !tile_map(&do_map, dout, bh, t, D, L::kM))
    return static_cast<int>(cudaErrorInvalidValue);
  const int status = static_cast<int>(cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes));
  if (status != 0) return status;
  const dim3 grid(bh, (t + L::kN - 1) / L::kN);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, L::bytes, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg),
      static_cast<const int*>(key_seg), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), t, heads, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
