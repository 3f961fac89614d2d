// Flash attention for Hopper (sm_90a): the forward kernel (K2) and the two
// backward kernels (K3: dQ, K4: dK/dV) over [BH, T, D] tensors.
//
// Replaces the Pallas kernels of petastorm_tpu/ops/flash_attention.py:
//   K2 _flash_kernel via _flash_forward          (o, lse = attention(q, k, v))
//   K3 _flash_bwd_dq_kernel via _flash_backward  (dq)
//   K4 _flash_bwd_dkv_kernel via _flash_backward (dk, dv)
// They compute the same functions, with the same conventions:
//   - scores s = q.k / sqrt(D), causal mask k <= q, optional packed-segment
//     mask (same segment and both ids > 0; segments[b, t] is shared by the
//     heads of batch row b = bh / heads; the query rows' ids and the key
//     rows' come in separate arrays, the same one for self-attention);
//   - a row with no valid key (padding) gets o = 0 and lse = 0, so the
//     backward's replay exp(s - lse) is masked to 0, never NaN;
//   - the backward replays P = exp(s - lse) and dS = P * (dO.V^T - delta),
//     with delta = rowsum(dO * O) computed by the caller.
//
// Bound on this card: compute. At the LM path's shape (BH = 8, T = 8192,
// D = 128, causal) K2 does 2 products over the T(T+1)/2 valid pairs
// (~1.4e11 FLOP), K3 3 products and K4 4, while each moves ~34 MB; at the
// tensor cores' 989 TFLOP/s bf16 the least times are ~0.14, 0.21 and 0.28 ms,
// far above the ~0.01 ms the bytes need at 3.35 TB/s.
//
// bfloat16 inputs take the tensor-core kernels of flash_attention_sm90.cuh
// for all three (wgmma with TMA-fed shared-memory rings; see that file).
// The kernels below serve float32 inputs.
//
// Design of the kernels below, simple and right first: fp32 SIMT arithmetic
// (no tensor cores), so they can reach at most the 67 TFLOP/s of the FP32
// pipes. The TPU kernels carry the online-softmax
// state across a sequential grid axis in VMEM scratch; here that axis is a
// loop inside one CTA:
//   - K2 and K3: one CTA per (bh, 64-row q tile), looping over 64-row k tiles;
//   - K4: one CTA per (bh, 64-row k tile), looping over q tiles, so dK/dV need
//     no atomics and K3 owns dQ alone.
// Tiles are staged in shared memory as fp32 (row stride D + 1, so the 16
// threads reading 16 different rows hit 16 different banks); the running
// max, denominator and accumulators live in fp32 registers. 256 threads form
// a 16 x 16 grid; thread (ty, tx) owns tile rows ty + 16 i (i < 4) and
// columns tx + 16 j, so a row's 16 threads are one half-warp and row
// reductions are 4 shuffles. Causal tiles wholly above the diagonal are never
// visited, and CTAs are numbered so the most loaded causal tiles start first.
// T need not be a multiple of 64: the ragged tail is loaded as zeros and
// masked. Head dims 64 and 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kTile = 64;      // rows of a q or k tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kLanes = 16;     // threads sharing one tile row
constexpr int kRows = kTile / kLanes;  // tile rows per thread
constexpr int kPStride = kTile + 1;    // row stride of a score tile in smem
constexpr float kNegInf = -1e30f;

template <int D>
__host__ __device__ constexpr int tile_floats() { return kTile * (D + 1); }

// rows [row0, row0 + 64) of a [t, D] matrix -> smem (stride D + 1) as fp32,
// zeros past row t
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int t) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < t ? src[static_cast<int64_t>(row) * D + c] : 0.f;
  }
}

template <typename V>
__device__ __forceinline__ void load_rows(V* dst, const V* src, int row0, int t, V fill) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    dst[r] = row0 + r < t ? src[row0 + r] : fill;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] (both smem, stride D + 1)
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[kRows][kRows], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kRows; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[kRows], bv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[(ty + kLanes * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kRows; ++j) bv[j] = b[(tx + kLanes * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// two products of the same index pattern in one pass over d:
// s = a1 . b1^T and u = a2 . b2^T
template <int D>
__device__ __forceinline__ void dot_tile2(float (&s)[kRows][kRows], const float* a1,
                                          const float* b1, float (&u)[kRows][kRows],
                                          const float* a2, const float* b2, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      s[i][j] = 0.f;
      u[i][j] = 0.f;
    }
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float av[kRows], bv[kRows], cv[kRows], ev[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      av[i] = a1[(ty + kLanes * i) * (D + 1) + d];
      cv[i] = a2[(ty + kLanes * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      bv[j] = b1[(tx + kLanes * j) * (D + 1) + d];
      ev[j] = b2[(tx + kLanes * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        u[i][j] = fmaf(cv[i], ev[j], u[i][j]);
      }
  }
}

// acc[i][j] += sum_kk p[ty + 16 i][kk] * b[kk][tx + 16 j]
// (p: a 64 x 64 score tile, stride 65; b: a tile of stride D + 1)
template <int D>
__device__ __forceinline__ void acc_tile(float (&acc)[kRows][D / kLanes], const float* p,
                                         const float* b, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kTile; ++kk) {
    float pv[kRows], bv[D / kLanes];
#pragma unroll
    for (int i = 0; i < kRows; ++i) pv[i] = p[(ty + kLanes * i) * kPStride + kk];
#pragma unroll
    for (int j = 0; j < D / kLanes; ++j) bv[j] = b[kk * (D + 1) + tx + kLanes * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < D / kLanes; ++j) acc[i][j] = fmaf(pv[i], bv[j], acc[i][j]);
  }
}

// the score (qi, kj) attends: in range, causal, same non-padding segment
__device__ __forceinline__ bool attends(int qi, int kj, int t, int causal, bool segmented,
                                        int qseg, int kseg) {
  return kj < t && qi < t && (!causal || kj <= qi) &&
         (!segmented || (qseg == kseg && qseg > 0));
}

// ------------------------------------------------------------------ K2

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 const int* __restrict__ key_seg, float* __restrict__ o,
                 float* __restrict__ lse, int t, int heads, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* kv = qs + tile_floats<D>();  // K, then V, of the current k tile
  float* ps = kv + tile_floats<D>();
  int* qseg = reinterpret_cast<int*>(ps + kTile * kPStride);
  int* kseg = qseg + kTile;

  const int nq = (t + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTile;  // longest rows first
  const int bh = blockIdx.y;
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int64_t base = static_cast<int64_t>(bh) * t * D;
  const bool segmented = seg != nullptr;
  const int* seg_row = segmented ? seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  const int* key_seg_row = segmented ? key_seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  const float scale = rsqrtf(static_cast<float>(D));

  load_tile<D>(qs, q + base, q0, t);
  if (segmented) load_rows<int>(qseg, seg_row, q0, t, 0);

  float m[kRows], l[kRows], acc[kRows][D / kLanes];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / kLanes; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(t, q0 + kTile) : t;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers of kv, ps and kseg are done
    load_tile<D>(kv, k + base, k0, t);
    if (segmented) load_rows<int>(kseg, key_seg_row, k0, t, 0);
    __syncthreads();
    float s[kRows][kRows];
    dot_tile<D>(s, qs, kv, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kLanes * i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kLanes * j;
        const bool ok = attends(q0 + r, k0 + c, t, causal, segmented,
                                segmented ? qseg[r] : 0, segmented ? kseg[c] : 0);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float p = s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
        ps[r * kPStride + tx + kLanes * j] = p;
        row_sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / kLanes; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // ps complete; everyone is done reading K
    load_tile<D>(kv, v + base, k0, t);
    __syncthreads();
    acc_tile<D>(acc, ps, kv, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kLanes * i;
    if (row >= t) continue;
    const bool nonempty = l[i] > 0.f;
    const float inv = nonempty ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < D / kLanes; ++j) {
      o[base + static_cast<int64_t>(row) * D + tx + kLanes * j] = acc[i][j] * inv;
    }
    if (tx == 0) lse[static_cast<int64_t>(bh) * t + row] = nonempty ? m[i] + logf(l[i]) : 0.f;
  }
}

// ------------------------------------------------------------------ K3

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg,
                    const int* __restrict__ key_seg, float* __restrict__ dq, int t, int heads,
                    int causal) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + tile_floats<D>();
  float* ks = dos + tile_floats<D>();
  float* vs = ks + tile_floats<D>();
  float* dss = vs + tile_floats<D>();
  float* lse_s = dss + kTile * kPStride;
  float* delta_s = lse_s + kTile;
  int* qseg = reinterpret_cast<int*>(delta_s + kTile);
  int* kseg = qseg + kTile;

  const int nq = (t + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int64_t base = static_cast<int64_t>(bh) * t * D;
  const int64_t row_base = static_cast<int64_t>(bh) * t;
  const bool segmented = seg != nullptr;
  const int* seg_row = segmented ? seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  const int* key_seg_row = segmented ? key_seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  const float scale = rsqrtf(static_cast<float>(D));

  load_tile<D>(qs, q + base, q0, t);
  load_tile<D>(dos, dout + base, q0, t);
  load_rows<float>(lse_s, lse + row_base, q0, t, 0.f);
  load_rows<float>(delta_s, delta + row_base, q0, t, 0.f);
  if (segmented) load_rows<int>(qseg, seg_row, q0, t, 0);

  float acc[kRows][D / kLanes];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < D / kLanes; ++j) acc[i][j] = 0.f;

  const int k_end = causal ? min(t, q0 + kTile) : t;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<D>(ks, k + base, k0, t);
    load_tile<D>(vs, v + base, k0, t);
    if (segmented) load_rows<int>(kseg, key_seg_row, k0, t, 0);
    __syncthreads();
    float s[kRows][kRows], dp[kRows][kRows];
    dot_tile2<D>(s, qs, ks, dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kLanes * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kLanes * j;
        const bool ok = attends(q0 + r, k0 + c, t, causal, segmented,
                                segmented ? qseg[r] : 0, segmented ? kseg[c] : 0);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dss[r * kPStride + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    acc_tile<D>(acc, dss, ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kLanes * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < D / kLanes; ++j) {
      dq[base + static_cast<int64_t>(row) * D + tx + kLanes * j] = acc[i][j] * scale;
    }
  }
}

// ------------------------------------------------------------------ K4

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ seg,
                     const int* __restrict__ key_seg, float* __restrict__ dk,
                     float* __restrict__ dv, int t, int heads, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + tile_floats<D>();
  float* qs = vs + tile_floats<D>();
  float* dos = qs + tile_floats<D>();
  float* pts = dos + tile_floats<D>();   // P^T of the tile: key rows, query columns
  float* dsts = pts + kTile * kPStride;  // dS^T of the tile
  float* lse_s = dsts + kTile * kPStride;
  float* delta_s = lse_s + kTile;
  int* qseg = reinterpret_cast<int*>(delta_s + kTile);
  int* kseg = qseg + kTile;

  const int nq = (t + kTile - 1) / kTile;
  // causal: k tile 0 meets every q tile, so low tiles (the most loaded) start first
  const int k0 = static_cast<int>(blockIdx.x) * kTile;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int64_t base = static_cast<int64_t>(bh) * t * D;
  const int64_t row_base = static_cast<int64_t>(bh) * t;
  const bool segmented = seg != nullptr;
  const int* seg_row = segmented ? seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  const int* key_seg_row = segmented ? key_seg + static_cast<int64_t>(bh / heads) * t : nullptr;
  const float scale = rsqrtf(static_cast<float>(D));

  load_tile<D>(ks, k + base, k0, t);
  load_tile<D>(vs, v + base, k0, t);
  if (segmented) load_rows<int>(kseg, key_seg_row, k0, t, 0);

  float acc_dk[kRows][D / kLanes], acc_dv[kRows][D / kLanes];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < D / kLanes; ++j) {
      acc_dk[i][j] = 0.f;
      acc_dv[i][j] = 0.f;
    }

  // q tiles wholly above the diagonal (every q < k0) contribute nothing
  for (int q0 = causal ? k0 : 0; q0 < nq * kTile; q0 += kTile) {
    __syncthreads();
    load_tile<D>(qs, q + base, q0, t);
    load_tile<D>(dos, dout + base, q0, t);
    load_rows<float>(lse_s, lse + row_base, q0, t, 0.f);
    load_rows<float>(delta_s, delta + row_base, q0, t, 0.f);
    if (segmented) load_rows<int>(qseg, seg_row, q0, t, 0);
    __syncthreads();
    float st[kRows][kRows], dpt[kRows][kRows];
    dot_tile2<D>(st, ks, qs, dpt, vs, dos, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kLanes * i;  // key row of the tile
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kLanes * j;  // query column of the tile
        const bool ok = attends(q0 + c, k0 + r, t, causal, segmented,
                                segmented ? qseg[c] : 0, segmented ? kseg[r] : 0);
        const float p = ok ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
        pts[r * kPStride + c] = p;
        dsts[r * kPStride + c] = p * (dpt[i][j] - delta_s[c]);
      }
    }
    __syncthreads();
    acc_tile<D>(acc_dv, pts, dos, ty, tx);
    acc_tile<D>(acc_dk, dsts, qs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + ty + kLanes * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < D / kLanes; ++j) {
      const int64_t at = base + static_cast<int64_t>(row) * D + tx + kLanes * j;
      dk[at] = acc_dk[i][j] * scale;
      dv[at] = acc_dv[i][j];
    }
  }
}

// ------------------------------------------------------------------ launch

template <int D>
constexpr size_t fwd_smem() {
  return (2 * tile_floats<D>() + kTile * kPStride) * sizeof(float) + 2 * kTile * sizeof(int);
}

template <int D>
constexpr size_t dq_smem() {
  return (4 * tile_floats<D>() + kTile * kPStride + 2 * kTile) * sizeof(float) +
         2 * kTile * sizeof(int);
}

template <int D>
constexpr size_t dkv_smem() {
  return (4 * tile_floats<D>() + 2 * kTile * kPStride + 2 * kTile) * sizeof(float) +
         2 * kTile * sizeof(int);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg,
               const void* key_seg, void* o, void* lse, int bh, int t, int heads, int causal,
               cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  const int status = prepare(flash_fwd_kernel<D>, smem);
  if (status != 0) return status;
  const dim3 grid((t + kTile - 1) / kTile, bh);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<const int*>(key_seg), static_cast<float*>(o),
      static_cast<float*>(lse), t, heads, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* seg, const void* key_seg, void* dq, int bh, int t,
              int heads, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  const int status = prepare(flash_bwd_dq_kernel<D>, smem);
  if (status != 0) return status;
  const dim3 grid((t + kTile - 1) / kTile, bh);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg),
      static_cast<const int*>(key_seg), static_cast<float*>(dq), t, heads, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* seg, const void* key_seg, void* dk, void* dv, int bh,
               int t, int heads, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  const int status = prepare(flash_bwd_dkv_kernel<D>, smem);
  if (status != 0) return status;
  const dim3 grid((t + kTile - 1) / kTile, bh);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg),
      static_cast<const int*>(key_seg), static_cast<float*>(dk), static_cast<float*>(dv), t,
      heads, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches one kernel on
// `stream` and returns a cudaError_t (0 on success). All tensors are device
// pointers to contiguous arrays: q, k, v, dout, o, dq, dk, dv [bh, t, d] of
// `dtype` (0 = float32, 1 = bfloat16); lse and delta [bh, t] float32; seg
// null or [bh / heads, t] int32, the query rows' segment ids, and key_seg the
// key rows' of the same shape (seg itself for self-attention; null with seg,
// a ring's block pairs the local queries with another shard's keys). d must
// be 64 or 128; anything else returns cudaErrorInvalidValue without launching. The bfloat16 kernels also return
// cudaErrorInvalidValue when a TMA tensor map cannot be made (an input not
// 16-byte aligned). The Python wrappers check shapes, types and devices
// before they call.

#define FLASH_DISPATCH(F32, BF16)                                      \
  if (bh <= 0 || t <= 0) return static_cast<int>(cudaSuccess);          \
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue); \
  if (dtype == 0) return d == 64 ? F32(64) : F32(128);                   \
  if (dtype == 1) return d == 64 ? BF16(64) : BF16(128);                 \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                         const void* key_seg, void* o, void* lse, int bh, int t, int d,
                         int heads, int causal, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F32(D) launch_fwd<D>(q, k, v, seg, key_seg, o, lse, bh, t, heads, causal, s)
#define BF16(D) sm90::launch_fwd<D>(q, k, v, seg, key_seg, o, lse, bh, t, heads, causal, s)
  FLASH_DISPATCH(F32, BF16)
#undef F32
#undef BF16
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* seg,
                            const void* key_seg, void* dq, int bh, int t, int d, int heads,
                            int causal, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F32(D) launch_dq<D>(q, k, v, dout, lse, delta, seg, key_seg, dq, bh, t, heads, causal, s)
#define BF16(D) \
  sm90::launch_dq<D>(q, k, v, dout, lse, delta, seg, key_seg, dq, bh, t, heads, causal, s)
  FLASH_DISPATCH(F32, BF16)
#undef F32
#undef BF16
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* seg,
                             const void* key_seg, void* dk, void* dv, int bh, int t, int d,
                             int heads, int causal, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F32(D) \
  launch_dkv<D>(q, k, v, dout, lse, delta, seg, key_seg, dk, dv, bh, t, heads, causal, s)
#define BF16(D) \
  sm90::launch_dkv<D>(q, k, v, dout, lse, delta, seg, key_seg, dk, dv, bh, t, heads, causal, s)
  FLASH_DISPATCH(F32, BF16)
#undef F32
#undef BF16
}
