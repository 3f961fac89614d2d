// Batch norm for Hopper (sm_90a): flax's nn.BatchNorm(momentum=0.9,
// epsilon=1e-5, float32) over the channels-last bfloat16 output of a
// convolution, in training (batch statistics, running averages updated) and in
// evaluation (running statistics), with what follows it in a ResNet bottleneck
// folded into the same pass: a ReLU, a float32 shortcut added before the ReLU,
// or a second batch-normalised bfloat16 input (a projected shortcut).
//
// Replaces no TPU kernel: the JAX package leaves nn.BatchNorm to XLA, which
// fuses it. It was added because the port ran the same float32 chain as
// separate PyTorch operators (a cast, x * x, two means, a subtract, a multiply,
// an add, then the ReLU, the shortcut's add and the next convolution's cast),
// each a pass over the activations in PyTorch's generic kernels, about twice as
// many again in autograd's backward.
//
// Layout. An [N, C, H, W] tensor in channels-last memory is the row-major
// matrix [M = N*H*W, C]: a channel is a column, and every pass here streams the
// matrix row by row.
//
// Bound: memory. A pass does a few float operations per element, against a card
// that needs about 300 per byte before arithmetic could limit it. The forward
// must read its inputs and write its output once; the backward must read dy and
// the saved inputs and write dx once. The passes here read x twice in each
// direction (the statistics and the backward's two sums need all rows before
// any output element is known), so at one ReLU'd bf16 batch norm they move 16
// bytes an element where the bound counts 10.
//
// Design.
// - A thread owns 8 channels (one 16-byte load of bf16) of every row it
//   visits. A block of 256 threads is min(C/8, 256) threads across the
//   channels times the rest across rows, so a warp reads whole 16-byte words
//   of consecutive rows, coalesced, for any C that is a multiple of 8; rows
//   wider than 2048 channels take more blocks along y.
// - The statistics pass and the backward's reduction keep float32 sums in
//   registers over a fixed set of rows, fold them across the block's rows in
//   shared memory, and write one row of partial sums a block; a finalisation
//   kernel adds those rows in a fixed order and computes the per-channel
//   constants (and updates the running averages). No float atomics: the same
//   input gives the same bits on every run of one card (the number of partial
//   rows follows the card's SM count, which the caller passes).
// - The apply passes hold each thread's per-channel constants in registers and
//   issue the loads of several rows before the first store.
// - The arithmetic that decides a ReLU is written with _rn intrinsics, so no
//   contraction into a fused multiply-add can change it: the backward
//   recomputes the forward's pre-activation bit for bit from the saved bf16
//   inputs and takes the ReLU's mask from it, so no float32 copy of the output
//   is kept. It is also the arithmetic of the PyTorch expression it replaces:
//   (x - mean) * (rsqrt(var + eps) * weight) + bias, each step rounded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;   // channels a thread owns: one 16-byte word of bf16
constexpr int kSplit = 8; // threads along the partial rows in a finalisation block

// modes: what follows the normalisation
constexpr int kPlain = 0;       // nothing
constexpr int kRelu = 1;        // relu(bn(x))
constexpr int kAddRelu = 2;     // relu(res + bn(x)), res float32
constexpr int kNormAddRelu = 3; // relu(bn2(x2) + bn(x))

// ------------------------------------------------------------------ elements

__device__ __forceinline__ void unpack(uint4 u, float f[kVec]) {
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
  f[4] = __uint_as_float(u.z << 16);
  f[5] = __uint_as_float(u.z & 0xffff0000u);
  f[6] = __uint_as_float(u.w << 16);
  f[7] = __uint_as_float(u.w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 8 values from 16 bytes of bf16 or 32 bytes of float32
struct Load8 {
  __device__ __forceinline__ static void from(const __nv_bfloat16* p, float f[kVec]) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
  }
  __device__ __forceinline__ static void from(const float* p, float f[kVec]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float f[kVec]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ void store8(float* p, const float f[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// (x - mean) * scale + bias, each step rounded, as the PyTorch chain computes it
__device__ __forceinline__ float normalize(float x, float mean, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), scale), bias);
}

// torch.relu: NaN and -0.0 pass through
__device__ __forceinline__ float relu(float z) { return z < 0.f ? 0.f : z; }

// the per-channel constants of the 8 channels at c0: stats is [4, C] (mean,
// rstd, scale = rstd * weight, 1 where the batch variance was not clamped)
struct Channels {
  float mean[kVec], rstd[kVec], scale[kVec], bias[kVec];
  __device__ __forceinline__ void load(const float* stats, const float* b, int c, int c0) {
    Load8::from(stats + c0, mean);
    Load8::from(stats + c + c0, rstd);
    Load8::from(stats + 2 * c + c0, scale);
    Load8::from(b + c0, bias);
  }
};

// the block's thread layout: min(C/8, 256) across the channels, the rest
// across rows; the vector (8 channels) of this thread, or -1 past the row
__device__ __forceinline__ int vector_of(int c) {
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  return v * kVec < c ? v : -1;
}

// Fold sums[k][8] of every thread across the block's rows and write row
// blockIdx.x of partial ([P, slots, C]) for slots 0..K-1.
template <int K>
__device__ __forceinline__ void block_partials(float (&sums)[K][kVec], float* red,
                                               float* __restrict__ partial, int c, int slots) {
  const int width = blockDim.x * kVec; // channels this block covers
  const int rows = blockDim.y;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      red[(k * rows + threadIdx.y) * width + threadIdx.x * kVec + j] = sums[k][j];
    }
  }
  __syncthreads();
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int first = blockIdx.y * width;
  for (int col = t; col < K * width; col += blockDim.x * blockDim.y) {
    const int k = col / width, ch = col - k * width;
    float total = 0.f;
    for (int y = 0; y < rows; ++y) total += red[(k * rows + y) * width + ch];
    if (first + ch < c) {
      partial[(int64_t(blockIdx.x) * slots + k) * c + first + ch] = total;
    }
  }
}

// ------------------------------------------------------------------ forward

// Partial sums of x and x^2 per channel: row blockIdx.x of partial [P, 2, C].
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const __nv_bfloat16* __restrict__ x, int64_t m, int c,
                float* __restrict__ partial) {
  __shared__ float red[2 * kThreads * kVec];
  float sums[2][kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) sums[0][j] = sums[1][j] = 0.f;
  const int v = vector_of(c);
  if (v >= 0) {
    const __nv_bfloat16* base = x + v * kVec;
    const int64_t step = int64_t(gridDim.x) * blockDim.y;
    int64_t r = int64_t(blockIdx.x) * blockDim.y + threadIdx.y;
    for (; r + 3 * step < m; r += 4 * step) {
      float f[4][kVec];
#pragma unroll
      for (int i = 0; i < 4; ++i) Load8::from(base + (r + i * step) * c, f[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          sums[0][j] += f[i][j];
          sums[1][j] = fmaf(f[i][j], f[i][j], sums[1][j]); // bf16 squares are exact
        }
      }
    }
    for (; r < m; r += step) {
      float f[kVec];
      Load8::from(base + r * c, f);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sums[0][j] += f[j];
        sums[1][j] = fmaf(f[j], f[j], sums[1][j]);
      }
    }
  }
  block_partials<2>(sums, red, partial, c, 2);
}

// The sums over the P partial rows of slots [0, K) for channel ch, in a fixed
// order: thread y of kSplit adds rows y, y + kSplit, ..., then thread 0 adds
// the kSplit results in order. Block (32, kSplit).
template <int K>
__device__ __forceinline__ void channel_totals(const float* __restrict__ partial, int p_rows,
                                               int c, int slots, int ch, float* out) {
  __shared__ float red[K][kSplit][32];
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  if (ch < c) {
    for (int p = threadIdx.y; p < p_rows; p += kSplit) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] += partial[(int64_t(p) * slots + k) * c + ch];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) red[k][threadIdx.y][threadIdx.x] = acc[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float total = 0.f;
    for (int y = 0; y < kSplit; ++y) total += red[k][y][threadIdx.x];
    out[k] = total;
  }
}

// stats [4, C] = mean, rstd, scale, clamp flag; in training from the partial
// sums (and the running averages moved by `take` of the batch's), in
// evaluation from the running averages.
__global__ void __launch_bounds__(32 * kSplit)
bn_finalize_kernel(const float* __restrict__ partial, int p_rows, int64_t m, int c,
                   const float* __restrict__ weight, float* __restrict__ running_mean,
                   float* __restrict__ running_var, float* __restrict__ stats, float keep,
                   float take, float eps, int training) {
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float totals[2] = {0.f, 0.f};
  if (training) channel_totals<2>(partial, p_rows, c, 2, ch, totals);
  if (threadIdx.y != 0 || ch >= c) return;
  float mean, var, term;
  if (training) {
    const float count = float(m);
    mean = __fdiv_rn(totals[0], count);
    const float raw = __fsub_rn(__fdiv_rn(totals[1], count), __fmul_rn(mean, mean));
    var = raw < 0.f ? 0.f : raw; // torch.clamp(min=0): NaN stays NaN
    term = raw >= 0.f ? 1.f : 0.f; // the clamp passes the gradient where raw >= 0
    running_mean[ch] = __fadd_rn(__fmul_rn(running_mean[ch], keep), __fmul_rn(take, mean));
    running_var[ch] = __fadd_rn(__fmul_rn(running_var[ch], keep), __fmul_rn(take, var));
  } else {
    mean = running_mean[ch];
    var = running_var[ch];
    term = 0.f;
  }
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  stats[ch] = mean;
  stats[c + ch] = rstd;
  stats[2 * c + ch] = __fmul_rn(rstd, weight[ch]);
  stats[3 * c + ch] = term;
}

// out = bn(x), relu(bn(x)), relu(res + bn(x)) or relu(bn2(x2) + bn(x)); each
// thread kRows rows of one block's tile of kRows * blockDim.y rows.
template <typename OutT, int kMode, int kRows>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ stats,
                const float* __restrict__ bias, const __nv_bfloat16* __restrict__ x2,
                const float* __restrict__ stats2, const float* __restrict__ bias2,
                const float* __restrict__ res, OutT* __restrict__ out, int64_t m, int c) {
  const int v = vector_of(c);
  if (v < 0) return;
  const int c0 = v * kVec;
  Channels a, b;
  a.load(stats, bias, c, c0);
  if (kMode == kNormAddRelu) b.load(stats2, bias2, c, c0);
  const int64_t r0 = int64_t(blockIdx.x) * kRows * blockDim.y + threadIdx.y;
  float f[kRows][kVec], g[kRows][kVec];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t r = r0 + i * blockDim.y;
    if (r < m) {
      Load8::from(x + r * c + c0, f[i]);
      if (kMode == kAddRelu) Load8::from(res + r * c + c0, g[i]);
      if (kMode == kNormAddRelu) Load8::from(x2 + r * c + c0, g[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t r = r0 + i * blockDim.y;
    if (r >= m) continue;
    float y[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float z = normalize(f[i][j], a.mean[j], a.scale[j], a.bias[j]);
      if (kMode == kAddRelu) z = __fadd_rn(g[i][j], z);
      if (kMode == kNormAddRelu) {
        z = __fadd_rn(normalize(g[i][j], b.mean[j], b.scale[j], b.bias[j]), z);
      }
      y[j] = kMode == kPlain ? z : relu(z);
    }
    store8(out + r * c + c0, y);
  }
}

// ------------------------------------------------------------------ backward

// dy' = dy where the ReLU passed (recomputed from the saved inputs), for 8
// channels of one row
template <int kMode>
__device__ __forceinline__ void masked(float dy[kVec], const float f[kVec], const float g[kVec],
                                       const Channels& a, const Channels& b) {
  if (kMode == kPlain) return;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    float z = normalize(f[j], a.mean[j], a.scale[j], a.bias[j]);
    if (kMode == kAddRelu) z = __fadd_rn(g[j], z);
    if (kMode == kNormAddRelu) {
      z = __fadd_rn(normalize(g[j], b.mean[j], b.scale[j], b.bias[j]), z);
    }
    if (z <= 0.f) dy[j] = 0.f; // torch's threshold_backward on the ReLU's output
  }
}

// Partial sums per channel of dy' and dy' * xhat (and dy' * xhat2): row
// blockIdx.x of partial [P, 3, C].
template <typename DyT, int kMode>
__global__ void __launch_bounds__(kThreads)
bn_backward_reduce_kernel(const DyT* __restrict__ dy, const __nv_bfloat16* __restrict__ x,
                          const float* __restrict__ stats, const float* __restrict__ bias,
                          const __nv_bfloat16* __restrict__ x2, const float* __restrict__ stats2,
                          const float* __restrict__ bias2, const float* __restrict__ res,
                          int64_t m, int c, float* __restrict__ partial) {
  constexpr int K = kMode == kNormAddRelu ? 3 : 2;
  __shared__ float red[K * kThreads * kVec];
  float sums[K][kVec];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) sums[k][j] = 0.f;
  }
  const int v = vector_of(c);
  if (v >= 0) {
    const int c0 = v * kVec;
    Channels a, b;
    a.load(stats, bias, c, c0);
    if (kMode == kNormAddRelu) b.load(stats2, bias2, c, c0);
    const int64_t step = int64_t(gridDim.x) * blockDim.y;
    for (int64_t r = int64_t(blockIdx.x) * blockDim.y + threadIdx.y; r < m; r += 2 * step) {
      float d[2][kVec], f[2][kVec], g[2][kVec];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t row = r + i * step;
        if (row < m) {
          Load8::from(dy + row * c + c0, d[i]);
          Load8::from(x + row * c + c0, f[i]);
          if (kMode == kAddRelu) Load8::from(res + row * c + c0, g[i]);
          if (kMode == kNormAddRelu) Load8::from(x2 + row * c + c0, g[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (r + i * step >= m) continue;
        masked<kMode>(d[i], f[i], g[i], a, b);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          sums[0][j] += d[i][j];
          sums[1][j] = fmaf(d[i][j], __fmul_rn(__fsub_rn(f[i][j], a.mean[j]), a.rstd[j]),
                            sums[1][j]);
          if (kMode == kNormAddRelu) {
            sums[K - 1][j] = fmaf(d[i][j], __fmul_rn(__fsub_rn(g[i][j], b.mean[j]), b.rstd[j]),
                                  sums[K - 1][j]);
          }
        }
      }
    }
  }
  block_partials<K>(sums, red, partial, c, 3);
}

// From the partial sums: dbias = sum dy', dweight = sum dy' xhat (each input's
// own), and coef [2, C] = the means the apply subtracts (0 in evaluation,
// where the statistics are constants; the xhat term 0 where the variance was
// clamped, whose gradient the clamp stops).
__global__ void __launch_bounds__(32 * kSplit)
bn_backward_finalize_kernel(const float* __restrict__ partial, int p_rows, int64_t m, int c,
                            const float* __restrict__ stats, const float* __restrict__ stats2,
                            float* __restrict__ dweight, float* __restrict__ dbias,
                            float* __restrict__ dweight2, float* __restrict__ dbias2,
                            float* __restrict__ coef, float* __restrict__ coef2, int training) {
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float totals[3] = {0.f, 0.f, 0.f};
  if (coef2 != nullptr) {
    channel_totals<3>(partial, p_rows, c, 3, ch, totals);
  } else {
    channel_totals<2>(partial, p_rows, c, 3, ch, totals);
  }
  if (threadIdx.y != 0 || ch >= c) return;
  const float count = float(m);
  dbias[ch] = totals[0];
  dweight[ch] = totals[1];
  const float mean_dy = training ? __fdiv_rn(totals[0], count) : 0.f;
  coef[ch] = mean_dy;
  coef[c + ch] = training ? __fdiv_rn(totals[1], count) * stats[3 * c + ch] : 0.f;
  if (coef2 != nullptr) {
    dbias2[ch] = totals[0];
    dweight2[ch] = totals[2];
    coef2[ch] = mean_dy;
    coef2[c + ch] = training ? __fdiv_rn(totals[2], count) * stats2[3 * c + ch] : 0.f;
  }
}

// dx = scale * (dy' - mean(dy') - xhat * mean(dy' xhat)) in bf16, the same
// for x2 with its own constants, and the float32 shortcut's gradient dy'.
template <typename DyT, int kMode, int kRows>
__global__ void __launch_bounds__(kThreads)
bn_backward_apply_kernel(const DyT* __restrict__ dy, const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ stats, const float* __restrict__ bias,
                         const float* __restrict__ coef, const __nv_bfloat16* __restrict__ x2,
                         const float* __restrict__ stats2, const float* __restrict__ bias2,
                         const float* __restrict__ coef2, const float* __restrict__ res,
                         __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ dx2,
                         float* __restrict__ dres, int64_t m, int c) {
  const int v = vector_of(c);
  if (v < 0) return;
  const int c0 = v * kVec;
  Channels a, b;
  float mean_dy[kVec], mean_dxh[kVec], mean_dxh2[kVec];
  a.load(stats, bias, c, c0);
  Load8::from(coef + c0, mean_dy);
  Load8::from(coef + c + c0, mean_dxh);
  if (kMode == kNormAddRelu) {
    b.load(stats2, bias2, c, c0);
    Load8::from(coef2 + c + c0, mean_dxh2);
  }
  const int64_t r0 = int64_t(blockIdx.x) * kRows * blockDim.y + threadIdx.y;
  float d[kRows][kVec], f[kRows][kVec], g[kRows][kVec];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t r = r0 + i * blockDim.y;
    if (r < m) {
      Load8::from(dy + r * c + c0, d[i]);
      Load8::from(x + r * c + c0, f[i]);
      if (kMode == kAddRelu) Load8::from(res + r * c + c0, g[i]);
      if (kMode == kNormAddRelu) Load8::from(x2 + r * c + c0, g[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t r = r0 + i * blockDim.y;
    if (r >= m) continue;
    masked<kMode>(d[i], f[i], g[i], a, b);
    float out[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float xhat = __fmul_rn(__fsub_rn(f[i][j], a.mean[j]), a.rstd[j]);
      out[j] = a.scale[j] * (d[i][j] - mean_dy[j] - xhat * mean_dxh[j]);
    }
    store8(dx + r * c + c0, out);
    if (kMode == kNormAddRelu) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xhat = __fmul_rn(__fsub_rn(g[i][j], b.mean[j]), b.rstd[j]);
        out[j] = b.scale[j] * (d[i][j] - mean_dy[j] - xhat * mean_dxh2[j]);
      }
      store8(dx2 + r * c + c0, out);
    }
    if (kMode == kAddRelu) store8(dres + r * c + c0, d[i]);
  }
}

// ------------------------------------------------------------------ launches

dim3 block_of(int c) {
  const int vectors = c / kVec;
  const int across = vectors < kThreads ? vectors : kThreads;
  return dim3(across, kThreads / across);
}

unsigned chunks_of(int c) { return unsigned((c / kVec + kThreads - 1) / kThreads); }

template <int kRows>
dim3 tiles_of(int64_t m, int c) {
  const int64_t rows = int64_t(kRows) * block_of(c).y;
  return dim3(unsigned((m + rows - 1) / rows), chunks_of(c));
}

template <typename OutT, int kMode>
void launch_apply(const void* x, const void* stats, const void* bias, const void* x2,
                  const void* stats2, const void* bias2, const void* res, void* out, int64_t m,
                  int c, cudaStream_t stream) {
  constexpr int kRows = kMode == kNormAddRelu ? 2 : 4;
  bn_apply_kernel<OutT, kMode, kRows><<<tiles_of<kRows>(m, c), block_of(c), 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(x2),
      static_cast<const float*>(stats2), static_cast<const float*>(bias2),
      static_cast<const float*>(res), static_cast<OutT*>(out), m, c);
}

template <typename DyT, int kMode>
void launch_backward_reduce(const void* dy, const void* x, const void* stats, const void* bias,
                            const void* x2, const void* stats2, const void* bias2,
                            const void* res, int64_t m, int c, int p_rows, void* partial,
                            cudaStream_t stream) {
  bn_backward_reduce_kernel<DyT, kMode><<<dim3(p_rows, chunks_of(c)), block_of(c), 0, stream>>>(
      static_cast<const DyT*>(dy), static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(stats), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(x2), static_cast<const float*>(stats2),
      static_cast<const float*>(bias2), static_cast<const float*>(res), m, c,
      static_cast<float*>(partial));
}

template <typename DyT, int kMode>
void launch_backward_apply(const void* dy, const void* x, const void* stats, const void* bias,
                           const void* coef, const void* x2, const void* stats2,
                           const void* bias2, const void* coef2, const void* res, void* dx,
                           void* dx2, void* dres, int64_t m, int c, cudaStream_t stream) {
  constexpr int kRows = kMode == kNormAddRelu ? 2 : 4;
  bn_backward_apply_kernel<DyT, kMode, kRows>
      <<<tiles_of<kRows>(m, c), block_of(c), 0, stream>>>(
          static_cast<const DyT*>(dy), static_cast<const __nv_bfloat16*>(x),
          static_cast<const float*>(stats), static_cast<const float*>(bias),
          static_cast<const float*>(coef), static_cast<const __nv_bfloat16*>(x2),
          static_cast<const float*>(stats2), static_cast<const float*>(bias2),
          static_cast<const float*>(coef2), static_cast<const float*>(res),
          static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(dx2),
          static_cast<float*>(dres), m, c);
}

} // namespace

// The C entry points. Tensors are device pointers; x, x2, dx and dx2 are
// bf16 [M, C], res and dres float32 [M, C], out and dy bf16 where the flag
// says so (mode 1 only: the ReLU's output feeds a bf16 convolution) and
// float32 otherwise, every [M, C] pointer 16-byte aligned, C a multiple of 8,
// M >= 1. Each returns the launch's cudaError_t; an unknown mode or dtype
// returns cudaErrorInvalidValue.

extern "C" int bn_stats(const void* x, long long m, int c, int p_rows, void* partial,
                        void* stream) {
  bn_stats_kernel<<<dim3(p_rows, chunks_of(c)), block_of(c), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), m, c, static_cast<float*>(partial));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_finalize(const void* partial, int p_rows, long long m, int c,
                           const void* weight, void* running_mean, void* running_var,
                           void* stats, float keep, float take, float eps, int training,
                           void* stream) {
  bn_finalize_kernel<<<(c + 31) / 32, dim3(32, kSplit), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), p_rows, m, c, static_cast<const float*>(weight),
      static_cast<float*>(running_mean), static_cast<float*>(running_var),
      static_cast<float*>(stats), keep, take, eps, training);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_apply(const void* x, const void* stats, const void* bias, const void* x2,
                        const void* stats2, const void* bias2, const void* res, void* out,
                        long long m, int c, int mode, int out_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16 && mode == kRelu) {
    launch_apply<__nv_bfloat16, kRelu>(x, stats, bias, x2, stats2, bias2, res, out, m, c, s);
  } else if (out_bf16) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (mode == kPlain) {
    launch_apply<float, kPlain>(x, stats, bias, x2, stats2, bias2, res, out, m, c, s);
  } else if (mode == kRelu) {
    launch_apply<float, kRelu>(x, stats, bias, x2, stats2, bias2, res, out, m, c, s);
  } else if (mode == kAddRelu) {
    launch_apply<float, kAddRelu>(x, stats, bias, x2, stats2, bias2, res, out, m, c, s);
  } else if (mode == kNormAddRelu) {
    launch_apply<float, kNormAddRelu>(x, stats, bias, x2, stats2, bias2, res, out, m, c, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_backward_reduce(const void* dy, const void* x, const void* stats,
                                  const void* bias, const void* x2, const void* stats2,
                                  const void* bias2, const void* res, long long m, int c,
                                  int mode, int dy_bf16, int p_rows, void* partial,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_REDUCE(T, MODE) \
  launch_backward_reduce<T, MODE>(dy, x, stats, bias, x2, stats2, bias2, res, m, c, p_rows, \
                                  partial, s)
  if (dy_bf16 && mode == kRelu) {
    PTT_REDUCE(__nv_bfloat16, kRelu);
  } else if (dy_bf16) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (mode == kPlain) {
    PTT_REDUCE(float, kPlain);
  } else if (mode == kRelu) {
    PTT_REDUCE(float, kRelu);
  } else if (mode == kAddRelu) {
    PTT_REDUCE(float, kAddRelu);
  } else if (mode == kNormAddRelu) {
    PTT_REDUCE(float, kNormAddRelu);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_REDUCE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_backward_finalize(const void* partial, int p_rows, long long m, int c,
                                    const void* stats, const void* stats2, void* dweight,
                                    void* dbias, void* dweight2, void* dbias2, void* coef,
                                    void* coef2, int training, void* stream) {
  bn_backward_finalize_kernel<<<(c + 31) / 32, dim3(32, kSplit), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), p_rows, m, c, static_cast<const float*>(stats),
      static_cast<const float*>(stats2), static_cast<float*>(dweight),
      static_cast<float*>(dbias), static_cast<float*>(dweight2), static_cast<float*>(dbias2),
      static_cast<float*>(coef), static_cast<float*>(coef2), training);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_backward_apply(const void* dy, const void* x, const void* stats,
                                 const void* bias, const void* coef, const void* x2,
                                 const void* stats2, const void* bias2, const void* coef2,
                                 const void* res, void* dx, void* dx2, void* dres, long long m,
                                 int c, int mode, int dy_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_BACKWARD(T, MODE) \
  launch_backward_apply<T, MODE>(dy, x, stats, bias, coef, x2, stats2, bias2, coef2, res, dx, \
                                 dx2, dres, m, c, s)
  if (dy_bf16 && mode == kRelu) {
    PTT_BACKWARD(__nv_bfloat16, kRelu);
  } else if (dy_bf16) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (mode == kPlain) {
    PTT_BACKWARD(float, kPlain);
  } else if (mode == kRelu) {
    PTT_BACKWARD(float, kRelu);
  } else if (mode == kAddRelu) {
    PTT_BACKWARD(float, kAddRelu);
  } else if (mode == kNormAddRelu) {
    PTT_BACKWARD(float, kNormAddRelu);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_BACKWARD
  return static_cast<int>(cudaGetLastError());
}
