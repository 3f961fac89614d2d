// Stored-block inflate for Hopper (sm_90a): the gather-copy that turns a batch
// of all-stored raw-deflate frames into their inflated payloads.
//
// Replaces the Pallas kernel _stored_copy_kernel / stored_inflate of
// petastorm_tpu/ops/raw_decode.py. The input is the concatenated frames
// (uint8) and the (m, 3) int32 segment table of (src_offset, dst_offset,
// length) rows that plan_stored_batch builds, one row per stored block (any
// length; a stored block holds at most 65535 bytes), sorted by dst_offset
// with no two destination ranges overlapping. The output is out_len bytes:
// each row's bytes, and 0 where no row writes.
//
// Bound: memory. Every source byte is read once and every output byte written
// once, with no arithmetic, so the least time is (src_len + 12 m + out_len)
// bytes over the card's memory rate.
//
// Design. The TPU kernel walks the table as a sequential grid with a fixed
// 1024-byte VMEM window, a read-modify-write of that window and a zero-fill by
// its first step. Here the OUTPUT is tiled instead, so the work is balanced by
// output bytes whatever the rows' lengths:
// - A block of 128 threads owns a tile of 8 KiB; each thread owns four 16-byte
//   output words of it, neighbouring threads on neighbouring words, and
//   issues the loads of all four before its first store. Every
//   output byte is written exactly once, so the caller allocates the output
//   with torch.empty and no memset runs.
// - The block finds the rows that reach into its tile by two binary searches
//   over dst_offset (the same addresses in every thread, so each step is one
//   broadcast load); each word then searches only those rows, usually one or
//   two.
// - A word inside one row is read from the source as the one or two aligned
//   16-byte words that span it and shifted into place in registers
//   (__funnelshift_r), then written with one aligned 16-byte store, whatever
//   the source's alignment. Neighbouring threads read overlapping source
//   words, so the loads stay coalesced and the overlap hits L1. A TMA 1-D
//   bulk load into shared memory would realign as well, but it needs a
//   16-byte aligned window, shared memory and a barrier per tile for what two
//   loads and four funnel shifts do in registers.
// - A word that crosses a row's edge or a gap between rows, or the ragged
//   last word, takes a byte-wise path: each byte from the row that covers it,
//   or 0.
// The aligned loads may touch up to 15 bytes before or after a row's source
// range, always inside the same aligned 16-byte word as a byte of the range,
// so they never cross a page of the source's allocation; those bytes are
// shifted out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWordsPerThread = 4;
constexpr int64_t kTileBytes = int64_t(kThreads) * kWordsPerThread * 16;

// The last row in [lo, hi) whose dst_offset is <= p, or lo - 1 when none is.
__device__ __forceinline__ int last_row_at(const int32_t* segs, int lo, int hi, int64_t p) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(segs + 3 * int64_t(mid) + 1) <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// The 16 bytes at byte k (0-15) of the 32-byte window lo:hi.
__device__ __forceinline__ uint4 shift_window(uint4 lo, uint4 hi, unsigned k) {
  const unsigned shift = (k & 3) * 8;
  uint32_t a0, a1, a2, a3, a4;
  switch (k >> 2) {
    case 0: a0 = lo.x; a1 = lo.y; a2 = lo.z; a3 = lo.w; a4 = hi.x; break;
    case 1: a0 = lo.y; a1 = lo.z; a2 = lo.w; a3 = hi.x; a4 = hi.y; break;
    case 2: a0 = lo.z; a1 = lo.w; a2 = hi.x; a3 = hi.y; a4 = hi.z; break;
    default: a0 = lo.w; a1 = hi.x; a2 = hi.y; a3 = hi.z; a4 = hi.w; break;
  }
  return make_uint4(__funnelshift_r(a0, a1, shift), __funnelshift_r(a1, a2, shift),
                    __funnelshift_r(a2, a3, shift), __funnelshift_r(a3, a4, shift));
}

// Output word p, which crosses a row's edge, a gap or the end of the output,
// byte by byte; r is the last row starting at or before p (or -1).
__device__ __forceinline__ void copy_word_bytes(const uint8_t* __restrict__ src,
                                                const int32_t* __restrict__ segs, int m, int r,
                                                uint8_t* __restrict__ out, int64_t out_len,
                                                int64_t p) {
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int64_t q = p + j;
    while (r + 1 < m && __ldg(segs + 3 * int64_t(r + 1) + 1) <= q) ++r;
    if (r >= 0) {
      const int64_t dst = __ldg(segs + 3 * int64_t(r) + 1);
      if (q < dst + __ldg(segs + 3 * int64_t(r) + 2)) {
        const uint32_t byte = __ldg(src + __ldg(segs + 3 * int64_t(r)) + (q - dst));
        v[j >> 2] |= byte << (8 * (j & 3));
      }
    }
  }
  if (p + 16 <= out_len) {
    *reinterpret_cast<uint4*>(out + p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (p + j < out_len) out[p + j] = static_cast<uint8_t>(v[j >> 2] >> (8 * (j & 3)));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
stored_copy_kernel(const uint8_t* __restrict__ src, const int32_t* __restrict__ segs,
                   int m, uint8_t* __restrict__ out, int64_t out_len) {
  const int64_t tile = int64_t(blockIdx.x) * kTileBytes;
  const int64_t tile_last = min(tile + kTileBytes, out_len) - 1;
  // rows r_lo..r_hi are the only ones that can cover a byte of this tile
  const int r_lo = last_row_at(segs, 0, m, tile);
  const int r_hi = last_row_at(segs, r_lo + 1, m, tile_last);
  // first each word's row and, for a word inside one row, its source address;
  // then all the loads, so that every word's loads are in flight together
  int row[kWordsPerThread];
  uintptr_t from[kWordsPerThread];
#pragma unroll
  for (int i = 0; i < kWordsPerThread; ++i) {
    const int64_t p = tile + (int64_t(i) * kThreads + threadIdx.x) * 16;
    row[i] = last_row_at(segs, r_lo + 1, r_hi + 1, p);
    from[i] = 0;
    if (row[i] >= 0 && p < out_len) {
      const int64_t dst = __ldg(segs + 3 * int64_t(row[i]) + 1);
      if (p + 16 <= dst + __ldg(segs + 3 * int64_t(row[i]) + 2)) {
        from[i] = reinterpret_cast<uintptr_t>(src) + __ldg(segs + 3 * int64_t(row[i])) +
                  (p - dst);
      }
    }
  }
  uint4 lo[kWordsPerThread], hi[kWordsPerThread];
#pragma unroll
  for (int i = 0; i < kWordsPerThread; ++i) {
    if (from[i]) {
      // the aligned words that span the 16 bytes (the same one twice when
      // they are aligned)
      const uint4* base = reinterpret_cast<const uint4*>(from[i] & ~uintptr_t(15));
      lo[i] = __ldg(base);
      hi[i] = __ldg(base + ((from[i] & 15) != 0));
    }
  }
#pragma unroll
  for (int i = 0; i < kWordsPerThread; ++i) {
    const int64_t p = tile + (int64_t(i) * kThreads + threadIdx.x) * 16;
    if (from[i]) {
      *reinterpret_cast<uint4*>(out + p) =
          shift_window(lo[i], hi[i], static_cast<unsigned>(from[i] & 15));
    } else if (p < out_len) {
      copy_word_bytes(src, segs, m, row[i], out, out_len, p);
    }
  }
}

}  // namespace

// Launches the copy on `stream` and returns cudaGetLastError() (0 on success).
// `src`, `segs` and `out` are device pointers (`segs` may be null when m is 0,
// and the output is then all zeros); `out` must be 16-byte aligned. The table
// must hold in-bounds rows sorted by dst_offset with no overlap (the Python
// wrapper, stored_inflate, checks every row on the host).
extern "C" int stored_copy(const void* src, const void* segs, int m, void* out,
                           long long out_len, void* stream) {
  if (out_len <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (out_len + kTileBytes - 1) / kTileBytes;
  stored_copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int32_t*>(segs), m,
      static_cast<uint8_t*>(out), out_len);
  return static_cast<int>(cudaGetLastError());
}
