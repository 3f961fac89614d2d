// Stored-block inflate for Hopper (sm_90a): the gather-copy that turns a batch
// of all-stored raw-deflate frames into their inflated payloads.
//
// Replaces the Pallas kernel _stored_copy_kernel / stored_inflate of
// petastorm_tpu/ops/raw_decode.py. The input is the concatenated frames
// (uint8, src_len bytes) and the (m, 3) int32 segment table of
// (src_offset, dst_offset, length) rows that plan_stored_batch builds; each row
// copies `length` bytes. The output (out_len bytes) is zeroed by the caller.
//
// Bound: memory. Every source byte is read once and every output byte written
// once, with no arithmetic, so the least time is (src_len + 12 m + out_len)
// bytes over the card's memory rate.
//
// Design: destination ranges never overlap, so blocks need no order and no
// read-modify-write (the TPU kernel's sequential grid and fixed 1024-byte
// window existed only to keep its VMEM window fixed). One block takes one
// segment row (a grid-stride loop covers m beyond the grid), masks by the
// row's own length, and copies 16 bytes per thread where source and
// destination share their alignment modulo 16, single bytes otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
stored_copy_kernel(const uint8_t* __restrict__ src, const int32_t* __restrict__ segs,
                   int m, uint8_t* __restrict__ out) {
  for (int row = blockIdx.x; row < m; row += gridDim.x) {
    const int64_t src_off = segs[3 * row];
    const int64_t dst_off = segs[3 * row + 1];
    const int len = segs[3 * row + 2];
    if (len <= 0) continue;
    const uint8_t* s = src + src_off;
    uint8_t* d = out + dst_off;
    const uintptr_t s_addr = reinterpret_cast<uintptr_t>(s);
    const uintptr_t d_addr = reinterpret_cast<uintptr_t>(d);
    if (((s_addr ^ d_addr) & 15) == 0 && len >= 64) {
      // co-aligned: byte head up to the 16-byte boundary, uint4 body, byte tail
      const int head = static_cast<int>((16 - (d_addr & 15)) & 15);
      const int nvec = (len - head) >> 4;
      const int tail = head + (nvec << 4);
      for (int i = threadIdx.x; i < head; i += kThreads) d[i] = s[i];
      const uint4* sv = reinterpret_cast<const uint4*>(s + head);
      uint4* dv = reinterpret_cast<uint4*>(d + head);
      for (int i = threadIdx.x; i < nvec; i += kThreads) dv[i] = sv[i];
      for (int i = tail + threadIdx.x; i < len; i += kThreads) d[i] = s[i];
    } else {
      for (int i = threadIdx.x; i < len; i += kThreads) d[i] = s[i];
    }
  }
}

}  // namespace

// Launches the copy on `stream` and returns cudaGetLastError() (0 on success).
// `src`, `segs` and `out` are device pointers; the segment table must hold
// in-bounds rows (the Python wrapper, stored_inflate, checks every row on the
// host before it uploads the table).
extern "C" int stored_copy(const void* src, const void* segs, int m, void* out,
                           void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = m < kMaxBlocks ? m : kMaxBlocks;
  stored_copy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int32_t*>(segs), m,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
