// Beam-search KV-cache reorder: one launch copies the selected rows of every
// cache leaf into new buffers.
//
// Replaces the TPU kernel `beam_gather_rows_multi`
// (benchmarks/probe_beam_gather.py:62), the Pallas row-DMA gather that beam
// search ran at its `_gather_beams` seam (vidsitu_tpu/gen/beam.py:85). For
// every leaf i:
//
//     dst_i[r, :] = src_i[src_rows[r], :]      r in [0, n_out)
//
// with src_i a contiguous (n_src, row_bytes_i) array. The copy goes into new
// buffers, never in place: a parent beam is often copied into several new
// slots, and it must not be overwritten before its last copy has read it.
// The kernel moves bytes, so one instantiation serves bf16 and float32.
//
// Bound: device memory. A beam-5 step at the SRL main path's sizes (400 rows,
// 6 self-attention leaves of 201 x 8 x 128 bf16 plus 6 cross leaves of
// 1 x 8 x 128) reads and writes about 1 GB each way, so the only aim is to
// stream at the card's bandwidth: each block copies one 32 KB chunk of one
// (row, leaf) pair with 16-byte vector loads and stores, four in flight per
// thread. The grid is (rows, leaves, chunks of the widest row); blocks past
// the end of a narrower row return at once. Chunks keep the blocks small:
// with one block per 411 KB row, 2,400 blocks filled the card's 1,056 block
// slots 2.27 times, and the last, partial wave cost about a sixth of the
// time. A row whose source and destination are not 16-byte aligned alike is
// copied byte by byte; an aligned row copies its unaligned head and tail
// bytes one by one (in its first chunk) and the rest as vectors.
//
// The leaves' pointers and row sizes travel by value in one struct (well
// inside the 4 KB kernel-parameter limit). The kernel launches on the
// caller's stream and returns the launch's CUDA error; the caller raises.
// An index outside [0, n_src) traps, like index_select's device assert.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kChunk = 32768;  // bytes of a row per block
constexpr long long kChunkVec = kChunk / 16;

struct Leaves {
  const char* src[kMaxLeaves];
  char* dst[kMaxLeaves];
  long long row_bytes[kMaxLeaves];
};

static_assert(sizeof(Leaves) + 64 <= 4096, "kernel parameters exceed 4 KB");

__device__ __forceinline__ void copy_bytes(const char* __restrict__ src,
                                           char* __restrict__ dst,
                                           long long begin, long long end) {
  for (long long i = begin + threadIdx.x; i < end; i += blockDim.x) dst[i] = src[i];
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
    beam_gather_rows_kernel(Leaves leaves, const Index* __restrict__ src_rows,
                            long long n_src) {
  const long long r = blockIdx.x;
  const int leaf = blockIdx.y;
  const long long chunk = blockIdx.z;
  const long long nb = leaves.row_bytes[leaf];
  if (chunk * kChunk >= nb && chunk > 0) return;  // past a narrower row
  const long long row = static_cast<long long>(src_rows[r]);
  if (row < 0 || row >= n_src) __trap();
  const char* __restrict__ src = leaves.src[leaf] + row * nb;
  char* __restrict__ dst = leaves.dst[leaf] + r * nb;

  const uintptr_t sa = reinterpret_cast<uintptr_t>(src) & 15;
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst) & 15;
  if (sa != da) {  // alignments differ: no common vector grid
    const long long end = (chunk + 1) * kChunk;
    copy_bytes(src, dst, chunk * kChunk, end < nb ? end : nb);
    return;
  }
  long long head = sa ? static_cast<long long>(16 - sa) : 0;
  if (head > nb) head = nb;
  const long long n_vec = (nb - head) / 16;
  if (chunk == 0) {
    copy_bytes(src, dst, 0, head);
    copy_bytes(src, dst, head + n_vec * 16, nb);
  }

  const int4* __restrict__ vs = reinterpret_cast<const int4*>(src + head);
  int4* __restrict__ vd = reinterpret_cast<int4*>(dst + head);
  const long long v_end =
      (chunk + 1) * kChunkVec < n_vec ? (chunk + 1) * kChunkVec : n_vec;
  const long long stride = static_cast<long long>(blockDim.x) * kUnroll;
  long long i = chunk * kChunkVec + threadIdx.x;
  for (; i + (kUnroll - 1) * blockDim.x < v_end; i += stride) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(vs + i + u * blockDim.x);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) vd[i + u * blockDim.x] = v[u];
  }
  for (; i < v_end; i += blockDim.x) vd[i] = __ldg(vs + i);
}

}  // namespace

extern "C" {

int beam_gather_max_leaves() { return kMaxLeaves; }

// src/dst: n_leaves device pointers each; row_bytes: n_leaves sizes (host);
// src_rows: n_out device indices, int64 when index_is_64 else int32.
// Returns a cudaError_t (0 on success). n_out or n_leaves of 0 launches
// nothing.
int beam_gather_rows(const void* const* src, void* const* dst,
                     const long long* row_bytes, int n_leaves,
                     const void* src_rows, int index_is_64, long long n_out,
                     long long n_src, void* stream) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves || n_out < 0 || n_out > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0 || n_leaves == 0) return 0;
  Leaves leaves{};
  long long widest = 0;
  for (int i = 0; i < n_leaves; ++i) {
    leaves.src[i] = static_cast<const char*>(src[i]);
    leaves.dst[i] = static_cast<char*>(dst[i]);
    leaves.row_bytes[i] = row_bytes[i];
    if (row_bytes[i] > widest) widest = row_bytes[i];
  }
  const long long chunks = widest > 0 ? (widest + kChunk - 1) / kChunk : 1;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_out), static_cast<unsigned>(n_leaves),
                  static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_is_64) {
    beam_gather_rows_kernel<long long><<<grid, kThreads, 0, s>>>(
        leaves, static_cast<const long long*>(src_rows), n_src);
  } else {
    beam_gather_rows_kernel<int><<<grid, kThreads, 0, s>>>(
        leaves, static_cast<const int*>(src_rows), n_src);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
