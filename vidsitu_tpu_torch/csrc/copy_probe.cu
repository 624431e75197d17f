// Copy probes for Hopper (sm_90a): what a hand-written kernel's data path
// can move, beside the library's copy and one elementwise operation.
//
// Replace the TPU probes pallas_copy (benchmarks/gates.py:86,
// benchmarks/micro3.py:44), manual_copy (benchmarks/micro3.py:130) and
// hbm2hbm (benchmarks/micro3.py:158). All three copy a 2-D array of bytes;
// they differ in the path the bytes take, which is the point of the probe:
//
//   staged_copy     device memory -> shared memory -> device memory, one
//                   thread block per (block_rows x block_cols) block of the
//                   array, the whole block resident in shared memory between
//                   its load and its store (the counterpart of a Pallas
//                   BlockSpec copy through VMEM). The block must fit the 227
//                   KB a thread block can have: the launcher refuses others.
//   pipelined_copy  the same path with a hand-rolled two-slot ring: while a
//                   slot is stored, cp.async fills the other. Persistent
//                   blocks walk the array in chunks of `chunk_bytes`.
//   direct_copy     device memory -> device memory through registers, grid
//                   stride, no staging.
//
// Bound by bytes: each byte is read once and written once. All accesses are
// 16-byte vectors, neighbouring threads on neighbouring addresses.
//
// Plain C interface (built with nvcc alone, loaded with ctypes). Each entry
// returns 0, a cudaError_t, or -2 when the block or chunk does not fit
// shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long SMEM_LIMIT = 232448;  // 227 KB

// one (rows x row_vecs) block per thread block; pitch in 16-byte vectors
__global__ void __launch_bounds__(THREADS)
staged_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                   long pitch_vecs, int block_rows, int block_vecs) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* tile = reinterpret_cast<uint4*>(smem);
  const long base = (long)blockIdx.y * block_rows * pitch_vecs +
                    (long)blockIdx.x * block_vecs;
  const int n = block_rows * block_vecs;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / block_vecs, c = i - r * block_vecs;
    tile[i] = src[base + (long)r * pitch_vecs + c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / block_vecs, c = i - r * block_vecs;
    dst[base + (long)r * pitch_vecs + c] = tile[i];
  }
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two slots of chunk_vecs vectors; chunk i of this block is chunk
// blockIdx.x + i * gridDim.x of the array
__global__ void __launch_bounds__(THREADS)
pipelined_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                      long total_vecs, int chunk_vecs) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  const long n_chunks = (total_vecs + chunk_vecs - 1) / chunk_vecs;

  auto fill = [&](int slot, long chunk) {
    const long first = chunk * chunk_vecs;
    const long left = total_vecs - first;
    const int n = (int)(left < chunk_vecs ? left : chunk_vecs);
    uint4* s = ring + (long)slot * chunk_vecs;
    for (int i = threadIdx.x; i < n; i += THREADS)
      cp_async16(s + i, src + first + i);
  };

  long chunk = blockIdx.x;
  if (chunk < n_chunks) fill(0, chunk);
  cp_async_commit();
  for (int it = 0; chunk < n_chunks; ++it, chunk += gridDim.x) {
    const int slot = it & 1;
    const long next = chunk + gridDim.x;
    if (next < n_chunks) fill(slot ^ 1, next);
    cp_async_commit();    // a group per iteration, empty at the end
    cp_async_wait<1>();   // all but the newest group: this slot has landed
    __syncthreads();
    const long first = chunk * chunk_vecs;
    const long left = total_vecs - first;
    const int n = (int)(left < chunk_vecs ? left : chunk_vecs);
    const uint4* s = ring + (long)slot * chunk_vecs;
    for (int i = threadIdx.x; i < n; i += THREADS) dst[first + i] = s[i];
    __syncthreads();      // the slot is refilled in the next iteration
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(THREADS)
direct_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                   long total_vecs) {
  const long stride = (long)gridDim.x * THREADS;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < total_vecs;
       i += stride)
    dst[i] = src[i];
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace

// rows x row_bytes array, contiguous; blocks of block_rows x block_bytes
// (row_bytes, block_bytes multiples of 16; both block sizes divide the array)
extern "C" int staged_copy(const void* src, void* dst, long rows,
                           long row_bytes, int block_rows, int block_bytes,
                           void* stream) {
  if (rows <= 0 || row_bytes <= 0 || block_rows <= 0 || block_bytes <= 0 ||
      row_bytes % 16 || block_bytes % 16 || rows % block_rows ||
      row_bytes % block_bytes)
    return (int)cudaErrorInvalidValue;
  const long smem_bytes = (long)block_rows * block_bytes;
  if (smem_bytes > SMEM_LIMIT) return -2;
  const long gx = row_bytes / block_bytes, gy = rows / block_rows;
  if (gx > 2147483647L || gy > 65535L) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      staged_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  staged_copy_kernel<<<dim3((unsigned)gx, (unsigned)gy), THREADS,
                       (size_t)smem_bytes,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst),
      row_bytes / 16, block_rows, block_bytes / 16);
  return (int)cudaGetLastError();
}

// total_bytes (a multiple of 16) in chunks of chunk_bytes (a multiple of 16;
// two chunks must fit shared memory); blocks_per_sm persistent blocks per SM
extern "C" int pipelined_copy(const void* src, void* dst, long total_bytes,
                              int chunk_bytes, int blocks_per_sm,
                              void* stream) {
  if (total_bytes <= 0 || chunk_bytes <= 0 || blocks_per_sm <= 0 ||
      total_bytes % 16 || chunk_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const long smem_bytes = 2L * chunk_bytes;
  if (smem_bytes > SMEM_LIMIT) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      pipelined_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long n_chunks = (total_bytes + chunk_bytes - 1) / chunk_bytes;
  long grid = (long)sm_count() * blocks_per_sm;
  if (grid > n_chunks) grid = n_chunks;
  pipelined_copy_kernel<<<(unsigned)grid, THREADS, (size_t)smem_bytes,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst),
      total_bytes / 16, chunk_bytes / 16);
  return (int)cudaGetLastError();
}

// total_bytes (a multiple of 16); blocks_per_sm grid-stride blocks per SM
extern "C" int direct_copy(const void* src, void* dst, long total_bytes,
                           int blocks_per_sm, void* stream) {
  if (total_bytes <= 0 || blocks_per_sm <= 0 || total_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const long total_vecs = total_bytes / 16;
  long grid = (long)sm_count() * blocks_per_sm;
  const long need = (total_vecs + THREADS - 1) / THREADS;
  if (grid > need) grid = need;
  direct_copy_kernel<<<(unsigned)grid, THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst),
      total_vecs);
  return (int)cudaGetLastError();
}
