// Non-local attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vidsitu_tpu/ops/attention.py:30 _fused_attn_kernel
// (reached through fused_attention, :61). Computes, for each batch b,
//   softmax:     O = softmax(Q K^T * scale) V
//   dot_product: O = (Q K^T / Sk) V
// with Q (B, Sq, d), K and V (B, Sk, d), all row-major and contiguous. Logits,
// softmax and the output accumulator are float32; O is cast to the input type.
// Every shape is taken: ragged query and key tiles are masked in the kernel, so
// no shape falls back to another path (the TPU kernel fell back to einsum when
// keys needed padding under softmax).
//
// What bounds it on an H100: at the I3D-NL stage-3 shape (Sq=3136, Sk=784,
// d=256) one clip is 4*Sq*Sk*d = 2.5 GFLOP against about 4 MB of q/k/v/o in
// bf16, ~630 FLOP per byte of device memory, above the card's ~295 FLOP/byte
// ridge in bf16: the kernel is compute-bound, and the (Sq x Sk) logits are the
// bytes worth avoiding (12 MB of float32 per clip if written out).
//
// What the design does about it:
//  * the logits never leave the SM: one block per (batch, 64-query tile)
//    walks K and V in tiles staged in shared memory, with an online softmax
//    (running max and sum per row, float32), so device memory sees only
//    q, k, v and o;
//  * bf16 products run on the tensor cores (WMMA 16x16x16, float32
//    accumulate); the block's Q rows stay in registers as WMMA fragments for
//    the whole key loop;
//  * the float32 output accumulator (64 x d, up to d=512) lives in dynamic
//    shared memory, above 48 KB, hence cudaFuncSetAttribute;
//  * float32 inputs take the same tiling with plain FMA (full float32, no
//    TF32), for the reference-precision path.
// Left for later: wgmma/TMA, a K/V double buffer and register accumulators.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry: nl_attn_fwd (bottom of file), returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;                    // query rows per block
constexpr int NWARPS = 4;                 // warp w owns query rows [16w, 16w+16)
constexpr int NTHREADS = 32 * NWARPS;
constexpr int WROWS = BQ / NWARPS;        // 16

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Tile geometry for element type T and head width DP (d rounded up to 64,
// 128, 256 or 512; columns beyond d are zero-filled). Pitches carry a pad of
// 16 bytes per row against shared-memory bank conflicts and keep every WMMA
// pointer 32-byte aligned.
template <typename T, int DP>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // keys per tile; bf16 at d<=256 keeps the block under half the SM's
  // shared memory so that two blocks fit on one SM
  static constexpr int BK = kBf16 ? (DP == 256 ? 32 : 64) : 32;
  static constexpr int LDKV = DP + 16 / (int)sizeof(T);  // K/V tile pitch (T)
  static constexpr int LDO = DP + 4;                     // O accumulator (float)
  static constexpr int LDS = BK + 4;                     // logits (float)
  static constexpr int LDP = BK + 8;                     // bf16 probabilities
  static constexpr int LDQ = DP + 8;                     // bf16 Q staging
  static constexpr size_t kO = 0;
  static constexpr size_t kKV = kO + align128(sizeof(float) * BQ * LDO);
  static constexpr size_t kS = kKV + align128(sizeof(T) * BK * LDKV);
  static constexpr size_t kP = kS + align128(sizeof(float) * BQ * LDS);
  static constexpr size_t kStats =
      kP + (kBf16 ? align128(sizeof(bf16) * BQ * LDP) : 0);
  static constexpr size_t kBytes = kStats + sizeof(float) * 2 * BQ;
  static_assert(kBytes <= 232448, "tile exceeds the SM's shared memory");
  static_assert(!kBf16 || sizeof(bf16) * BQ * LDQ <= sizeof(float) * BQ * LDO,
                "Q staging must fit in the O accumulator");
};

// Copy rows [row0, row0 + ROWS) of a (nrows, d) row-major matrix into a
// shared tile of pitch LD, 16 bytes per thread and step. Rows past nrows and
// columns past d (up to DP) are zero-filled.
template <typename T, int DP, int ROWS, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int nrows, int d) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DP / VEC;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && c < d) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// The block's Q rows: WMMA fragments in registers for bf16; float32 reads Q
// from device memory (it stays in L1) and keeps nothing.
template <typename T, int DP>
struct QRegs {};

template <int DP>
struct QRegs<bf16, DP> {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> f[DP / 16];
};

// S[16w.., 0..BK) = Q K^T for this warp's 16 rows (tensor cores).
template <int DP, int BK, int LDKV, int LDS>
__device__ __forceinline__ void logits_bf16(const QRegs<bf16, DP>& q,
                                            const bf16* sK, float* sS,
                                            int warp) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      // B = K^T: element (kk', n') is K[16n + n'][16kk + kk'], column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, sK + 16 * n * LDKV + 16 * kk, LDKV);
      wmma::mma_sync(acc[n], q.f[kk], kf, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::store_matrix_sync(sS + 16 * warp * LDS + 16 * n, acc[n], LDS,
                            wmma::mem_row_major);
  }
}

// Same for float32 with FMA: each lane computes 4 rows x 4 keys (BK = 32).
template <int LDKV, int LDS>
__device__ __forceinline__ void logits_f32(const float* qb, int q0, int sq,
                                           int d, const float* sK, float* sS,
                                           int warp, int lane) {
  const int r0 = WROWS * warp + (lane >> 3) * 4;
  const int c0 = (lane & 7) * 4;
  const float* qrow[4];
  bool ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    ok[i] = row < sq;
    qrow[i] = qb + (size_t)(ok[i] ? row : 0) * d;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int dd = 0; dd < d; dd += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = ok[i] ? *reinterpret_cast<const float4*>(qrow[i] + dd)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = *reinterpret_cast<const float4*>(sK + (c0 + j) * LDKV + dd);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sS[(r0 + i) * LDS + c0 + j] = acc[i][j];
}

// O[16w.., :] += P V for this warp's rows (tensor cores, accumulator in smem).
template <int DP, int BK, int LDKV, int LDO, int LDP>
__device__ __forceinline__ void pv_bf16(const bf16* sP, const bf16* sV,
                                        float* sO, int warp) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf[BK / 16];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wmma::load_matrix_sync(pf[kk], sP + 16 * warp * LDP + 16 * kk, LDP);
  }
#pragma unroll 4
  for (int n = 0; n < DP / 16; ++n) {
    float* o = sO + 16 * warp * LDO + 16 * n;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
      wmma::load_matrix_sync(vf, sV + 16 * kk * LDKV + 16 * n, LDKV);
      wmma::mma_sync(acc, pf[kk], vf, acc);
    }
    wmma::store_matrix_sync(o, acc, LDO, wmma::mem_row_major);
  }
}

// Same for float32 with FMA; P is read from the logits buffer (BK = 32).
template <int DP, int LDKV, int LDO, int LDS>
__device__ __forceinline__ void pv_f32(const float* sP, const float* sV,
                                       float* sO, int warp, int lane) {
  const int rb = WROWS * warp;
  for (int c = 4 * lane; c < DP; c += 128) {
    float4 acc[WROWS];
#pragma unroll
    for (int r = 0; r < WROWS; ++r) {
      acc[r] = *reinterpret_cast<const float4*>(sO + (rb + r) * LDO + c);
    }
    for (int kk = 0; kk < 32; ++kk) {
      const float4 v = *reinterpret_cast<const float4*>(sV + kk * LDKV + c);
#pragma unroll
      for (int r = 0; r < WROWS; ++r) {
        const float p = sP[(rb + r) * LDS + kk];
        acc[r].x = fmaf(p, v.x, acc[r].x);
        acc[r].y = fmaf(p, v.y, acc[r].y);
        acc[r].z = fmaf(p, v.z, acc[r].z);
        acc[r].w = fmaf(p, v.w, acc[r].w);
      }
    }
#pragma unroll
    for (int r = 0; r < WROWS; ++r) {
      *reinterpret_cast<float4*>(sO + (rb + r) * LDO + c) = acc[r];
    }
  }
}

__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_out(bf16* dst, float x) {
  *dst = __float2bfloat16(x);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS)
nl_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                   int d, int softmax, float scale) {
  using C = Cfg<T, DP>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sO = reinterpret_cast<float*>(smem + C::kO);
  T* sKV = reinterpret_cast<T*>(smem + C::kKV);
  float* sS = reinterpret_cast<float*>(smem + C::kS);
  bf16* sP = reinterpret_cast<bf16*>(smem + C::kP);
  float* sAlpha = reinterpret_cast<float*>(smem + C::kStats);
  float* sL = sAlpha + BQ;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const size_t b = blockIdx.y;
  const T* qb = q + b * sq * d;
  const T* kb = k + b * sk * d;
  const T* vb = v + b * sk * d;

  QRegs<T, DP> qr;
  if constexpr (C::kBf16) {
    // stage the Q tile through the (not yet used) accumulator buffer
    bf16* stage = reinterpret_cast<bf16*>(sO);
    load_rows<T, DP, BQ, C::LDQ>(stage, qb, q0, sq, d);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wmma::load_matrix_sync(qr.f[kk], stage + 16 * warp * C::LDQ + 16 * kk,
                             C::LDQ);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < BQ * C::LDO; i += NTHREADS) sO[i] = 0.f;

  // softmax bookkeeping: lanes 2r and 2r+1 share row WROWS*warp + r, each
  // taking every other key of the tile
  const int row = WROWS * warp + (lane >> 1);
  const int half = lane & 1;
  float m_run = -INFINITY;  // running max of the scaled logits
  float l_run = 0.f;        // running sum of exp(logit - m_run)
  const float inv_sk = 1.f / (float)sk;

  const int n_tiles = (sk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * BK;
    __syncthreads();  // every warp is done with the previous V tile
    load_rows<T, DP, BK, C::LDKV>(sKV, kb, key0, sk, d);
    __syncthreads();
    if constexpr (C::kBf16) {
      logits_bf16<DP, BK, C::LDKV, C::LDS>(qr, sKV, sS, warp);
    } else {
      logits_f32<C::LDKV, C::LDS>(qb, q0, sq, d, sKV, sS, warp, lane);
    }
    __syncwarp();

    float* srow = sS + row * C::LDS;
    if (softmax) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half;
        const float s = key0 + c < sk ? srow[c] * scale : -INFINITY;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      // every tile holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m_run, mx);
      const float alpha = __expf(m_run - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half;
        const float p = __expf(srow[c] - m_new);
        sum += p;
        if constexpr (C::kBf16) {
          sP[row * C::LDP + c] = __float2bfloat16(p);
        } else {
          srow[c] = p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (half == 0) sAlpha[row] = alpha;
      __syncwarp();
      // rescale this warp's accumulator rows by exp(m_old - m_new)
      for (int r = WROWS * warp; r < WROWS * (warp + 1); ++r) {
        const float a = sAlpha[r];
        if (a != 1.f) {
          for (int c = lane; c < DP; c += 32) sO[r * C::LDO + c] *= a;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half;
        const float p = key0 + c < sk ? srow[c] * inv_sk : 0.f;
        if constexpr (C::kBf16) {
          sP[row * C::LDP + c] = __float2bfloat16(p);
        } else {
          srow[c] = p;
        }
      }
    }
    __syncthreads();  // every warp is done with the K tile
    load_rows<T, DP, BK, C::LDKV>(sKV, vb, key0, sk, d);
    __syncthreads();
    if constexpr (C::kBf16) {
      pv_bf16<DP, BK, C::LDKV, C::LDO, C::LDP>(sP, sKV, sO, warp);
    } else {
      pv_f32<DP, C::LDKV, C::LDO, C::LDS>(sS, sKV, sO, warp, lane);
    }
  }

  if (half == 0) sL[row] = l_run;
  __syncwarp();
  for (int r = WROWS * warp; r < WROWS * (warp + 1); ++r) {
    const int qi = q0 + r;
    if (qi >= sq) break;
    const float inv = softmax ? 1.f / sL[r] : 1.f;
    T* dst = o + (b * sq + qi) * d;
    for (int c = lane; c < d; c += 32) store_out(dst + c, sO[r * C::LDO + c] * inv);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int sq, int sk, int d, int softmax, float scale,
                   cudaStream_t stream) {
  using C = Cfg<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      nl_attn_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, b);
  nl_attn_fwd_kernel<T, DP><<<grid, NTHREADS, C::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, softmax, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int b, int sq, int sk, int d, int softmax, float scale,
                     cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, o, b, sq, sk, d, softmax, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, o, b, sq, sk, d, softmax, scale, stream);
  if (d <= 256) return launch<T, 256>(q, k, v, o, b, sq, sk, d, softmax, scale, stream);
  return launch<T, 512>(q, k, v, o, b, sq, sk, d, softmax, scale, stream);
}

}  // namespace

// q, k, v, o: device pointers (16-byte aligned, contiguous). kind: 0 softmax,
// 1 dot_product. is_bf16: 1 bf16, 0 float32. Requires 1 <= d <= 512,
// d % 8 == 0, sk >= 1, 1 <= b <= 65535. Returns a cudaError_t.
extern "C" int nl_attn_fwd(const void* q, const void* k, const void* v, void* o,
                           int b, int sq, int sk, int d, int kind, float scale,
                           int is_bf16, void* stream) {
  if (b < 1 || b > 65535 || sq < 0 || sk < 1 || d < 8 || d > 512 || d % 8 != 0 ||
      (kind != 0 && kind != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int softmax = kind == 0;
  return (int)(is_bf16 ? launch_d<bf16>(q, k, v, o, b, sq, sk, d, softmax, scale, s)
                       : launch_d<float>(q, k, v, o, b, sq, sk, d, softmax, scale, s));
}
