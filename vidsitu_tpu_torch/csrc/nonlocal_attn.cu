// Non-local attention forward for NVIDIA Hopper (sm_90a). Two kernels: the
// wmma / float32 one first (nl_attn_fwd), then the wgmma one
// (nl_attn_fwd_wgmma, with its own note), which takes bf16 at d in {64, 128,
// 256, 512}. ops/attention.py picks the entry from dtype and d.
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
// This kernel stays as the float32 parity instantiation and for head widths
// the wgmma kernel does not take. wgmma, a K/V ring filled ahead of the
// products and register accumulators are in nl_attn_fwd_wgmma, further down.
// Both forward entries can also write each query row's log-sum-exp of the
// scaled logits, in the log2 domain (lse2 = log2 sum_j 2^(s_j scale log2 e)),
// for the training path's backward, nl_attn_bwd, at the end of the file.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry: nl_attn_fwd (after this kernel), returns cudaGetLastError().

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
                   const T* __restrict__ v, T* __restrict__ o,
                   float* __restrict__ lse, int sq, int sk, int d, int softmax,
                   float scale) {
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
  if (half == 0 && lse != nullptr && q0 + row < sq) {
    // m_run is in the natural domain here (logit * scale)
    lse[b * sq + q0 + row] = (m_run + logf(l_run)) * 1.4426950408889634f;
  }
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int sk, int d, int softmax,
                   float scale, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      nl_attn_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, b);
  nl_attn_fwd_kernel<T, DP><<<grid, NTHREADS, C::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, d, softmax,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int b, int sq, int sk, int d, int softmax,
                     float scale, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, o, lse, b, sq, sk, d, softmax, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, o, lse, b, sq, sk, d, softmax, scale, stream);
  if (d <= 256) return launch<T, 256>(q, k, v, o, lse, b, sq, sk, d, softmax, scale, stream);
  return launch<T, 512>(q, k, v, o, lse, b, sq, sk, d, softmax, scale, stream);
}

}  // namespace

// q, k, v, o: device pointers (16-byte aligned, contiguous). lse: null, or
// (b, sq) float32 that receives each row's log-sum-exp (log2 domain) under
// softmax. kind: 0 softmax, 1 dot_product. is_bf16: 1 bf16, 0 float32.
// Requires 1 <= d <= 512, d % 8 == 0, sk >= 1, 1 <= b <= 65535. Returns a
// cudaError_t.
extern "C" int nl_attn_fwd(const void* q, const void* k, const void* v, void* o,
                           float* lse, int b, int sq, int sk, int d, int kind,
                           float scale, int is_bf16, void* stream) {
  if (b < 1 || b > 65535 || sq < 0 || sk < 1 || d < 8 || d > 512 || d % 8 != 0 ||
      (kind != 0 && kind != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int softmax = kind == 0;
  return (int)(is_bf16 ? launch_d<bf16>(q, k, v, o, lse, b, sq, sk, d, softmax, scale, s)
                       : launch_d<float>(q, k, v, o, lse, b, sq, sk, d, softmax, scale, s));
}

// ===========================================================================
// nl_attn_fwd_wgmma: the same function, redesigned for Hopper's warpgroup
// tensor-core instruction. bf16 only, d in {64, 128, 256, 512}.
//
// Replaces the same TPU kernel (vidsitu_tpu/ops/attention.py:30, reached
// through fused_attention, :61). Bound by operations, as above: 630 FLOP per
// byte at stage 3 against the card's 295, so what counts is how much of the
// time the tensor cores run, and how little else the SM does per key tile.
//
// What the design does about it:
//  * both products are wgmma.mma_async (m64nNk16, bf16 in, float32 out).
//    S = Q K^T reads Q and the K tile from shared memory in the 128-byte
//    swizzled K-major layout; O += P V takes P from registers (the S
//    accumulator's own layout, packed to bf16 in place) and the V tile from
//    shared memory as an MN-major B operand (the transpose flag of the
//    instruction: V stays keys x d, as it lies in device memory);
//  * O (64 x up to 256 float32 = 128 registers a thread), the running max
//    and the running sum live in registers. A row of the accumulator is
//    shared by four lanes, so the row max is two shuffles; the rescale by
//    exp2(m_old - m_new) multiplies registers. No logits, probabilities or
//    statistics pass through shared memory;
//  * K and V tiles arrive in a two-slot ring filled with cp.async by the
//    computing threads one tile ahead: the loads of tile t+1 are issued
//    right after tile t's S product, while the tensor cores work on it, and
//    land during tile t; one __syncthreads a tile. (TMA with a producer warp
//    is the other way to fill the ring; cp.async needs no tensor map
//    (cuTensorMapEncodeTiled) and writes the swizzle itself.)
//  * two warpgroups a block. Up to d = 256 each owns 64 of the block's 128
//    query rows and both share every K/V tile (half the L2 traffic). At
//    d = 512 the accumulator of 64 rows does not fit one warpgroup's
//    registers, so both own the same 64 rows and 256 output columns each;
//    both compute the whole S (the first product doubles: 1.5x the work, no
//    exchange between them). Where they own different rows they take turns
//    at the S product (named barriers), so that one group's softmax runs
//    under the other's products;
//  * key tiles sized to the real key counts: 80 keys up to d = 256
//    (784 = 10 x 80 - 16), 32 at d = 512 (196 = 7 x 32 - 28);
//  * exp2 with scale * log2(e) folded into one factor; dot_product skips the
//    softmax and multiplies S by 1 / Sk before the bf16 conversion;
//  * the epilogue divides by the row sum in registers and stores bf16 through
//    shared memory (the dead Q and ring space) with 16-byte stores; when
//    asked, it also writes the row's log-sum-exp, m + log2(l), for the
//    backward.
// Left for later: TMA loads from a producer warp, which would
// free the registers for a second S accumulator (the next tile's S product
// under this tile's softmax, within one warpgroup).
//
// C entry: nl_attn_fwd_wgmma (bottom of file), returns cudaGetLastError().

namespace wg {

constexpr int kSmemLimit = 232448;  // bytes a block can use on sm_90
constexpr int kSmemAlign = 1024;    // a swizzled tile starts on 1024 bytes
constexpr int kStages = 2;          // slots of the K/V ring
constexpr int kBlockK = 80;         // keys per tile, d <= kSplitAbove
constexpr int kBlockKSplit = 32;    // keys per tile, d > kSplitAbove
constexpr int kSplitAbove = 256;    // widest d one warpgroup accumulates
constexpr int kRowsPerGroup = 64;   // query rows of one warpgroup (wgmma M)
constexpr int kGroups = 2;          // consumer warpgroups a block
constexpr int kThreads = 128 * kGroups;

// Shared-memory budget of one block for head width D.
template <int D>
struct Cfg {
  static constexpr bool kSplit = D > kSplitAbove;
  static constexpr int BK = kSplit ? kBlockKSplit : kBlockK;
  static constexpr int QROWS = kSplit ? kRowsPerGroup : kGroups * kRowsPerGroup;
  static constexpr int NO = kSplit ? D / kGroups : D;  // O columns a warpgroup
  static constexpr int kQBytes = QROWS * D * 2;
  static constexpr int kTileBytes = BK * D * 2;        // one K or one V tile
  static constexpr int kStageBytes = 2 * kTileBytes;   // K then V
  static constexpr int kBytes = kSmemAlign + kQBytes + kStages * kStageBytes;
  static constexpr int LDO = D * 2 + 16;  // epilogue row pitch, bytes
  static_assert(kBytes <= kSmemLimit, "tiles exceed the SM's shared memory");
  static_assert(QROWS * LDO <= kQBytes + kStages * kStageBytes,
                "the epilogue's staging must fit in the dead tiles");
  static_assert(BK % 16 == 0 && D % 64 == 0 && NO <= 256, "wgmma shapes");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// make the landed tiles visible to the tensor cores' (async-proxy) reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// named barriers (id 0 is __syncthreads): sync waits for n threads to have
// arrived or synced on the id, arrive does not wait
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// keep the compiler from moving uses of an accumulator across a fence/wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;  // ex2(-inf) = +0
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo: low 16 bits
  return *reinterpret_cast<uint32_t*>(&p);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. Offsets in bytes:
// K-major operand: sbo = stride between groups of 8 rows, lbo unused;
// MN-major operand: lbo = stride between blocks of 64 columns (MN), sbo =
// stride between groups of 8 rows (K).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D(64 x N) (+)= A(64 x 16) B(16 x N): A and B from shared memory, both
// K-major (B is the K tile: N keys x 16 of d).
template <int N>
struct MmaSS;
// The same with A from registers and B MN-major (the V tile: 16 keys x N).
template <int N>
struct MmaRS;

template <>
struct MmaSS<80> {
  static __device__ __forceinline__ void run(float (&d)[40], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39 "
      "}, %40, %41, p, 1, 1, 0, 0;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaSS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaRS<256> {
  static __device__ __forceinline__ void run(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// Rows [row0, row0 + ROWS) of a (nrows, D) row-major bf16 matrix into a
// swizzled tile: D / 64 column blocks of ROWS x 128 bytes, the 16-byte chunk
// c of row r stored at chunk c ^ (r % 8). Rows past nrows are zero-filled.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src,
                                                int row0, int nrows) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  constexpr int STEPS = (ROWS * CPR + kThreads - 1) / kThreads;
#pragma unroll
  for (int it = 0; it < STEPS; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (ROWS * CPR % kThreads != 0 && i >= ROWS * CPR) break;
    const int r = i / CPR;
    const int c = i % CPR;
    const bool ok = row0 + r < nrows;
    const bf16* g = src + (size_t)(ok ? row0 + r : 0) * D + c * 8;
    const uint32_t s =
        dst + (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    cp_async16(s, g, ok ? 16 : 0);
  }
}

// One ring slot: the K tile, then the V tile, of keys [key0, key0 + BK), as
// one cp.async group (with whatever this thread issued before it).
template <int D>
__device__ __forceinline__ void load_kv_async(uint32_t slot, const bf16* kb,
                                              const bf16* vb, int key0,
                                              int sk) {
  using C = Cfg<D>;
  load_tile_async<C::BK, D>(slot, kb, key0, sk);
  load_tile_async<C::BK, D>(slot + C::kTileBytes, vb, key0, sk);
  cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
nl_attn_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int sq, int sk, int softmax,
                         float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  constexpr int NO = C::NO;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSmemAlign - 1) & ~(uint32_t)(kSmemAlign - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sRing = base + C::kQBytes;

  const int group = threadIdx.x / 128;        // warpgroup
  const int warp = (threadIdx.x % 128) / 32;  // warp of the warpgroup
  const int lane = threadIdx.x % 32;
  const int quad = lane & 3;
  const int q0 = blockIdx.x * C::QROWS;       // first query row of the block
  const int grow = C::kSplit ? 0 : kRowsPerGroup * group;  // group's rows
  const int col0 = C::kSplit ? NO * group : 0;             // group's columns
  const size_t b = blockIdx.y;
  const bf16* qb = q + b * sq * D;
  const bf16* kb = k + b * sk * D;
  const bf16* vb = v + b * sk * D;
  // a warpgroup whose rows all lie past Sq loads its share and computes nothing
  const bool active = q0 + grow < sq;

  load_tile_async<C::QROWS, D>(sQ, qb, q0, sq);
  load_kv_async<D>(sRing, kb, vb, 0, sk);  // one group with Q

  float acc[NO / 2];  // O: rows r and r + 8 of this lane, see the epilogue
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sum
  const float c2 = scale * 1.4426950408889634f;  // scale * log2(e)
  const float inv_sk = 1.f / (float)sk;

  // Where the two warpgroups own different rows they take turns at the first
  // product: group 0 issues its S, then group 1 its own while group 0 does
  // its softmax, and so on, so that one group's softmax runs under the
  // other's products. A turn is a named barrier (1 + group) that the other
  // group arrives on. No turns when group 1 has no rows (the last block of a
  // batch), nor at d = 512, where they measured slower.
  const bool turns = !C::kSplit && q0 + kRowsPerGroup < sq;
  if (turns && group == 1) bar_arrive(1, kThreads);

  const int n_tiles = (sk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * BK;
    const uint32_t sK = sRing + (t % kStages) * C::kStageBytes;
    const uint32_t sV = sK + C::kTileBytes;
    cp_async_wait_all();  // tile t (and Q) have landed, this thread's part
    fence_async_proxy();
    __syncthreads();      // everyone's part; and tile t-1 is no longer read
    const bool more = t + 1 < n_tiles;
    const uint32_t nK = sRing + ((t + 1) % kStages) * C::kStageBytes;
    if (!active) {
      if (more) load_kv_async<D>(nK, kb, vb, key0 + BK, sk);
      continue;
    }

    // S = Q K^T, 64 x BK, one wgmma for every 16 of d
    float s[BK / 2];
    if (turns) bar_sync(1 + group, kThreads);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * 128 * C::QROWS + (kk & 3) * 32;
      const uint32_t koff = (kk >> 2) * 128 * BK + (kk & 3) * 32;
      MmaSS<BK>::run(s, smem_desc(sQ + grow * 128 + off, 16, 1024),
                     smem_desc(sK + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    if (turns) bar_arrive(1 + (group ^ 1), kThreads);
    // the next tile's loads are issued while the tensor cores work on S
    if (more) load_kv_async<D>(nK, kb, vb, key0 + BK, sk);
    wgmma_wait_all();
    fence_regs(s);

    // s[4j + e] is row r, s[4j + 2 + e] row r + 8, key key0 + 8j + 2 quad + e
    const bool tail = key0 + BK > sk;
    if (softmax) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool past = tail && key0 + 8 * j + 2 * quad + e >= sk;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = past ? -INFINITY : s[4 * j + 2 * h + e] * c2;
            s[4 * j + 2 * h + e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // every tile holds a real key, so m_new is finite; the first tile
        // has m_run = -inf: alpha is 0 there, not exp2(-inf - -inf)
        const float m_new = fmaxf(m_run[h], mx[h]);
        alpha[h] = m_run[h] == -INFINITY ? 0.f : fast_exp2(m_run[h] - m_new);
        m_run[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = fast_exp2(s[4 * j + 2 * h + e] - m_run[h]);
            s[4 * j + 2 * h + e] = p;
            sum[h] += p;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + sum[h];
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool past = tail && key0 + 8 * j + 2 * quad + e >= sk;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[4 * j + 2 * h + e] = past ? 0.f : s[4 * j + 2 * h + e] * inv_sk;
          }
        }
      }
    }

    // O += P V: P as the A operand, 16 keys a step (S's accumulator layout
    // is the A layout, 8 accumulator values for every 4 packed registers)
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[8 * kk + 0], s[8 * kk + 1]),
                              pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                              pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                              pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
      MmaRS<NO>::run(acc, pa,
                     smem_desc(sV + (col0 / 64) * 128 * BK + kk * 2048,
                               128 * BK, 1024),
                     1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  // Epilogue: divide by the row sum, stage bf16 rows in shared memory (Q and
  // the ring are dead), store 16 bytes a thread; rows past Sq are not stored.
  __syncthreads();
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float inv = 1.f;
      if (softmax) {
        float l = l_run[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv = 1.f / l;
        // both warpgroups hold the same rows' statistics at d = 512
        const int qi = q0 + grow + 16 * warp + (lane >> 2) + 8 * h;
        if (lse != nullptr && quad == 0 && (!C::kSplit || group == 0) &&
            qi < sq) {
          lse[b * sq + qi] = m_run[h] + log2f(l);
        }
      }
      unsigned char* row =
          smem + (size_t)(grow + 16 * warp + (lane >> 2) + 8 * h) * C::LDO;
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        *reinterpret_cast<uint32_t*>(row + (col0 + 8 * j + 2 * quad) * 2) =
            pack_bf16(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      }
    }
  }
  __syncthreads();
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < C::QROWS * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = i % CPR;
    if (q0 + r < sq) {
      *reinterpret_cast<uint4*>(o + (b * sq + q0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(smem + (size_t)r * C::LDO + c * 16);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int sk, int softmax, float scale,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      nl_attn_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + C::QROWS - 1) / C::QROWS, b);
  nl_attn_fwd_wgmma_kernel<D><<<grid, kThreads, C::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, sk,
      softmax, scale);
  return cudaGetLastError();
}

}  // namespace wg

// The wgmma kernel: bf16 only. q, k, v, o: device pointers (16-byte aligned,
// contiguous). lse: null, or (b, sq) float32 for the rows' log-sum-exp (log2
// domain) under softmax. kind: 0 softmax, 1 dot_product. Requires d in {64,
// 128, 256, 512}, sk >= 1, 1 <= b <= 65535; anything else is
// cudaErrorInvalidValue.
extern "C" int nl_attn_fwd_wgmma(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int b, int sq, int sk,
                                 int d, int kind, float scale, void* stream) {
  if (b < 1 || b > 65535 || sq < 0 || sk < 1 || (kind != 0 && kind != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int softmax = kind == 0;
  switch (d) {
    case 64: return (int)wg::launch<64>(q, k, v, o, lse, b, sq, sk, softmax, scale, s);
    case 128: return (int)wg::launch<128>(q, k, v, o, lse, b, sq, sk, softmax, scale, s);
    case 256: return (int)wg::launch<256>(q, k, v, o, lse, b, sq, sk, softmax, scale, s);
    case 512: return (int)wg::launch<512>(q, k, v, o, lse, b, sq, sk, softmax, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ===========================================================================
// nl_attn_bwd: the gradient of the same function, for the training path.
//
// The TPU package has no backward kernel: training there runs jax.grad of
// the einsum version (vidsitu_tpu/ops/attention.py:121 _einsum_attention),
// which is what this matches. Given Q, K, V, the forward's output O, the
// output gradient dO and, for softmax, each query row's log-sum-exp lse2
// (log2 domain, written by either forward entry), it computes
//   softmax:     P = 2^(Q K^T scale log2 e - lse2), D = rowsum(dO o O),
//                dP = dO V^T, dS = scale P o (dP - D),
//                dV = P^T dO, dK = dS^T Q, dQ = dS K;
//   dot_product: P = Q K^T / Sk, dS = dO V^T / Sk, the same three products;
// float32 logits and accumulators, dQ / dK / dV in the inputs' type.
//
// What bounds it on an H100: five Sq x Sk x d products (S, dP, dV, dK, dQ),
// 5.0e11 operations at the I3D-NL stage-3 shape for 80 clips against 0.64 GB
// of q / k / v / o / dO and gradients in bf16: bound by operations, as the
// forward. The (Sq x Sk) matrices P and dS are the bytes worth avoiding.
//
// What the design does about it, simply (FlashAttention-2's layout, no
// atomics, so every result is deterministic):
//  * three launches on the caller's stream: D as one warp per row, then a
//    pass over key tiles that streams every query tile past its K and V and
//    accumulates dK and dV, then a pass over query tiles that streams every
//    key tile past its Q and dO and accumulates dQ. S and dP are computed in
//    both passes (seven products instead of five), and never leave the SM;
//  * the accumulators (float32) and every tile live in shared memory; the
//    products are WMMA 16x16x16 on bf16 with float32 accumulation (8 warps
//    take the 16x16 output tiles in turn), plain FMA in float32;
//  * P and dS are rounded to the input type before the products that take
//    them, as the forward rounds P;
//  * the tiles are sized to the shared memory at each head width: at d = 512
//    a 64-row tile of K, V, Q and dO alone is 256 KB, so the dK / dV pass
//    keeps 16 keys against 32 queries there.
// Left for later: wgmma with register accumulators, a cp.async ring, and S
// computed once for both passes.
//
// C entry: nl_attn_bwd (bottom of file), returns cudaGetLastError().

namespace bwd {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

// Tiles of the two passes for element type T, head width DP (d rounded up to
// 64, 128, 256 or 512) and pass (KV: dK / dV, else dQ). NA rows belong to the
// block (keys for KV, queries for dQ), NS rows stream past them. S and dP are
// always (query rows x key columns).
template <typename T, int DP, bool KV>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int NA = kBf16 ? (DP >= 512 ? (KV ? 16 : 32)
                                     : DP == 256 ? (KV ? 32 : 64) : 64)
                                  : (DP >= 512 ? 16 : 32);
  static constexpr int NS = kBf16 ? (DP >= 512 ? 32
                                     : DP == 256 ? (KV ? 64 : 32) : 64)
                                  : (DP >= 512 ? 16 : 32);
  static constexpr int NACC = KV ? 2 : 1;       // float accumulators
  static constexpr int QROWS = KV ? NS : NA;    // query rows of S
  static constexpr int KCOLS = KV ? NA : NS;    // key columns of S
  static constexpr int LDT = DP + 16 / (int)sizeof(T);  // input tiles (T)
  static constexpr int LDA = DP + 4;                    // accumulators
  static constexpr int LDS = KCOLS + 4;                 // S, dP (float)
  static constexpr int LDP = KCOLS + 16 / (int)sizeof(T);  // P, dS (T)
  static constexpr size_t kOwn = 0;
  static constexpr size_t kAcc = kOwn + align128(sizeof(T) * 2 * NA * LDT);
  static constexpr size_t kStr =
      kAcc + align128(sizeof(float) * NACC * NA * LDA);
  static constexpr size_t kS = kStr + align128(sizeof(T) * 2 * NS * LDT);
  static constexpr size_t kdP = kS + align128(sizeof(float) * QROWS * LDS);
  static constexpr size_t kP = kdP + align128(sizeof(float) * QROWS * LDS);
  static constexpr size_t kdS = kP + align128(sizeof(T) * QROWS * LDP);
  static constexpr size_t kStat = kdS + align128(sizeof(T) * QROWS * LDP);
  static constexpr size_t kBytes = kStat + sizeof(float) * 2 * QROWS;
  static_assert(kBytes <= 232448, "tiles exceed the SM's shared memory");
  static_assert(NA % 16 == 0 && NS % 16 == 0, "WMMA tiles");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + ROWS) of a (nrows, d) row-major matrix into a shared
// tile of pitch LD, 16 bytes per thread and step; rows past nrows and
// columns past d (up to DP) are zero-filled.
template <typename T, int DP, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int nrows, int d) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DP / VEC;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += kBwdThreads) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && c < d) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// C (M x N, float) = or += op(A) op(B), op(A) M x K, op(B) K x N. A is
// stored M x K row-major, or K x M when TA (its transpose is used); B is
// stored K x N, or N x K when TB. bf16: WMMA, the warps take the 16x16
// output tiles in turn; the accumulator passes through shared memory.
template <int M, int N, int K, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void mma_block(float* C, int ldc, const bf16* A,
                                          int lda, const bf16* B, int ldb) {
  using LA = typename std::conditional<TA, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = typename std::conditional<TB, wmma::col_major,
                                       wmma::row_major>::type;
  constexpr int TN = N / 16;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * TN; t += kBwdWarps) {
    const int i = t / TN;
    const int j = t % TN;
    float* c = C + 16 * i * ldc + 16 * j;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (ACC) {
      wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.f);
    }
#pragma unroll 4
    for (int kk = 0; kk < K / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(
          a, TA ? A + 16 * kk * lda + 16 * i : A + 16 * i * lda + 16 * kk, lda);
      wmma::load_matrix_sync(
          b, TB ? B + 16 * j * ldb + 16 * kk : B + 16 * kk * ldb + 16 * j, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
  }
}

// The same in float32 with FMA, one output element per thread and step.
template <int M, int N, int K, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void mma_block(float* C, int ldc, const float* A,
                                          int lda, const float* B, int ldb) {
  for (int e = threadIdx.x; e < M * N; e += kBwdThreads) {
    const int m = e / N;
    const int n = e % N;
    float s = ACC ? C[m * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = TA ? A[k * lda + m] : A[m * lda + k];
      const float b = TB ? B[n * ldb + k] : B[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

// From S and dP (R query rows x CC key columns, float): P (when sP is set)
// and dS, rounded to T; zero outside the (Sq, Sk) rectangle.
template <typename T, int R, int CC>
__device__ __forceinline__ void probs_and_ds(
    const float* sS, const float* sdP, int lds, T* sP, T* sdS, int ldp,
    const float* sLse, const float* sD, int q0, int sq, int k0, int sk,
    int softmax, float c2, float scale, float inv_sk) {
  for (int e = threadIdx.x; e < R * CC; e += kBwdThreads) {
    const int r = e / CC;
    const int c = e % CC;
    float p = 0.f;
    float ds = 0.f;
    if (q0 + r < sq && k0 + c < sk) {
      const float s = sS[r * lds + c];
      const float dp = sdP[r * lds + c];
      if (softmax) {
        p = exp2f(s * c2 - sLse[r]);
        ds = scale * p * (dp - sD[r]);
      } else {
        p = s * inv_sk;
        ds = dp * inv_sk;
      }
    }
    if (sP != nullptr) sP[r * ldp + c] = from_f32<T>(p);
    sdS[r * ldp + c] = from_f32<T>(ds);
  }
}

// Rows [row0, row0 + ROWS) of an accumulator (pitch lda) into a (nrows, d)
// row-major matrix of T; rows past nrows are not stored.
template <typename T, int ROWS>
__device__ __forceinline__ void store_tile(T* dst, const float* acc, int lda,
                                           int row0, int nrows, int d) {
  for (int i = threadIdx.x; i < ROWS * d; i += kBwdThreads) {
    const int r = i / d;
    const int c = i % d;
    if (row0 + r < nrows) {
      dst[(size_t)(row0 + r) * d + c] = from_f32<T>(acc[r * lda + c]);
    }
  }
}

// D = rowsum(dO o O) in float32, one warp per row.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
nl_attn_bwd_rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * kBwdWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = o + (size_t)row * d;
  const T* g = dout + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(to_f32(a[c]), to_f32(g[c]), s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// Loads the statistics of query rows [q0, q0 + ROWS); zeros past Sq and
// for dot_product.
template <int ROWS>
__device__ __forceinline__ void load_stats(float* sLse, float* sD,
                                           const float* lse,
                                           const float* delta, size_t b,
                                           int q0, int sq, int softmax) {
  for (int r = threadIdx.x; r < ROWS; r += kBwdThreads) {
    const bool ok = softmax && q0 + r < sq;
    sLse[r] = ok ? lse[b * sq + q0 + r] : 0.f;
    sD[r] = ok ? delta[b * sq + q0 + r] : 0.f;
  }
}

// dK and dV of one key tile: every query tile streams past it.
template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads)
nl_attn_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, int d, int softmax,
                      float scale) {
  using C = Cfg<T, DP, true>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + C::kOwn);
  T* sV = sK + C::NA * C::LDT;
  float* accK = reinterpret_cast<float*>(smem + C::kAcc);
  float* accV = accK + C::NA * C::LDA;
  T* sQ = reinterpret_cast<T*>(smem + C::kStr);
  T* sdO = sQ + C::NS * C::LDT;
  float* sS = reinterpret_cast<float*>(smem + C::kS);
  float* sdP = reinterpret_cast<float*>(smem + C::kdP);
  T* sP = reinterpret_cast<T*>(smem + C::kP);
  T* sdS = reinterpret_cast<T*>(smem + C::kdS);
  float* sLse = reinterpret_cast<float*>(smem + C::kStat);
  float* sD = sLse + C::QROWS;

  const int k0 = blockIdx.x * C::NA;
  const size_t b = blockIdx.y;
  const T* qb = q + b * sq * d;
  const T* dob = dout + b * sq * d;
  load_tile<T, DP, C::NA, C::LDT>(sK, k + b * sk * d, k0, sk, d);
  load_tile<T, DP, C::NA, C::LDT>(sV, v + b * sk * d, k0, sk, d);
  for (int i = threadIdx.x; i < 2 * C::NA * C::LDA; i += kBwdThreads) {
    accK[i] = 0.f;
  }
  const float c2 = scale * 1.4426950408889634f;
  const float inv_sk = 1.f / (float)sk;
  for (int q0 = 0; q0 < sq; q0 += C::NS) {
    __syncthreads();  // the previous tile's products are done
    load_tile<T, DP, C::NS, C::LDT>(sQ, qb, q0, sq, d);
    load_tile<T, DP, C::NS, C::LDT>(sdO, dob, q0, sq, d);
    load_stats<C::NS>(sLse, sD, lse, delta, b, q0, sq, softmax);
    __syncthreads();
    mma_block<C::NS, C::NA, DP, false, true, false>(sS, C::LDS, sQ, C::LDT,
                                                    sK, C::LDT);
    mma_block<C::NS, C::NA, DP, false, true, false>(sdP, C::LDS, sdO, C::LDT,
                                                    sV, C::LDT);
    __syncthreads();
    probs_and_ds<T, C::NS, C::NA>(sS, sdP, C::LDS, sP, sdS, C::LDP, sLse, sD,
                                  q0, sq, k0, sk, softmax, c2, scale, inv_sk);
    __syncthreads();
    mma_block<C::NA, DP, C::NS, true, false, true>(accV, C::LDA, sP, C::LDP,
                                                   sdO, C::LDT);
    mma_block<C::NA, DP, C::NS, true, false, true>(accK, C::LDA, sdS, C::LDP,
                                                   sQ, C::LDT);
  }
  __syncthreads();
  store_tile<T, C::NA>(dk + b * sk * d, accK, C::LDA, k0, sk, d);
  store_tile<T, C::NA>(dv + b * sk * d, accV, C::LDA, k0, sk, d);
}

// dQ of one query tile: every key tile streams past it.
template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads)
nl_attn_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int sq, int sk, int d, int softmax, float scale) {
  using C = Cfg<T, DP, false>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + C::kOwn);
  T* sdO = sQ + C::NA * C::LDT;
  float* accQ = reinterpret_cast<float*>(smem + C::kAcc);
  T* sK = reinterpret_cast<T*>(smem + C::kStr);
  T* sV = sK + C::NS * C::LDT;
  float* sS = reinterpret_cast<float*>(smem + C::kS);
  float* sdP = reinterpret_cast<float*>(smem + C::kdP);
  T* sdS = reinterpret_cast<T*>(smem + C::kdS);
  float* sLse = reinterpret_cast<float*>(smem + C::kStat);
  float* sD = sLse + C::QROWS;

  const int q0 = blockIdx.x * C::NA;
  const size_t b = blockIdx.y;
  const T* kb = k + b * sk * d;
  const T* vb = v + b * sk * d;
  load_tile<T, DP, C::NA, C::LDT>(sQ, q + b * sq * d, q0, sq, d);
  load_tile<T, DP, C::NA, C::LDT>(sdO, dout + b * sq * d, q0, sq, d);
  load_stats<C::NA>(sLse, sD, lse, delta, b, q0, sq, softmax);
  for (int i = threadIdx.x; i < C::NA * C::LDA; i += kBwdThreads) {
    accQ[i] = 0.f;
  }
  const float c2 = scale * 1.4426950408889634f;
  const float inv_sk = 1.f / (float)sk;
  for (int k0 = 0; k0 < sk; k0 += C::NS) {
    __syncthreads();  // the previous tile's products are done
    load_tile<T, DP, C::NS, C::LDT>(sK, kb, k0, sk, d);
    load_tile<T, DP, C::NS, C::LDT>(sV, vb, k0, sk, d);
    __syncthreads();
    mma_block<C::NA, C::NS, DP, false, true, false>(sS, C::LDS, sQ, C::LDT,
                                                    sK, C::LDT);
    mma_block<C::NA, C::NS, DP, false, true, false>(sdP, C::LDS, sdO, C::LDT,
                                                    sV, C::LDT);
    __syncthreads();
    probs_and_ds<T, C::NA, C::NS>(sS, sdP, C::LDS, static_cast<T*>(nullptr),
                                  sdS, C::LDP, sLse, sD, q0, sq, k0, sk,
                                  softmax, c2, scale, inv_sk);
    __syncthreads();
    mma_block<C::NA, DP, C::NS, false, false, true>(accQ, C::LDA, sdS, C::LDP,
                                                    sK, C::LDT);
  }
  __syncthreads();
  store_tile<T, C::NA>(dq + b * sq * d, accQ, C::LDA, q0, sq, d);
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int b, int sq,
                   int sk, int d, int softmax, float scale,
                   cudaStream_t stream) {
  using KV = Cfg<T, DP, true>;
  using Q = Cfg<T, DP, false>;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  if (softmax) {
    const int rows = b * sq;
    nl_attn_bwd_rowdot_kernel<T>
        <<<(rows + kBwdWarps - 1) / kBwdWarps, kBwdThreads, 0, stream>>>(
            static_cast<const T*>(o), tdo, delta, rows, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      nl_attn_bwd_kv_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KV::kBytes);
  if (err != cudaSuccess) return err;
  nl_attn_bwd_kv_kernel<T, DP>
      <<<dim3((sk + KV::NA - 1) / KV::NA, b), kBwdThreads, KV::kBytes,
         stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
                   static_cast<T*>(dv), sq, sk, d, softmax, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(nl_attn_bwd_q_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Q::kBytes);
  if (err != cudaSuccess) return err;
  nl_attn_bwd_q_kernel<T, DP>
      <<<dim3((sq + Q::NA - 1) / Q::NA, b), kBwdThreads, Q::kBytes, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), sq, sk, d,
          softmax, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int b, int sq,
                     int sk, int d, int softmax, float scale,
                     cudaStream_t stream) {
  if (d <= 64) {
    return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk,
                         d, softmax, scale, stream);
  }
  if (d <= 128) {
    return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk,
                          d, softmax, scale, stream);
  }
  if (d <= 256) {
    return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk,
                          d, softmax, scale, stream);
  }
  return launch<T, 512>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk,
                        d, softmax, scale, stream);
}

}  // namespace bwd

// The backward. q, k, v, o, dout (the output's gradient), dq, dk, dv: device
// pointers of the forward's type (16-byte aligned, contiguous), q / o / dout
// / dq (b, sq, d), k / v / dk / dv (b, sk, d). lse: the forward's (b, sq)
// float32 log-sum-exp, delta: (b, sq) float32 scratch; both are needed for
// softmax and unused (may be null) for dot_product. kind: 0 softmax,
// 1 dot_product. is_bf16: 1 bf16, 0 float32. Requires 8 <= d <= 512,
// d % 8 == 0, sq >= 1, sk >= 1, 1 <= b <= 65535. Three launches on the
// stream; returns a cudaError_t.
extern "C" int nl_attn_bwd(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, void* dq, void* dk, void* dv, int b,
                           int sq, int sk, int d, int kind, float scale,
                           int is_bf16, void* stream) {
  if (b < 1 || b > 65535 || sq < 1 || sk < 1 || d < 8 || d > 512 ||
      d % 8 != 0 || (kind != 0 && kind != 1) ||
      (kind == 0 && (lse == nullptr || delta == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int softmax = kind == 0;
  return (int)(is_bf16
                   ? bwd::launch_d<bf16>(q, k, v, o, dout, lse, delta, dq, dk,
                                         dv, b, sq, sk, d, softmax, scale, s)
                   : bwd::launch_d<float>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, b, sq, sk, d, softmax, scale,
                                          s));
}
