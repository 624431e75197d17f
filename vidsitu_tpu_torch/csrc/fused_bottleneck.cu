// Fused inference bottleneck block for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernels fused_bottleneck_frames
// (benchmarks/probe_fused_bottleneck.py:108) and fused_multi
// (benchmarks/micro4.py:84). Per frame, with BatchNorm folded into the
// weights:
//
//   h1  = relu(x  @ wa + ba)                 1x1 conv, Cin  -> Cmid
//   h2  = relu(conv3x3_same(h1, wb) + bb)    3x3 conv, Cmid -> Cmid
//   y   = h2 @ wc + bc                       1x1 conv, Cmid -> Cout
//   res = x @ wp + bp   (projection)   or   x   (identity, Cin == Cout)
//   out = relu(y + res)
//
// x and out are channels-last frames (B, H, W, C); sums are float32, h1 and
// h2 are rounded to the input type, the shifts are float32.
//
// What bounds it: bytes. The unfused chain writes and re-reads h1, h2 and y
// in device memory; this kernel reads x once and writes out once, and keeps
// h1 and h2 in shared memory.
//
// Design. A whole frame's intermediates do not fit an SM's 227 KB of shared
// memory (the TPU kernel keeps them in VMEM), so a block takes a spatial
// tile of TH x TW outputs of one frame with a one-pixel halo:
//   1. the (TH+2) x (TW+2) halo tile of x goes to shared memory, zero outside
//      the frame;
//   2. conv a is computed on the whole halo tile (recomputed at tile edges);
//      h1 is forced to zero at halo pixels outside the frame, which is the
//      3x3's SAME zero padding (the TPU kernel's roll-and-mask);
//   3. the 3x3 is nine shifted products over h1 in shared memory;
//   4. conv c, the residual (identity read back from device memory, or the
//      projection from the x tile already in shared memory), the final relu
//      and the store, masked to the frame.
// bf16 runs on the tensor cores (nvcuda::wmma 16x16x16, float32
// accumulators) with a 4 x 16 tile, so that every 16-row operand of the 3x3
// is one run of 16 neighbouring halo pixels with a constant stride; float32
// runs scalar FMAs with a 4 x 8 tile (the parity instantiation). In the
// tensor path a warp owns one 16-column strip of a product and up to four
// 16-row tiles of it, so a weight fragment is loaded once for several
// independent accumulators; the bf16 weights arrive output-channel major,
// which makes a lane's pair of neighbouring k one 32-bit word.
//
// A second kernel, designed for this card (wgmma, persistent blocks, resident
// weights, a rolling h1 ring), follows this one in the file with its own note
// and two entries of its own: fused_bottleneck_frames_wgmma and
// fused_bottleneck_multi_wgmma. It takes bf16 at Cmid = 64 without
// projection; this kernel takes everything else and is the float32 parity
// instantiation.
//
// Two entry points share this kernel:
//   fused_bottleneck_frames  one block per (tile, frame); the folded weights
//                            are streamed from device memory / L2 as the
//                            products need them (at s3 they would not fit);
//   fused_bottleneck_multi   one block per `frames_per_step` frames, walking
//                            all their tiles; it first stages in shared
//                            memory as many of wa, wb, wc (in that order) as
//                            fit beside the tiles, so they are read once per
//                            block instead of once per tile. No projection.
//
// Plain C interface (built with nvcc alone, loaded with ctypes). Each entry
// returns 0, a cudaError_t, or -2 when the shapes need more shared memory
// than a block can have.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TH = 4;                // output rows of a tile
constexpr int SMEM_LIMIT = 232448;   // 227 KB, the most a block can ask for

struct Params {
  const void* x;
  const void* wa;
  const float* ba;
  const void* wb;
  const float* bb;
  const void* wc;
  const float* bc;
  const void* wp;
  const float* bp;
  void* out;
  int B, H, W;
  int Cin, CinP;  // CinP: rows of wa / wp, Cin rounded up to the MMA depth
  int Cmid, Cout;
  int has_proj;
  int multi, frames_per_block;
  int tiles_x, tiles_y;
  int stage_a, stage_b, stage_c;
  int off_xs, off_h1, off_h2, off_scr, off_wa, off_wb, off_wc;
};

// the scalar path is instantiated for float32 only
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  return v;
}

// 16-byte copies of `bytes` (a multiple of 16) by the whole block
__device__ __forceinline__ void block_copy16(void* dst, const void* src,
                                             int bytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS) d[i] = s[i];
}

template <typename T, int TW>
__global__ void __launch_bounds__(THREADS)
fused_bottleneck_kernel(const Params p) {
  constexpr bool kTensor = std::is_same<T, __nv_bfloat16>::value;
  constexpr int HWID = TW + 2;                 // halo tile width
  constexpr int HP = (TH + 2) * HWID;          // halo pixels
  constexpr int HP_PAD = (HP + 15) / 16 * 16;
  constexpr int P = TH * TW;                   // output pixels
  constexpr int PAD = 32 / sizeof(T);          // row padding, 32 bytes
  constexpr int VEC = 16 / sizeof(T);
  static_assert(!kTensor || TW == 16, "one MMA row tile per output row");

  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem + p.off_xs);
  T* h1 = reinterpret_cast<T*>(smem + p.off_h1);
  T* h2 = reinterpret_cast<T*>(smem + p.off_h2);

  const int tid = threadIdx.x;
  const int H = p.H, W = p.W;
  const int Cin = p.Cin, CinP = p.CinP, Cmid = p.Cmid, Cout = p.Cout;
  const int XS_LD = CinP + PAD;
  const int H_LD = Cmid + PAD;
  const T* x = reinterpret_cast<const T*>(p.x);
  T* out = reinterpret_cast<T*>(p.out);
  const T* wa = reinterpret_cast<const T*>(p.wa);
  const T* wb = reinterpret_cast<const T*>(p.wb);
  const T* wc = reinterpret_cast<const T*>(p.wc);
  const T* wp = reinterpret_cast<const T*>(p.wp);
  const float* ba = p.ba;
  const float* bb = p.bb;
  const float* bc = p.bc;
  const float* bp = p.bp;

  // weights kept in shared memory for the block's whole walk (multi entry);
  // the first __syncthreads below orders these writes before their use
  if (p.stage_a) {
    block_copy16(smem + p.off_wa, wa, CinP * Cmid * (int)sizeof(T));
    wa = reinterpret_cast<const T*>(smem + p.off_wa);
  }
  if (p.stage_b) {
    block_copy16(smem + p.off_wb, wb, 9 * Cmid * Cmid * (int)sizeof(T));
    wb = reinterpret_cast<const T*>(smem + p.off_wb);
  }
  if (p.stage_c) {
    block_copy16(smem + p.off_wc, wc, Cmid * Cout * (int)sizeof(T));
    wc = reinterpret_cast<const T*>(smem + p.off_wc);
  }

  const int n_tiles = p.tiles_x * p.tiles_y;
  int f_begin, f_end, t_begin, t_end;
  if (p.multi) {
    f_begin = blockIdx.x * p.frames_per_block;
    f_end = min(p.B, f_begin + p.frames_per_block);
    t_begin = 0;
    t_end = n_tiles;
  } else {
    f_begin = blockIdx.y;
    f_end = f_begin + 1;
    t_begin = blockIdx.x;
    t_end = t_begin + 1;
  }

  for (int f = f_begin; f < f_end; ++f) {
    for (int t = t_begin; t < t_end; ++t) {
      const int ty0 = (t / p.tiles_x) * TH;
      const int tx0 = (t % p.tiles_x) * TW;
      const T* xf = x + (size_t)f * H * W * Cin;
      T* of = out + (size_t)f * H * W * Cout;

      // 1. halo tile of x -> shared memory (zero outside the frame, in the
      //    padded channels and in the padded rows)
      {
        const int nvec = CinP / VEC;
        for (int idx = tid; idx < HP_PAD * nvec; idx += THREADS) {
          const int hp = idx / nvec;
          const int c = (idx - hp * nvec) * VEC;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (hp < HP && c < Cin) {
            const int gy = ty0 - 1 + hp / HWID;
            const int gx = tx0 - 1 + hp % HWID;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W)
              v = *reinterpret_cast<const uint4*>(
                  xf + ((size_t)gy * W + gx) * Cin + c);
          }
          *reinterpret_cast<uint4*>(xs + (size_t)hp * XS_LD + c) = v;
        }
      }
      __syncthreads();

      if constexpr (kTensor) {
        using namespace nvcuda;
        using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16,
                                     __nv_bfloat16, wmma::row_major>;
        // the bf16 weights arrive output-channel major, (N, K), so that a
        // lane's pair of neighbouring k lies in one 32-bit word
        using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16,
                                     __nv_bfloat16, wmma::col_major>;
        using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
        const int warp = tid >> 5, lane = tid & 31;
        float* scr = reinterpret_cast<float*>(smem + p.off_scr) + warp * 256;
        const int r = lane >> 1;        // row of the 16x16 tile
        const int c0 = (lane & 1) * 8;  // first of this lane's 8 columns
        const int nt_mid = Cmid / 16;
        // A warp owns one 16-column strip of the output and several 16-row
        // tiles of it: a weight fragment is loaded once for all of them, and
        // their accumulators are independent chains for the tensor cores.

        // 2. conv a on the halo tile: (HP_PAD x CinP) @ (CinP x Cmid)
        {
          constexpr int MB = 4;
          constexpr int N_MT = HP_PAD / 16;
          constexpr int N_MG = (N_MT + MB - 1) / MB;
          for (int item = warp; item < N_MG * nt_mid; item += WARPS) {
            const int mg = item / nt_mid, nt = item - mg * nt_mid;
            FragC acc[MB];
#pragma unroll
            for (int j = 0; j < MB; ++j) wmma::fill_fragment(acc[j], 0.0f);
            for (int k = 0; k < CinP; k += 16) {
              FragB b;
              wmma::load_matrix_sync(b, wa + (size_t)nt * 16 * CinP + k, CinP);
#pragma unroll
              for (int j = 0; j < MB; ++j) {
                const int mt = mg * MB + j;
                if (mt < N_MT) {
                  FragA a;
                  wmma::load_matrix_sync(a, xs + (size_t)mt * 16 * XS_LD + k,
                                         XS_LD);
                  wmma::mma_sync(acc[j], a, b, acc[j]);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < MB; ++j) {
              const int mt = mg * MB + j;
              if (mt >= N_MT) break;
              wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
              __syncwarp();
              const int hp = mt * 16 + r;
              const int gy = ty0 - 1 + hp / HWID;
              const int gx = tx0 - 1 + hp % HWID;
              const bool inside =
                  hp < HP && gy >= 0 && gy < H && gx >= 0 && gx < W;
              const int n0 = nt * 16 + c0;
              __align__(16) __nv_bfloat16 o[8];
#pragma unroll
              for (int i = 0; i < 8; ++i)
                o[i] = __float2bfloat16(
                    inside ? fmaxf(scr[r * 16 + c0 + i] + ba[n0 + i], 0.0f)
                           : 0.0f);
              *reinterpret_cast<uint4*>(h1 + (size_t)hp * H_LD + n0) =
                  *reinterpret_cast<const uint4*>(o);
              __syncwarp();
            }
          }
        }
        __syncthreads();

        // 3. the 3x3: nine shifted (16 x Cmid) @ (Cmid x Cmid) products per
        //    output row; a row's operand for tap (dh, dw) is the run of 16
        //    halo pixels starting at (row + dh, dw)
        {
          constexpr int MB = 2;
          constexpr int N_MG = TH / MB;
          for (int item = warp; item < N_MG * nt_mid; item += WARPS) {
            const int mg = item / nt_mid, nt = item - mg * nt_mid;
            FragC acc[MB];
#pragma unroll
            for (int j = 0; j < MB; ++j) wmma::fill_fragment(acc[j], 0.0f);
            for (int tap = 0; tap < 9; ++tap) {
              const int dh = tap / 3, dw = tap - dh * 3;
              const __nv_bfloat16* wt =
                  wb + ((size_t)tap * Cmid + nt * 16) * Cmid;
              for (int k = 0; k < Cmid; k += 16) {
                FragB b;
                wmma::load_matrix_sync(b, wt + k, Cmid);
#pragma unroll
                for (int j = 0; j < MB; ++j) {
                  const int mt = mg * MB + j;
                  FragA a;
                  wmma::load_matrix_sync(
                      a, h1 + (size_t)((mt + dh) * HWID + dw) * H_LD + k, H_LD);
                  wmma::mma_sync(acc[j], a, b, acc[j]);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < MB; ++j) {
              const int mt = mg * MB + j;
              wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
              __syncwarp();
              const int n0 = nt * 16 + c0;
              __align__(16) __nv_bfloat16 o[8];
#pragma unroll
              for (int i = 0; i < 8; ++i)
                o[i] = __float2bfloat16(
                    fmaxf(scr[r * 16 + c0 + i] + bb[n0 + i], 0.0f));
              *reinterpret_cast<uint4*>(h2 + (size_t)(mt * 16 + r) * H_LD + n0) =
                  *reinterpret_cast<const uint4*>(o);
              __syncwarp();
            }
          }
        }
        __syncthreads();

        // 4. conv c + residual + relu + store: a warp takes all TH row tiles
        //    of its 16 output channels
        const int nt_out = Cout / 16;
        for (int nt = warp; nt < nt_out; nt += WARPS) {
          FragC acc[TH];
#pragma unroll
          for (int j = 0; j < TH; ++j) wmma::fill_fragment(acc[j], 0.0f);
          for (int k = 0; k < Cmid; k += 16) {
            FragB b;
            wmma::load_matrix_sync(b, wc + (size_t)nt * 16 * Cmid + k, Cmid);
#pragma unroll
            for (int j = 0; j < TH; ++j) {
              FragA a;
              wmma::load_matrix_sync(a, h2 + (size_t)j * 16 * H_LD + k, H_LD);
              wmma::mma_sync(acc[j], a, b, acc[j]);
            }
          }
          if (p.has_proj) {
            for (int k = 0; k < CinP; k += 16) {
              FragB b;
              wmma::load_matrix_sync(b, wp + (size_t)nt * 16 * CinP + k, CinP);
#pragma unroll
              for (int j = 0; j < TH; ++j) {
                // the tile's own pixels of x: halo row j + 1, from column 1
                FragA a;
                wmma::load_matrix_sync(
                    a, xs + (size_t)((j + 1) * HWID + 1) * XS_LD + k, XS_LD);
                wmma::mma_sync(acc[j], a, b, acc[j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < TH; ++j) {
            wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
            __syncwarp();
            const int gy = ty0 + j, gx = tx0 + r;
            if (gy < H && gx < W) {
              const int n0 = nt * 16 + c0;
              const size_t pix = (size_t)gy * W + gx;
              __align__(16) __nv_bfloat16 res[8];
              if (!p.has_proj)
                *reinterpret_cast<uint4*>(res) =
                    *reinterpret_cast<const uint4*>(xf + pix * Cin + n0);
              __align__(16) __nv_bfloat16 o[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float y = scr[r * 16 + c0 + i] + bc[n0 + i];
                const float rs =
                    p.has_proj ? bp[n0 + i] : __bfloat162float(res[i]);
                o[i] = __float2bfloat16(fmaxf(y + rs, 0.0f));
              }
              *reinterpret_cast<uint4*>(of + pix * Cout + n0) =
                  *reinterpret_cast<const uint4*>(o);
            }
            __syncwarp();
          }
        }
      } else {
        // scalar float32-accumulating version of the same four steps
        for (int idx = tid; idx < HP * Cmid; idx += THREADS) {
          const int hp = idx / Cmid, n = idx - hp * Cmid;
          const int gy = ty0 - 1 + hp / HWID;
          const int gx = tx0 - 1 + hp % HWID;
          float s = 0.0f;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
            const T* xr = xs + (size_t)hp * XS_LD;
            for (int k = 0; k < Cin; ++k)
              s = fmaf(to_f32(xr[k]), to_f32(wa[(size_t)k * Cmid + n]), s);
            s = fmaxf(s + ba[n], 0.0f);
          }
          h1[(size_t)hp * H_LD + n] = from_f32<T>(s);
        }
        __syncthreads();
        for (int idx = tid; idx < P * Cmid; idx += THREADS) {
          const int pix = idx / Cmid, n = idx - pix * Cmid;
          const int ty = pix / TW, tx = pix - ty * TW;
          float s = 0.0f;
          for (int tap = 0; tap < 9; ++tap) {
            const int dh = tap / 3, dw = tap - dh * 3;
            const T* hr = h1 + (size_t)((ty + dh) * HWID + tx + dw) * H_LD;
            const T* wt = wb + (size_t)tap * Cmid * Cmid + n;
            for (int k = 0; k < Cmid; ++k)
              s = fmaf(to_f32(hr[k]), to_f32(wt[(size_t)k * Cmid]), s);
          }
          h2[(size_t)pix * H_LD + n] = from_f32<T>(fmaxf(s + bb[n], 0.0f));
        }
        __syncthreads();
        for (int idx = tid; idx < P * Cout; idx += THREADS) {
          const int pix = idx / Cout, co = idx - pix * Cout;
          const int ty = pix / TW, tx = pix - ty * TW;
          const int gy = ty0 + ty, gx = tx0 + tx;
          if (gy >= H || gx >= W) continue;
          const T* hr = h2 + (size_t)pix * H_LD;
          float y = 0.0f;
          for (int k = 0; k < Cmid; ++k)
            y = fmaf(to_f32(hr[k]), to_f32(wc[(size_t)k * Cout + co]), y);
          y += bc[co];
          const T* xr = xs + (size_t)((ty + 1) * HWID + tx + 1) * XS_LD;
          float rs;
          if (p.has_proj) {
            rs = 0.0f;
            for (int k = 0; k < Cin; ++k)
              rs = fmaf(to_f32(xr[k]), to_f32(wp[(size_t)k * Cout + co]), rs);
            rs += bp[co];
          } else {
            rs = to_f32(xf[((size_t)gy * W + gx) * Cin + co]);
          }
          of[((size_t)gy * W + gx) * Cout + co] =
              from_f32<T>(fmaxf(y + rs, 0.0f));
        }
      }
      __syncthreads();  // the tiles are reused by the next (frame, tile)
    }
  }
}

template <typename T, int TW>
int launch(Params p, int stage_weights, int* staged_mask,
           cudaStream_t stream) {
  constexpr bool kTensor = std::is_same<T, __nv_bfloat16>::value;
  constexpr int HP_PAD = ((TH + 2) * (TW + 2) + 15) / 16 * 16;
  constexpr int P = TH * TW;
  constexpr int PAD = 32 / sizeof(T);
  const long xs_ld = p.CinP + PAD, h_ld = p.Cmid + PAD;
  long off = 0;
  auto take = [&off](long bytes) {
    const long o = off;
    off += (bytes + 127) / 128 * 128;
    return (int)o;
  };
  const long xs_bytes = HP_PAD * xs_ld * (long)sizeof(T);
  const long h2_bytes = P * h_ld * (long)sizeof(T);
  p.off_xs = take(xs_bytes);
  p.off_h1 = take(HP_PAD * h_ld * (long)sizeof(T));
  // without a projection the x tile is dead once conv a is done (the
  // identity residual is read back from device memory), so h2 takes its place
  if (!p.has_proj && h2_bytes <= xs_bytes)
    p.off_h2 = p.off_xs;
  else
    p.off_h2 = take(h2_bytes);
  p.off_scr = take(kTensor ? WARPS * 256 * (long)sizeof(float) : 0);
  p.stage_a = p.stage_b = p.stage_c = 0;
  p.off_wa = p.off_wb = p.off_wc = 0;
  if (stage_weights) {
    const long wa_bytes = (long)p.CinP * p.Cmid * sizeof(T);
    const long wb_bytes = 9L * p.Cmid * p.Cmid * sizeof(T);
    const long wc_bytes = (long)p.Cmid * p.Cout * sizeof(T);
    if (off + wa_bytes <= SMEM_LIMIT) { p.off_wa = take(wa_bytes); p.stage_a = 1; }
    if (off + wb_bytes <= SMEM_LIMIT) { p.off_wb = take(wb_bytes); p.stage_b = 1; }
    if (off + wc_bytes <= SMEM_LIMIT) { p.off_wc = take(wc_bytes); p.stage_c = 1; }
  }
  if (staged_mask)
    *staged_mask = p.stage_a | (p.stage_b << 1) | (p.stage_c << 2);
  if (off > SMEM_LIMIT) return -2;
  p.tiles_x = (p.W + TW - 1) / TW;
  p.tiles_y = (p.H + TH - 1) / TH;
  auto kernel = fused_bottleneck_kernel<T, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)off);
  if (err != cudaSuccess) return (int)err;
  dim3 grid;
  if (p.multi)
    grid = dim3((p.B + p.frames_per_block - 1) / p.frames_per_block);
  else
    grid = dim3(p.tiles_x * p.tiles_y, p.B);
  kernel<<<grid, THREADS, (size_t)off, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch(Params p, int is_bf16, int stage_weights, int* staged_mask,
             void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, 16>(p, stage_weights, staged_mask, s);
  return launch<float, 8>(p, stage_weights, staged_mask, s);
}

}  // namespace

// x (B, H, W, Cin), out (B, H, W, Cout), contiguous, bf16 or float32
// (is_bf16); ba, bb, bc, bp float32; weights in the type of x, wp null
// without a projection.
//   float32: wa (Cin, Cmid), wb (3, 3, Cmid, Cmid), wc (Cmid, Cout),
//            wp (Cin, Cout), input-channel major; Cin % 4 == 0, CinP == Cin.
//   bf16:    the same matrices output-channel major: wa (Cmid, CinP),
//            wb (3, 3, Cmid_out, Cmid_in), wc (Cout, Cmid), wp (Cout, CinP),
//            columns Cin..CinP-1 of wa / wp zero; Cin % 8 == 0,
//            CinP % 16 == 0, Cmid % 16 == 0, Cout % 16 == 0.
extern "C" int fused_bottleneck_frames(
    const void* x, const void* wa, const float* ba, const void* wb,
    const float* bb, const void* wc, const float* bc, const void* wp,
    const float* bp, void* out, int B, int H, int W, int Cin, int CinP,
    int Cmid, int Cout, int is_bf16, void* stream) {
  Params p{};
  p.x = x; p.wa = wa; p.ba = ba; p.wb = wb; p.bb = bb; p.wc = wc; p.bc = bc;
  p.wp = wp; p.bp = bp; p.out = out;
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.CinP = CinP; p.Cmid = Cmid;
  p.Cout = Cout;
  p.has_proj = wp != nullptr;
  p.multi = 0;
  p.frames_per_block = 1;
  return dispatch(p, is_bf16, 0, nullptr, stream);
}

// The same block without projection (Cin == Cout), `frames_per_step` frames
// per thread block, weights staged in shared memory where they fit;
// *staged_mask (host memory, may be null) gets bit 0 / 1 / 2 for wa / wb / wc.
extern "C" int fused_bottleneck_multi(
    const void* x, const void* wa, const float* ba, const void* wb,
    const float* bb, const void* wc, const float* bc, void* out, int B, int H,
    int W, int Cin, int CinP, int Cmid, int Cout, int frames_per_step,
    int is_bf16, int* staged_mask, void* stream) {
  if (frames_per_step < 1 || Cin != Cout) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x; p.wa = wa; p.ba = ba; p.wb = wb; p.bb = bb; p.wc = wc; p.bc = bc;
  p.wp = nullptr; p.bp = nullptr; p.out = out;
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.CinP = CinP; p.Cmid = Cmid;
  p.Cout = Cout;
  p.has_proj = 0;
  p.multi = 1;
  p.frames_per_block = frames_per_step;
  return dispatch(p, is_bf16, 1, staged_mask, stream);
}

// ===========================================================================
// fused_bottleneck_frames_wgmma / fused_bottleneck_multi_wgmma: the same
// block, redesigned for Hopper. bf16, Cmid = 64, no projection, Cin = Cout
// in {128, 256}, W <= 61 (slow-s2: 56 x 56, 256 -> 64 -> 256). Everything
// else stays on the kernel above (float32, the projection, Cmid = 128, odd
// widths).
//
// Replaces the same two TPU kernels (benchmarks/probe_fused_bottleneck.py:108
// and benchmarks/micro4.py:84). Bound by bytes: 136 FLOP for every byte of x
// and out at slow-s2, against the card's 295, so the least time is x read
// once and out written once; what the design has to do is keep the tensor
// cores fed from shared memory while those bytes move.
//
// What the design does about it:
//  * persistent blocks: grid = min(SMs, units), one block an SM, two
//    warpgroups. wa, wb and wc are loaded once per block for the whole
//    launch into shared memory in the 128-byte swizzled K-major layout that
//    wgmma's B descriptor reads (the wrapper hands them output-channel
//    major);
//  * the flat, width-padded order. A group of G consecutive frames is one
//    stream of positions F = frame * (H + 2) * (W + 2) + (row + 1) * (W + 2)
//    + (col + 1): one zero row above and below each frame, one zero column
//    left and right. A 3x3 tap is then one constant offset
//    (dh - 1) * (W + 2) + (dw - 1) for every row of a 64-row tile, and tiles
//    are runs of 64 consecutive positions whatever the frame's width. Outputs
//    at pad positions are computed and not stored (2 of 58 columns);
//  * a step is 128 positions, 64 for each warpgroup. conv a of step s fills
//    h1 for positions [128 s, 128 s + 128); conv b and conv c of step s then
//    produce the outputs for [128 s - 64, 128 s + 64), whose taps reach
//    W + 3 <= 64 positions either way. h1 lives in a ring of 256 positions
//    in shared memory, zero at every position outside a frame, so conv a is
//    computed once per pixel: no halo recompute along the walk;
//  * all three products are wgmma.mma_async (bf16 in, float32 accumulators in
//    registers, which start at the shift instead of zero). conv a: m64n64k16,
//    A the x chunk and B wa, both from shared memory. The 3x3: m64n64k16,
//    nine taps of four k-steps, A from registers: ldmatrix with one address a
//    row reads h1 at the tap's offset (a shift by one position is free, the
//    ring wraps per row, the 16-byte chunks of a position are XOR-swizzled by
//    position % 8 so neither the stores nor ldmatrix meet bank conflicts), B
//    the tap's 64 x 64 of wb. The tap's fragments are double-buffered: the
//    next tap's ldmatrix runs under this tap's products. conv c: m64n128k16
//    in two passes of 128 output channels (64 accumulator registers a thread,
//    not 128), A from registers;
//  * h2 never touches shared memory: the 3x3's accumulator, after relu and
//    rounding to bf16 in registers (one cvt.rn.relu.bf16x2 a pair), is already
//    laid out as wgmma's A operand;
//  * x arrives through cp.async into a ring of three 8 KB slots for each
//    warpgroup (its 64 positions x 64 channels, swizzled). Out-of-frame
//    positions are zero-filled (source size 0). conv a of step s + 1 runs
//    inside step s in two halves, before and after the 3x3, so that every
//    slot is refilled with a long stretch of other work between the load and
//    its use, and h1 of step s + 1 is in the ring before conv c of step s;
//  * the identity residual is read again, from L2: the shared-memory budget
//    (weights 136 KB + h1 32 KB + x ring 48 KB + staging 8 KB + shifts 1.5 KB
//    = 225.5 KB of 227) has no room to keep a step of x (64 KB) until its
//    outputs are due one step later. For the same reason the projection (wp:
//    64 KB more at Cin 80) and Cmid = 128 (wb alone 288 KB) are not taken
//    here;
//  * the accumulator's layout gives a thread 4 bytes of a row, a quad 16.
//    Residual and result therefore pass through a staging tile of 8 rows x
//    128 bytes a warp: the residual is loaded 16 bytes a lane, four whole
//    128-byte lines a warp, written to the tile and read back by ldmatrix in
//    the accumulator's layout; the result is written by stmatrix and read
//    back 16 bytes a lane for stores of four whole lines a warp. The residual
//    loads are started one or two at a time between the taps and between the
//    stores, never as a burst;
//  * the step's code is kept small (rolled loops over conv c's passes and the
//    x chunks, counted (group, step) instead of 64-bit divisions, multiply-high
//    divisions by W + 2 and the frame size): unrolled it outgrew the
//    instruction cache and every phase slowed down;
//  * work is cut into units of one step and dealt in equal contiguous runs,
//    so the grid does not depend on frames_per_step and no SM idles while
//    another has a frame left. A block whose run starts inside a group first
//    runs the step before without storing anything (its h1 is needed).
// On this card the two entries differ only in the walk: `frames` streams one
// frame a group, `multi` frames_per_step frames a group (fewer steps at the
// group's end: 27 steps a frame at 56 x 56, 26.5 a frame in groups of 4).
//
// Measured and not kept: both conv c passes in flight at once (128
// accumulator registers: spills), conv a of the next step chunk by chunk
// between the taps and the passes (255 registers, and ptxas serialises the
// products), 4-byte residual loads and stores straight from the accumulator's
// layout, quad shuffles instead of the staging tile, the outputs by the bulk
// copy engine (cp.async.bulk of 128 bytes a row). Left for later: the two
// warpgroups run the same phase at the same time (two block barriers a step),
// so the tensor cores idle during the epilogues; a TMA producer warp.
//
// The wgmma / cp.async helpers repeat those of nonlocal_attn.cu (each source
// builds alone, with no shared header).

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kSmemLimit = 232448;  // bytes a block can use on sm_90
constexpr int kSmemAlign = 1024;    // a swizzled tile starts on 1024 bytes
constexpr int kGroups = 2;          // consumer warpgroups a block
constexpr int kThreads = 128 * kGroups;
constexpr int kCmid = 64;           // the bottleneck width taken
constexpr int kTileM = 64;          // positions of one warpgroup's tile (wgmma M)
constexpr int kStepM = kGroups * kTileM;  // positions of one step
constexpr int kLag = 64;            // outputs trail conv a by this many positions
constexpr int kMaxW = kLag - 3;     // a tap reaches W + 3 positions
constexpr int kRing = 256;          // positions of the h1 ring
constexpr int kChunkK = 64;         // input channels of one x chunk
constexpr int kXStages = 3;         // slots of each warpgroup's x ring
constexpr int kRowBytes = 128;      // one position: 64 bf16 channels
constexpr int kNC = 128;            // output channels of one conv c pass
constexpr int kStageCols = 64;      // output channels a warp stages at a time
constexpr int kBarH1 = 3;           // barrier ids 3..6: h1 written, by warpgroup and parity
constexpr int kBarRead = 7;         // barrier ids 7..10: the ring read, likewise
static_assert(kStepM + kLag + kMaxW + 3 <= kRing,
              "the ring holds a step, the lag and a tap's reach");
static_assert(kCmid * 2 == kRowBytes && kChunkK * 2 == kRowBytes, "one swizzled row");

// Shared-memory budget of one block for C = Cin = Cout.
template <int C>
struct Layout {
  static constexpr int kChunks = C / kChunkK;
  static constexpr int kWaBytes = C * kCmid * 2;
  static constexpr int kWbBytes = 9 * kCmid * kCmid * 2;
  static constexpr int kWcBytes = kCmid * C * 2;
  static constexpr int kH1Bytes = kRing * kRowBytes;
  static constexpr int kXSlotBytes = kTileM * kRowBytes;
  static constexpr int kXBytes = kGroups * kXStages * kXSlotBytes;
  static constexpr int kShiftBytes = (2 * kCmid + C) * 4;
  // a warp's 8 rows x kStageCols channels on their way in and out
  static constexpr int kStageBytes = (kThreads / 32) * 8 * kStageCols * 2;
  static constexpr int kOffWa = 0;
  static constexpr int kOffWb = kOffWa + kWaBytes;
  static constexpr int kOffWc = kOffWb + kWbBytes;
  static constexpr int kOffH1 = kOffWc + kWcBytes;
  static constexpr int kOffX = kOffH1 + kH1Bytes;
  static constexpr int kOffShift = kOffX + kXBytes;
  static constexpr int kOffStage = kOffShift + kShiftBytes;
  static constexpr int kBytes = kSmemAlign + kOffStage + kStageBytes;
  static_assert(kBytes <= kSmemLimit, "the budget exceeds the SM's shared memory");
  static_assert(C % kNC == 0 && C % kChunkK == 0, "wgmma shapes");
};

struct Params {
  const bf16* x;
  const bf16* wa;
  const float* ba;
  const bf16* wb;
  const float* bb;
  const bf16* wc;
  const float* bc;
  bf16* out;
  int B, H, W;
  int G;            // frames of a group
  int WP, FS;       // W + 2; (H + 2) * (W + 2), positions of one frame
  unsigned mWP, mFS;  // floor(2^32 / d) + 1: n / d == umulhi(n, m) while n * d < 2^32
  int spg;          // steps of a group
  int units;        // groups * spg
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make landed tiles visible to the tensor cores' (async-proxy) reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// named barriers (id 0 is __syncthreads): sync waits until n threads have
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
// relu, round to bf16 and pack (lo in the low 16 bits) in one instruction
__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
// 16 bytes through the read-only path, executed where it stands
__device__ __forceinline__ uint4 ld_nc_v4(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
// the store counterpart of ldmatrix_x4
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
// four 8 x 8 bf16 matrices, one row address a lane: lanes 8i..8i+7 address
// matrix i, register i of every lane receives its share of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, groups of 8 rows 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// byte offset of the 16-byte chunk `c` of row `r` in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

// D(64 x 64) (+)= A(64 x 16) B(16 x 64), A and B from shared memory, both
// K-major.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

// D(64 x 64) (+)= A(64 x 16) B(16 x 64), A from registers (four packed
// bf16 pairs a thread), B from shared memory, K-major.
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t b,
                                            int scale_d) {
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
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
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
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
}

// D(64 x 128) (+)= A(64 x 16) B(16 x 128), A from registers (four packed
// bf16 pairs a thread), B from shared memory, K-major.
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t b,
                                            int scale_d) {
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
}
// Pixel index (frame * H + row) * W + col of stream position F of group
// `grp`, or -1 where F lies on a pad row or column, before the group's first
// position, or past the last frame.
__device__ __forceinline__ int pixel_of(const Params& p, int grp, int F) {
  if (F < 0) return -1;
  const int fl = (int)__umulhi((unsigned)F, p.mFS);
  const int f = F - fl * p.FS;
  const int frame = grp * p.G + fl;
  if (fl >= p.G || frame >= p.B) return -1;
  const int rr = (int)__umulhi((unsigned)f, p.mWP);
  const int j = f - rr * p.WP;
  if (rr < 1 || rr > p.H || j < 1 || j > p.W) return -1;
  return (frame * p.H + rr - 1) * p.W + j - 1;
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
fused_bottleneck_wgmma_kernel(const Params p) {
  using L = Layout<C>;
  constexpr int KC = L::kChunks;
  constexpr int NH = C / kNC;  // conv c passes
  static_assert(NH == 1 || NH == 2, "conv c is written for one or two passes");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSmemAlign - 1) & ~(uint32_t)(kSmemAlign - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sWa = base + L::kOffWa;
  const uint32_t sWb = base + L::kOffWb;
  const uint32_t sWc = base + L::kOffWc;
  const uint32_t sH1 = base + L::kOffH1;
  unsigned char* h1 = smem + L::kOffH1;
  float* s_ba = reinterpret_cast<float*>(smem + L::kOffShift);
  float* s_bb = s_ba + kCmid;
  float* s_bc = s_bb + kCmid;

  const int tid = threadIdx.x;
  const int group = tid / 128;        // warpgroup
  const int t = tid % 128;            // thread of the warpgroup
  const int warp = t / 32;            // warp of the warpgroup
  const int lane = tid % 32;
  const int quad = lane & 3;
  const uint32_t sX = base + L::kOffX + group * kXStages * L::kXSlotBytes;
  // this warp's staging tile: 8 rows x 64 channels
  unsigned char* stage = smem + L::kOffStage + (tid / 32) * (8 * kStageCols * 2);
  const uint32_t sStage = base + L::kOffStage + (tid / 32) * (8 * kStageCols * 2);

  // the weights, once for the whole launch (one cp.async group), and the shifts
  for (int i = tid; i < kCmid * (C / 8); i += kThreads) {
    const int r = i / (C / 8), c = i % (C / 8);
    cp_async16(sWa + (c >> 3) * (kCmid * kRowBytes) + swz(r, c & 7),
               p.wa + (size_t)r * C + c * 8, 16);
  }
  for (int i = tid; i < 9 * kCmid * 8; i += kThreads) {
    const int r = i / 8, c = i % 8;  // r = tap * 64 + output channel
    cp_async16(sWb + swz(r, c), p.wb + (size_t)r * kCmid + c * 8, 16);
  }
  for (int i = tid; i < C * 8; i += kThreads) {
    const int r = i / 8, c = i % 8;
    cp_async16(sWc + swz(r, c), p.wc + (size_t)r * kCmid + c * 8, 16);
  }
  cp_async_commit();
  for (int i = tid; i < kCmid; i += kThreads) {
    s_ba[i] = p.ba[i];
    s_bb[i] = p.bb[i];
  }
  for (int i = tid; i < C; i += kThreads) s_bc[i] = p.bc[i];

  // this block's run of units; a run that starts inside a group begins with
  // the step before (its h1 is read by the first unit's taps), which stores
  // nothing
  const int u0 = (int)((long long)p.units * blockIdx.x / gridDim.x);
  const int u1 = (int)((long long)p.units * (blockIdx.x + 1) / gridDim.x);
  const int v0 = u0 - ((u0 % p.spg) != 0 ? 1 : 0);
  // (group, step) of a unit: divided once here, counted up from then on
  struct Unit {
    int grp, s;
  };
  const Unit first{v0 / p.spg, v0 % p.spg};
  auto after = [&](Unit u) {
    return u.s + 1 == p.spg ? Unit{u.grp + 1, 0} : Unit{u.grp, u.s + 1};
  };

  // the x loader: chunks of 64 positions x 64 channels in the order they are
  // consumed; a thread copies the same 16-byte piece of four rows
  const int ld_row = t / 8;    // + 16 * it
  const int ld_piece = t % 8;
  int ld_v = v0;
  Unit ld_u = first;
  int ld_chunk = 0;
  int ld_slot = 0;
  int ld_pix[4];
  auto decode_rows = [&]() {
    const int F0 = ld_u.s * kStepM + group * kTileM + ld_row;
#pragma unroll
    for (int it = 0; it < 4; ++it) ld_pix[it] = pixel_of(p, ld_u.grp, F0 + 16 * it);
  };
  auto start_chunk = [&]() {
    if (ld_v < u1) {
      const uint32_t dst = sX + ld_slot * L::kXSlotBytes;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const bool ok = ld_pix[it] >= 0;
        const bf16* src = p.x + (size_t)(ok ? ld_pix[it] : 0) * C +
                          ld_chunk * kChunkK + ld_piece * 8;
        cp_async16(dst + swz(ld_row + 16 * it, ld_piece), src, ok ? 16 : 0);
      }
      if (++ld_chunk == KC) {
        ld_chunk = 0;
        ld_u = after(ld_u);
        if (++ld_v < u1) decode_rows();
      }
    }
    cp_async_commit();  // one group a call, loads or none: the waits count groups
    ld_slot = ld_slot + 1 == kXStages ? 0 : ld_slot + 1;
  };
  if (ld_v < u1) decode_rows();
#pragma unroll 1
  for (int i = 0; i < kXStages; ++i) start_chunk();
  cp_async_wait<kXStages>();  // the weights' group
  fence_async_proxy();
  __syncthreads();

  // ldmatrix: lanes 8i..8i+7 address matrix i; matrices 0 / 1 are rows 0-7 /
  // 8-15 of the warp's 16, matrices 2 / 3 the same rows 8 channels further
  const int lm_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lm_hi = lane >> 4;
  const int row0 = 16 * warp + (lane >> 2);  // accumulator rows row0, row0 + 8
  int cons_slot = 0;

  // conv a's accumulator starts at the shift: acc[4 j + 2 hh + e] is channel
  // 8 j + 2 quad + e of row row0 + 8 hh
  float acc_a[32];
  auto init_acc_a = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 sh = *reinterpret_cast<const float2*>(s_ba + 8 * j + 2 * quad);
      acc_a[4 * j] = acc_a[4 * j + 2] = sh.x;
      acc_a[4 * j + 1] = acc_a[4 * j + 3] = sh.y;
    }
  };
  // the four products of chunk c on the next slot, queued and not waited for
  auto conv_a_chunk = [&](int c) {
    const uint32_t slot = sX + cons_slot * L::kXSlotBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss_n64(acc_a, smem_desc(slot + kk * 32),
                 smem_desc(sWa + c * (kCmid * kRowBytes) + kk * 32), 1);
    cons_slot = cons_slot + 1 == kXStages ? 0 : cons_slot + 1;
  };
  // half of a step's conv a: every chunk started so far has landed
  auto conv_a_half = [&](int c0) {
    cp_async_wait<0>();  // this thread's parts
    fence_async_proxy();
    bar_sync(1 + group, 128);  // the warpgroup's
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC / 2; ++c) conv_a_chunk(c0 + c);
    wgmma_commit();
  };
  // refill the slots of a half whose products every warp has waited for
  auto refill_half = [&]() {
    bar_sync(1 + group, 128);
#pragma unroll 1
    for (int c = 0; c < KC / 2; ++c) start_chunk();
  };
  // h1 of step u from the accumulator to the ring, zero outside the frames.
  // The run's steps take the ring's two halves in turn (`half`: the step's
  // number in the run, mod 2), whatever their number in their group: a
  // group's first step follows the last step of the group before.
  auto write_h1 = [&](Unit u, int half) {
    const int grp = u.grp, s = u.s;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int F = s * kStepM + group * kTileM + row0 + 8 * hh;
      const bool inside = pixel_of(p, grp, F) >= 0;
      const int pos = half * kStepM + group * kTileM + row0 + 8 * hh;
      unsigned char* dst = h1 + pos * kRowBytes + quad * 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t w = pack_relu_bf16(acc_a[4 * j + 2 * hh], acc_a[4 * j + 2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dst + ((j ^ (pos & 7)) << 4)) = inside ? w : 0u;
      }
    }
  };

  // the run's first step: conv a chunk by chunk, each slot refilled at once
  init_acc_a();
#pragma unroll 1
  for (int c = 0; c < KC; ++c) {
    cp_async_wait<kXStages - 1>();
    fence_async_proxy();
    bar_sync(1 + group, 128);
    fence_regs(acc_a);
    wgmma_fence();
    conv_a_chunk(c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_a);
    bar_sync(1 + group, 128);  // every warp has finished with the slot
    start_chunk();
  }
  write_h1(first, 0);
  // The two warpgroups meet at no block barrier. Each tells the other when it
  // has written h1 of a step and when its 3x3 has read the ring for a step
  // (barrier ids by warpgroup and the step's parity: one arrives, the other
  // syncs), so that one may run up to a step ahead, and its epilogue runs
  // under the other's products.
  auto signal = [&](int id) {
    __threadfence_block();
    bar_arrive(id, kThreads);
  };
  const int other = group ^ 1;
  signal(kBarH1 + 2 * group);

  // Step v. h1 of its positions is in the ring, and the ring of x holds the
  // next three chunks. The 3x3, conv c and the stores of the positions 64
  // behind; conv a of step v + 1 goes in two halves, before and after the
  // 3x3, so that every slot of x is refilled with a long stretch of work
  // between the load and its use: the first half's slots during the 3x3 (used
  // after it), the second half's before conv c (used in the next step). After
  // the run's last step the chunks are empty and their products are not used.
  Unit unit = first;
  for (int v = v0; v < u1; ++v, unit = after(unit)) {
    const int grp = unit.grp, s = unit.s;
    const int par = (v - v0) & 1;
    bar_sync(kBarH1 + 2 * other + par, kThreads);  // the other's h1 of step v is in the ring

    const int Fo = s * kStepM - kLag + group * kTileM;
    // The rows this lane moves between device memory and the warp's staging
    // tile: of the 8-row half hh, row lane / 8 + 4 k, 16 bytes of it (chunk
    // lane % 8 of a 64-channel group), so that a warp's load or store covers
    // four rows of 128 contiguous bytes. A run's warm-up step stores nothing.
    const int trow = lane >> 3, tchunk = lane & 7;
    int pix[2][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int k = 0; k < 2; ++k)
        pix[hh][k] = v < u0 ? -1
                            : pixel_of(p, grp, Fo + 16 * warp + 8 * hh + trow + 4 * k);
    }
    // The identity residual of pass h, read again from L2 well before its
    // use, one 16-byte piece a call: piece e = 4 g + 2 hh + k is channels
    // 128 h + 64 g + 8 tchunk .. + 7 of row (hh, k). The pieces are requested one
    // or two at a time between other work: a burst of them fills the SM's
    // queue of outstanding loads, and everything behind it waits.
    auto load_residual = [&](uint4 (&r)[2][2][2], int h, int e) {
      const int g = e >> 2, hh = (e >> 1) & 1, k = e & 1;
      const bool ok = pix[hh][k] >= 0;
      const bf16* src =
          p.x + (size_t)(ok ? pix[hh][k] : 0) * C + h * kNC + kStageCols * g + 8 * tchunk;
      r[g][hh][k] = ok ? ld_nc_v4(src) : make_uint4(0u, 0u, 0u, 0u);
    };
    // out = relu(acc + residual), rounded (the accumulator started at bc), 8
    // rows x 64 channels at a time through the warp's staging tile (8 rows of
    // 128 bytes, chunk c of row r at chunk c ^ r: no bank conflicts). The
    // residual goes in as it was loaded and comes out through ldmatrix in the
    // accumulator's layout; the result goes in through stmatrix and out as 16
    // bytes a lane.
    auto store_pass = [&](float (&acc)[64], uint4 (&r)[2][2][2], uint4 (&next)[2][2][2],
                          int h) {
      const int mrow = lane & 7, mmat = lane >> 3;  // ldmatrix / stmatrix: row, matrix
#pragma unroll
      for (int g = 0; g < 2; ++g) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          __syncwarp();  // the tile's last readers are done
#pragma unroll
          for (int k = 0; k < 2; ++k)
            *reinterpret_cast<uint4*>(stage + swz(trow + 4 * k, tchunk)) = r[g][hh][k];
          __syncwarp();
          uint32_t w[2][4];
          ldmatrix_x4(w[0], sStage + swz(mrow, mmat));
          ldmatrix_x4(w[1], sStage + swz(mrow, 4 + mmat));
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int j = 8 * g + i;
            const uint32_t rw = w[i >> 2][i & 3];
            w[i >> 2][i & 3] = pack_relu_bf16(
                acc[4 * j + 2 * hh] + __uint_as_float(rw << 16),
                acc[4 * j + 2 * hh + 1] + __uint_as_float(rw & 0xffff0000u));
          }
          __syncwarp();
          stmatrix_x4(sStage + swz(mrow, mmat), w[0][0], w[0][1], w[0][2], w[0][3]);
          stmatrix_x4(sStage + swz(mrow, 4 + mmat), w[1][0], w[1][1], w[1][2], w[1][3]);
          __syncwarp();
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const uint4 v4 = *reinterpret_cast<const uint4*>(stage + swz(trow + 4 * k, tchunk));
            if (pix[hh][k] >= 0)
              *reinterpret_cast<uint4*>(p.out + (size_t)pix[hh][k] * C + h * kNC +
                                        kStageCols * g + 8 * tchunk) = v4;
          }
          if (h + 1 < NH) {
            load_residual(next, h + 1, 4 * g + 2 * hh);
            load_residual(next, h + 1, 4 * g + 2 * hh + 1);
          }
        }
      }
    };
    uint4 res0[2][2][2];

    // conv a of step v + 1, first half
    init_acc_a();
    fence_regs(acc_a);
    conv_a_half(0);

    // the 3x3 on positions [128 s - 64, 128 s + 64): nine taps, A by ldmatrix
    float acc_b[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 sh = *reinterpret_cast<const float2*>(s_bb + 8 * j + 2 * quad);
      acc_b[4 * j] = acc_b[4 * j + 2] = sh.x;
      acc_b[4 * j + 1] = acc_b[4 * j + 3] = sh.y;
    }
    {
      uint32_t afr[2][4][4];
      const int P0 = par * kStepM - kLag + group * kTileM + 16 * warp + lm_row;  // in the ring
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int d = (tap / 3 - 1) * p.WP + (tap % 3 - 1);
        const int pos = (P0 + d) & (kRing - 1);
        const uint32_t row = sH1 + pos * kRowBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(afr[tap & 1][kk], row + (((2 * kk + lm_hi) ^ (pos & 7)) << 4));
        fence_regs(acc_b);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs_n64(acc_b, afr[tap & 1][kk][0], afr[tap & 1][kk][1],
                     afr[tap & 1][kk][2], afr[tap & 1][kk][3],
                     smem_desc(sWb + tap * (kCmid * kRowBytes) + kk * 32), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the tap before: its fragments may be overwritten
        if (tap == 1) refill_half();  // conv a's first half is done as well
        if (tap < 8) load_residual(res0, 0, tap);
      }
      wgmma_wait<0>();
      fence_regs(acc_b);
    }
    // this warpgroup has read the ring for step v (the second one's last
    // signal would meet no wait)
    if (group == 0 || v + 1 < u1) signal(kBarRead + 2 * group + par);

    // conv a of step v + 1, second half, under the packing of h2
    conv_a_half(KC / 2);
    // h2 = relu(acc_b), rounded, packed as conv c's A operand: k-step kk
    // takes channels 16 kk .. 16 kk + 15, i.e. accumulator registers 8 kk ..
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = pack_relu_bf16(acc_b[2 * i], acc_b[2 * i + 1]);
    wgmma_wait<0>();
    fence_regs(acc_a);
    refill_half();  // with its barrier, this warpgroup's warps are past the 3x3
    // h1 of step v + 1 overwrites positions that the other warpgroup read
    // last in step v - 1 (the first warpgroup's rows) or in step v (the
    // second's)
    if (group == 1) bar_sync(kBarRead + par, kThreads);
    else if (v > v0) bar_sync(kBarRead + 2 + (par ^ 1), kThreads);
    write_h1(after(unit), par ^ 1);
    if (v + 1 < u1) signal(kBarH1 + 2 * group + (par ^ 1));

    // conv c in passes of 128 output channels (a rolled loop: the step's
    // code has to stay in the instruction cache); the next pass's residual
    // is requested piece by piece between this pass's stores
#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      float acc_c[64];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 sh = *reinterpret_cast<const float2*>(s_bc + h * kNC + 8 * j + 2 * quad);
        acc_c[4 * j] = acc_c[4 * j + 2] = sh.x;
        acc_c[4 * j + 1] = acc_c[4 * j + 3] = sh.y;
      }
      fence_regs(acc_c);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs_n128(acc_c, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                    smem_desc(sWc + h * (kNC * kRowBytes) + kk * 32), 1);
      wgmma_commit();
      uint4 res1[2][2][2];
      wgmma_wait<0>();
      fence_regs(acc_c);
      store_pass(acc_c, res0, res1, h);
      if (h + 1 < NH) {
#pragma unroll
        for (int i = 0; i < 8; ++i) (&res0[0][0][0])[i] = (&res1[0][0][0])[i];
      }
    }
  }
  cp_async_wait<0>();
}

template <int C>
int launch(Params p, cudaStream_t stream) {
  using L = Layout<C>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_bottleneck_wgmma_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(p.units < sms ? p.units : sms);
  fused_bottleneck_wgmma_kernel<C><<<grid, kThreads, L::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// frames_per_group frames are one stream of positions; see the header note.
int dispatch(const void* x, const void* wa, const float* ba, const void* wb,
             const float* bb, const void* wc, const float* bc, void* out,
             int B, int H, int W, int Cin, int Cmid, int Cout,
             int frames_per_group, void* stream) {
  if (B < 1 || H < 1 || W < 1 || W > kMaxW || Cmid != kCmid || Cin != Cout ||
      frames_per_group < 1)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.wa = static_cast<const bf16*>(wa);
  p.ba = ba;
  p.wb = static_cast<const bf16*>(wb);
  p.bb = bb;
  p.wc = static_cast<const bf16*>(wc);
  p.bc = bc;
  p.out = static_cast<bf16*>(out);
  p.B = B; p.H = H; p.W = W;
  p.WP = W + 2;
  p.FS = (H + 2) * p.WP;
  if (p.FS >= 32768) return (int)cudaErrorInvalidValue;
  p.mWP = (unsigned)((1ull << 32) / p.WP) + 1;
  p.mFS = (unsigned)((1ull << 32) / p.FS) + 1;
  // positions stay below 2^32 / FS, where the multiply-high division is
  // exact: a longer group is walked as shorter ones (the result is the same)
  const long long most = ((1ll << 32) / p.FS - 512) / p.FS;
  p.G = frames_per_group < B ? frames_per_group : B;
  if (p.G > most) p.G = (int)most;
  const long long last = (long long)(p.G - 1) * p.FS + (long long)H * p.WP + W;
  const long long units = (long long)((B + p.G - 1) / p.G) * ((last + kLag) / kStepM + 1);
  if (last + kStepM >= (1ll << 31) || (long long)B * H * W >= (1ll << 31) || units >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  p.spg = (int)((last + kLag) / kStepM) + 1;  // the last output lies in the last step
  p.units = (int)units;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Cin) {
    case 128: return launch<128>(p, s);
    case 256: return launch<256>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wg

// The wgmma kernel: bf16, Cmid == 64, Cin == Cout in {128, 256}, W <= 61, no
// projection; anything else is cudaErrorInvalidValue. x (B, H, W, Cin) and
// out (B, H, W, Cout) contiguous, 16-byte aligned; the weights output-channel
// major as for the bf16 entries above: wa (Cmid, Cin), wb (3, 3, Cmid, Cmid),
// wc (Cout, Cmid); ba, bb, bc float32.
extern "C" int fused_bottleneck_frames_wgmma(
    const void* x, const void* wa, const float* ba, const void* wb,
    const float* bb, const void* wc, const float* bc, void* out, int B, int H,
    int W, int Cin, int Cmid, int Cout, void* stream) {
  return wg::dispatch(x, wa, ba, wb, bb, wc, bc, out, B, H, W, Cin, Cmid, Cout,
                      1, stream);
}

// The same kernel, `frames_per_step` consecutive frames streamed as one group.
extern "C" int fused_bottleneck_multi_wgmma(
    const void* x, const void* wa, const float* ba, const void* wb,
    const float* bb, const void* wc, const float* bc, void* out, int B, int H,
    int W, int Cin, int Cmid, int Cout, int frames_per_step, void* stream) {
  return wg::dispatch(x, wa, ba, wb, bb, wc, bc, out, B, H, W, Cin, Cmid, Cout,
                      frames_per_step, stream);
}

// Shared memory of one block of the wgmma kernel for C = Cin = Cout, 0 for a
// width it does not take.
extern "C" int fused_bottleneck_wgmma_smem_bytes(int C) {
  switch (C) {
    case 128: return wg::Layout<128>::kBytes;
    case 256: return wg::Layout<256>::kBytes;
    default: return 0;
  }
}
