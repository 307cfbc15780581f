// The "narrow" tensor-core body of the 3x3x3 SAME stride-1 convolution
// (NDHWC x DHWIO -> NDHWC, for sm_90a): bf16 with Ci and Co multiples of 4 and
// at most 64, on the operands the "wgmma" and "mma" bodies do not take. These
// are the channel counts of the FC family (12/24/32/48, 16/32/64) and of the
// spatial_150 presets (12/24/32/48).
//
// What bounds it. At the full-resolution sites (12->12 and 16->16 at
// 80x96x80, batch 8) the input and output streams are 236 / 315 MB, 0.070 /
// 0.094 ms at 3.35 TB/s, and the padded tensor work (K per tap = Ci rounded
// up to 16, N = Co rounded up to 8) is ~0.07 ms at the dense bf16 rate: the
// bytes bound it. What the CUDA-core "fma" body (conv3d_body.cuh) loses on
// top: a 64-column output tile whatever Co is, 16-channel chunks, fp32 FMAs,
// and every tap's input rows gathered again from global memory with scalar
// loads. Here each input byte is read from device memory about once and
// every multiply runs on the tensor cores.
//
// Design. A block owns a 16-wide x TH-high in-plane patch of one batch
// element (TH = 8R, R = 1 or 2 patch rows a warp) and up to 32 of the output
// channels (Co > 32 splits into two channel halves, blockIdx.z), and marches
// along d over its segment of planes. Each input plane's haloed patch,
// (TH + 2) x 18 voxels x Ci channels, is copied into shared memory ONCE by
// cp.async (8-byte pieces: a 24-byte row of Ci = 12 is not a multiple of
// 16, which TMA's strides need; 16-byte pieces where Ci % 8 == 0), into a
// ring of 4 planes: d - 1, d, d + 1 read by output plane d, and d + 2
// arriving meanwhile. Coordinates outside the volume are cp.async's zero
// fill (all of the SAME padding); channels Ci .. Kp - 1 are zeros written
// once. A voxel row is Kp + 8 bf16, an odd number of 16-byte units, so
// ldmatrix's 8 rows never share a bank. The weights of the block's channels,
// 27 x Kp x Np bf16, sit in shared memory for the whole kernel in the
// mma.sync B-fragment order (one conflict-free 8-byte load a fragment),
// zero-padded. A warp's m16 tiles are its R patch rows (16 consecutive w).
// For a (kd, kw) and a 16-channel step, each of the R + 2 input rows it
// touches is loaded once by ldmatrix and multiplied by the B fragments of
// every kh that maps it to one of its rows (m16n8k16, fp32 accumulators),
// which saves a third of the A loads at R = 2. The fp32 sums of all 27 taps
// are rounded once to bf16, staged per warp in shared memory and written
// with 8-byte stores, consecutive lanes on consecutive addresses (a patch
// row is contiguous in y). R = 2 wherever its shared memory fits (every
// narrow site at 80x96x80 and 40x48x40; not 48->32 or 64->32): on the
// H100, one R = 2 block an SM beat two R = 1 blocks at 24->12 and 32->16
// (40x48x40, batch 8; chip_smoke.py phase 3 before and after the choice).

#pragma once

#include <stdint.h>

#include "common.cuh"
#include "ptx.cuh"

namespace sivae {

constexpr int kNarrowTW = 16;      // patch width: one m16 tile
constexpr int kNarrowHalo = kNarrowTW + 2;
constexpr int kNarrowRing = 4;     // input planes d - 1, d, d + 1 and d + 2 arriving
constexpr int kNarrowMaxN = 32;    // output channels a block at most (weights of 64 leave no room)

// Shared memory of one block: weights, the ring of haloed planes, the
// per-warp output staging. A staged output row is 8 NT + 8 or + 16 bf16, a
// stride of 4 words mod 8, so the 8 rows of a fragment store hit 8 distinct
// groups of 4 banks.
__host__ __device__ constexpr int narrow_plane_vox(int R) { return (8 * R + 2) * kNarrowHalo; }
__host__ __device__ constexpr int narrow_stage_ld(int NT) { return 8 * NT + (NT % 2 ? 16 : 8); }
__host__ __device__ constexpr int narrow_w_bytes(int NT, int kp) { return 27 * (kp / 16) * NT * 256; }
__host__ __device__ constexpr int narrow_ring_bytes(int R, int kp) {
  return kNarrowRing * narrow_plane_vox(R) * (kp + 8) * 2;
}
__host__ __device__ constexpr int narrow_smem(int NT, int R, int kp) {
  return narrow_w_bytes(NT, kp) + narrow_ring_bytes(R, kp) + 8 * 16 * R * narrow_stage_ld(NT) * 2;
}

template <int NT, int R>
__global__ void __launch_bounds__(256, 2)
conv3d_narrow_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ y, int D, int H, int W, int Ci, int Co, int kp,
                     int cw, int seg_len, int vec16) {
  constexpr int TH = 8 * R;
  constexpr int kPlaneVox = narrow_plane_vox(R);
  constexpr int LST = narrow_stage_ld(NT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = kp / 16, lda = kp + 8;
  const int plane_elems = kPlaneVox * lda;
  const uint2* ws = reinterpret_cast<const uint2*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + narrow_w_bytes(NT, kp));
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(smem + narrow_w_bytes(NT, kp) + narrow_ring_bytes(R, kp));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles_w = (W + kNarrowTW - 1) / kNarrowTW;
  const int patches = tiles_w * ((H + TH - 1) / TH);
  const int patch = blockIdx.x % patches, b = blockIdx.x / patches;
  const int w0 = (patch % tiles_w) * kNarrowTW, h0 = (patch / tiles_w) * TH;
  const int d0 = blockIdx.y * seg_len, d1 = min(D, d0 + seg_len);
  const int n0 = blockIdx.z * cw, nreal = min(cw, Co - n0);  // this block's output channels

  // the weights in B-fragment order, [27][kt][NT][32 lanes] x {b0, b1}: lane
  // (g, t4) of n8 tile j holds b0 = w[k = 16kk + 2t4, +1][n = 8j + g] and
  // b1 the same 8 channels on; zeros past Ci and past this block's channels
  {
    __nv_bfloat16* wsh = reinterpret_cast<__nv_bfloat16*>(smem);
    const int count = 27 * kt * NT * 128;
    for (int i = tid; i < count; i += 256) {
      const int half = i & 1, reg = (i >> 1) & 1, l = (i >> 2) & 31;
      const int j = (i >> 7) % NT, tk = (i >> 7) / NT;
      const int kk = tk % kt, t = tk / kt;
      const int k = kk * 16 + reg * 8 + (l & 3) * 2 + half, n = j * 8 + (l >> 2);
      wsh[i] = (k < Ci && n < nreal) ? w[(static_cast<long long>(t) * Ci + k) * Co + n0 + n]
                                     : __float2bfloat16(0.f);
    }
  }
  // channels Ci .. kp - 1 of every ring voxel are zeros; cp.async never writes them
  {
    const int pad = (kp - Ci) / 4;
    for (int q = tid; q < kNarrowRing * kPlaneVox * pad; q += 256) {
      const int v = q / pad, p = q - v * pad;
      *reinterpret_cast<uint2*>(ring + v * lda + Ci + p * 4) = make_uint2(0u, 0u);
    }
  }

  const int n_out = d1 - d0, n_planes = n_out + 2;  // input planes d0 - 1 .. d1
  const int piece = vec16 ? 8 : 4;                   // channels a copy
  const int pieces = Ci / piece;
  // input plane d0 - 1 + i into ring slot i % 4; zeros outside the volume
  auto load_plane = [&](int i) {
    if (i >= n_planes) return;
    const int dd = d0 - 1 + i;
    const bool d_ok = dd >= 0 && dd < D;
    __nv_bfloat16* dst = ring + (i % kNarrowRing) * plane_elems;
    const long long plane = static_cast<long long>(b) * D + dd;
    for (int q = tid; q < kPlaneVox * pieces; q += 256) {
      const int v = q / pieces, p = q - v * pieces;
      const int hh = h0 - 1 + v / kNarrowHalo, ww = w0 - 1 + v % kNarrowHalo;
      const bool ok = d_ok && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const __nv_bfloat16* src = ok ? x + ((plane * H + hh) * W + ww) * Ci + p * piece : x;
      if (vec16)
        cp_async16(dst + v * lda + p * 8, src, ok);
      else
        cp_async8(dst + v * lda + p * 4, src, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kNarrowRing; ++i) {
    load_plane(i);
    cp_async_commit();
  }

  const int oh0 = warp * R;  // this warp's first patch row
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;  // this lane's ldmatrix row address
  __nv_bfloat16* st = stage + warp * 16 * R * LST;
  const int out_pieces = nreal / 4;
  for (int j = 0; j < n_out; ++j) {
    cp_async_wait<kNarrowRing - 3>();  // this thread's copies of planes j .. j + 2 have landed
    __syncthreads();                   // ... and every thread's (the first pass: the zeros too)
    float acc[R][NT][4];
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[o][n][e] = 0.f;
    for (int kd = 0; kd < 3; ++kd) {
      const __nv_bfloat16* pl = ring + ((j + kd) % kNarrowRing) * plane_elems;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        for (int kk = 0; kk < kt; ++kk) {
          uint2 bf[3][NT];  // the B fragments of taps (kd, kh, kw), kh = 0, 1, 2
#pragma unroll
          for (int kh = 0; kh < 3; ++kh)
#pragma unroll
            for (int n = 0; n < NT; ++n)
              bf[kh][n] = ws[(((kd * 9 + kh * 3 + kw) * kt + kk) * NT + n) * 32 + lane];
          // input row oh0 + r serves output row oh0 + r - kh of tap kh
#pragma unroll
          for (int r = 0; r < R + 2; ++r) {
            unsigned fa[4];
            ldsm_x4(fa, pl + ((oh0 + r) * kNarrowHalo + a_row + kw) * lda + kk * 16 + a_col);
#pragma unroll
            for (int kh = 0; kh < 3; ++kh) {
              const int o = r - kh;
              if (o >= 0 && o < R) {
#pragma unroll
                for (int n = 0; n < NT; ++n) mma_bf16(acc[o][n], fa, bf[kh][n].x, bf[kh][n].y);
              }
            }
          }
        }
      }
    }
    // round once; accumulators: e = 0, 1 -> voxel g, channels 8n + 2t4, + 1; e = 2, 3 -> g + 8
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        __nv_bfloat16* p = st + (o * 16 + g) * LST + n * 8 + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(acc[o][n][0], acc[o][n][1]);
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * LST) =
            __floats2bfloat162_rn(acc[o][n][2], acc[o][n][3]);
      }
    __syncwarp();
    // this warp's R patch rows, 16 voxels x nreal channels each, 8-byte pieces
    const long long plane = static_cast<long long>(b) * D + d0 + j;
    for (int q = lane; q < 16 * R * out_pieces; q += 32) {
      const int v = q / out_pieces, p = q - v * out_pieces;
      const int hh = h0 + oh0 + v / 16, ww = w0 + v % 16;
      if (hh < H && ww < W)
        *reinterpret_cast<uint2*>(y + ((plane * H + hh) * W + ww) * Co + n0 + p * 4) =
            *reinterpret_cast<const uint2*>(st + v * LST + p * 4);
    }
    __syncthreads();  // every warp is done with ring slot j % 4 (and its own staging)
    load_plane(j + kNarrowRing);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

inline bool narrow_eligible(const void* x, const void* y, int Ci, int Co, int dtype) {
  return dtype == kBFloat16 && Ci % 4 == 0 && Co % 4 == 0 && Ci > 0 && Co > 0 && Ci <= 64 &&
         Co <= 64 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 7) == 0;
}

template <int NT, int R>
inline int launch_narrow_nt_r(const void* x, const void* w, void* y, int B, int D, int H, int W,
                              int Ci, int Co, int kp, int cw, int chunks, int vec16,
                              cudaStream_t s) {
  auto kernel = conv3d_narrow_kernel<NT, R>;
  const int smem = narrow_smem(NT, R, kp);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int patches = ((W + kNarrowTW - 1) / kNarrowTW) * ((H + 8 * R - 1) / (8 * R));
  const int seg_len = plane_seg_len(patches * B * chunks, D, per_sm > 0 ? per_sm : 1);
  const dim3 grid(patches * B, (D + seg_len - 1) / seg_len, chunks);
  kernel<<<grid, 256, smem, s>>>(static_cast<const __nv_bfloat16*>(x),
                                 static_cast<const __nv_bfloat16*>(w),
                                 static_cast<__nv_bfloat16*>(y), D, H, W, Ci, Co, kp, cw, seg_len,
                                 vec16);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
inline int launch_narrow_nt(const void* x, const void* w, void* y, int B, int D, int H, int W,
                            int Ci, int Co, int kp, int cw, int chunks, int vec16,
                            cudaStream_t s) {
  // R = 2 (a third fewer A loads, less halo) wherever it fits, else R = 1
  constexpr int kMaxSmem = 232448;
  if (narrow_smem(NT, 2, kp) <= kMaxSmem)
    return launch_narrow_nt_r<NT, 2>(x, w, y, B, D, H, W, Ci, Co, kp, cw, chunks, vec16, s);
  return launch_narrow_nt_r<NT, 1>(x, w, y, B, D, H, W, Ci, Co, kp, cw, chunks, vec16, s);
}

// x (B,D,H,W,Ci), w (3,3,3,Ci,Co), y (B,D,H,W,Co), bf16, on operands
// narrow_eligible() takes. Returns cudaGetLastError() after the launch.
inline int launch_conv3d_narrow(const void* x, const void* w, void* y, int B, int D, int H, int W,
                                int Ci, int Co, cudaStream_t s) {
  const int kp = (Ci + 15) / 16 * 16;
  const int chunks = (Co + kNarrowMaxN - 1) / kNarrowMaxN;
  const int cw = ((Co + chunks - 1) / chunks + 3) / 4 * 4;  // output channels a block
  const int vec16 = Ci % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  switch ((cw + 7) / 8) {
    case 1: return launch_narrow_nt<1>(x, w, y, B, D, H, W, Ci, Co, kp, cw, chunks, vec16, s);
    case 2: return launch_narrow_nt<2>(x, w, y, B, D, H, W, Ci, Co, kp, cw, chunks, vec16, s);
    case 3: return launch_narrow_nt<3>(x, w, y, B, D, H, W, Ci, Co, kp, cw, chunks, vec16, s);
    default: return launch_narrow_nt<4>(x, w, y, B, D, H, W, Ci, Co, kp, cw, chunks, vec16, s);
  }
}

}  // namespace sivae
