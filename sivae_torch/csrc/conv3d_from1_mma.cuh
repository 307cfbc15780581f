// The tensor-core bodies of the 1 -> C 3x3x3 SAME convolution, C a
// multiple of 4 up to 64 and a 16-byte aligned output, for sm_90 and later
// (mma.sync): "mma" in bf16 and "tf32x3" in fp32. The mirror of
// conv3d_to1_mma.cuh.
//
// What bounds them: the C-wide output (at 64 channels, 80x96x80, batch 2:
// 157 MB in bf16, 0.047 ms at 3.35 TB/s; 315 MB, 0.094 ms in fp32). The
// input is 1/C of those bytes and the 27 x C multiply-adds per voxel are a
// matrix product, y[v, c] = sum_t A[v, t] * w[t, c] with A[v, t] =
// x[v + off_t], K = 27 taps padded to 32: a few microseconds of tensor-core
// time at that size, three times that in fp32. The CUDA-core body
// (conv3d_from1_kernel in conv3d_small.cu) is held instead by its
// shared-memory weight reads: one 4-byte read per FMA, 2-way bank
// conflicted, ~12x its bytes bound. Here no FMA runs on the CUDA cores.
//
// A block owns a 16 x 16 in-plane patch of one batch element and marches
// along d over its segment of planes (the geometry of conv3d_to1_mma.cuh).
// Each input plane's 18 x 18 haloed 1-channel patch (zeros outside the
// volume: all of the SAME padding) goes into a ring of 4 planes in shared
// memory by plain loads, issued one plane ahead so that they are in flight
// during the products. Each m16 A tile is the 16 output voxels of one patch
// row: each lane gathers its values of the 3 planes with scalar
// shared-memory loads (taps past 27 read a plane of zeros). N is C padded to
// the next n8 tile with zero weights; the padded channels are never stored.
// - bf16 ("mma", conv3d_from1_mma_kernel): the weights (27 -> 32 x C) sit in
//   registers as m16n8k16 B fragments for the whole kernel, 2 taps to a
//   register, and each A register packs 2 taps. The epilogue rounds once to
//   bf16, stages each warp's 16 x C tile in its own piece of shared memory
//   and writes it with 16-byte stores, or 8-byte ones where an output row
//   is not a multiple of 16 bytes (C = 12: 24 bytes), consecutive lanes on
//   consecutive addresses (the 16 voxels of a patch row are contiguous in
//   y).
// - fp32 ("tf32x3", conv3d_from1_tf32x3_kernel): one TF32 product would miss
//   the fp32 tolerance, so each operand is split into a TF32 big and small
//   part (split_tf32, ptx.cuh) and every k-step runs three m16n8k8 tf32
//   products, small * big, big * small and big * big (conv3d_tf32x3.cuh
//   says why that holds fp32). K = 32 is 4 k-steps. The weights are split
//   once per block into shared memory in fragment order (an 8-byte read
//   gives a lane one part's pair; 24 KB at C = 64, where registers would
//   need 192 a thread), the A values per fragment. The accumulators
//   leave as 8-byte stores, 4 lanes to a voxel's 32-byte sector.
// Two blocks share an SM.

#pragma once

#include "common.cuh"
#include "conv3d_to1_mma.cuh"  // kPatch, kHalo, kPatchVox, plane_seg_len
#include "ptx.cuh"

namespace sivae {

constexpr int kFromRing = 4;  // input planes d - 1, d, d + 1, and d + 2 arriving
constexpr int kFromZero = kFromRing * kPatchVox;  // a plane of zeros for the taps past 27
constexpr int kFromBlocksPerSm = 2;

// The haloed 1-channel input planes of a block's patch, E = the bf16 bits
// (unsigned short) or float: this thread's two voxels of a plane (i = tid and
// tid + 256; their in-plane offset, or -1 outside the volume or past the 324)
template <typename E>
struct From1Planes {
  const E* xb;  // this batch element's volume
  long long HW;
  int D, src[2];

  __device__ From1Planes(const E* x, int b, int D_, int H, int W, int h0, int w0)
      : xb(x + static_cast<long long>(b) * D_ * H * W),
        HW(static_cast<long long>(H) * W),
        D(D_) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = threadIdx.x + 256 * k;
      const int hh = h0 - 1 + i / kHalo, ww = w0 - 1 + i % kHalo;
      src[k] = (i < kPatchVox && hh >= 0 && hh < H && ww >= 0 && ww < W) ? hh * W + ww : -1;
    }
  }
  __device__ void fetch(int dd, E (&v)[2]) const {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      v[k] = (src[k] >= 0 && dd >= 0 && dd < D) ? __ldg(xb + dd * HW + src[k]) : E(0);
  }
  // into ring slot dd & 3 (also for dd = -1)
  __device__ void put(E* ring, int dd, const E (&v)[2]) const {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (threadIdx.x + 256 * k < kPatchVox)
        ring[(dd & 3) * kPatchVox + threadIdx.x + 256 * k] = v[k];
  }
  // planes d0 - 1 .. d0 + 1, and the zero plane
  __device__ void prime(E* ring, int d0) const {
    E v[2];
#pragma unroll
    for (int dd = -1; dd <= 1; ++dd) {
      fetch(d0 + dd, v);
      put(ring, d0 + dd, v);
    }
    for (int i = threadIdx.x; i < kPatchVox; i += 256) ring[kFromZero + i] = E(0);
  }
};

// Where a lane's A value for tap t lives: its plane (kd; 3 for the taps past
// 27, which read the zero plane) and its in-plane offset in the haloed patch.
__device__ __forceinline__ void from1_tap(int t, int& kd, int& off) {
  kd = t < 27 ? t / 9 : 3;
  off = t < 27 ? ((t / 3) % 3) * kHalo + t % 3 : 0;
}

template <int C>
struct From1Cfg {
  static_assert(C % 4 == 0 && C >= 4 && C <= 64, "C a multiple of 4 up to 64");
  static constexpr int kNT = (C + 7) / 8;                  // n8 tiles
  static constexpr int kPiece = (2 * C) % 16 == 0 ? 16 : 8;  // bytes a bf16 output store
  static constexpr int kPieces = 2 * C / kPiece;           // stores per output voxel
  static constexpr int kRow = C * 2 + 16;                  // staged bf16 output row, bytes
};

template <int C>
__global__ void __launch_bounds__(256, kFromBlocksPerSm)
conv3d_from1_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ y, int D, int H, int W, int seg_len) {
  using Cfg = From1Cfg<C>;
  __shared__ __align__(16) unsigned short ring[kFromZero + kPatchVox];
  __shared__ __align__(16) unsigned char stage[8][16 * Cfg::kRow];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles_w = (W + kPatch - 1) / kPatch;
  const int patches = tiles_w * ((H + kPatch - 1) / kPatch);
  const int patch = blockIdx.x % patches, b = blockIdx.x / patches;
  const int w0 = (patch % tiles_w) * kPatch, h0 = (patch / tiles_w) * kPatch;
  const int d0 = blockIdx.y * seg_len;
  const int d1 = min(D, d0 + seg_len);
  const From1Planes<unsigned short> planes(reinterpret_cast<const unsigned short*>(x), b, D, H, W,
                                           h0, w0);

  // B fragments: b0 = {w[16kk + 2t4][n], w[16kk + 2t4 + 1][n]}, b1 the taps 8
  // on; n = 8j + g, zero past C
  const unsigned short* wr = reinterpret_cast<const unsigned short*>(w);
  unsigned bw[2][Cfg::kNT][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int j = 0; j < Cfg::kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 16 * kk + 8 * h + 2 * t4, n = 8 * j + g;
        const unsigned lo = t < 27 && n < C ? __ldg(wr + t * C + n) : 0u;
        const unsigned hi = t + 1 < 27 && n < C ? __ldg(wr + (t + 1) * C + n) : 0u;
        bw[kk][j][h] = lo | (hi << 16);
      }
  // this lane's 8 A columns, q = 4kk + 2h + e -> tap 16kk + 8h + 2t4 + e
  int tkd[8], toff[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    from1_tap(16 * (q >> 2) + 8 * ((q >> 1) & 1) + 2 * t4 + (q & 1), tkd[q], toff[q]);

  planes.prime(ring, d0);
  __syncthreads();

  unsigned char* st = stage[warp];
  for (int d = d0; d < d1; ++d) {
    unsigned short nxt[2];
    const bool more = d + 2 <= d1;  // plane d + 2 is read by output plane d + 1
    if (more) planes.fetch(d + 2, nxt);
    int pbase[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      pbase[q] = (tkd[q] == 3 ? kFromZero : ((d - 1 + tkd[q]) & 3) * kPatchVox) + toff[q] + g;
    const long long plane = static_cast<long long>(b) * D + d;
#pragma unroll
    for (int oh = warp; oh < kPatch; oh += 8) {  // one m16 tile: the 16 outputs of patch row oh
      if (h0 + oh >= H) break;
      unsigned a[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // row g, then g + 8
            const int q = 4 * kk + 2 * h, off = oh * kHalo + 8 * r;
            a[kk][2 * h + r] = ring[pbase[q] + off] | (unsigned(ring[pbase[q + 1] + off]) << 16);
          }
      float acc[Cfg::kNT][4];
#pragma unroll
      for (int j = 0; j < Cfg::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) mma_bf16(acc[j], a[kk], bw[kk][j][0], bw[kk][j][1]);
      }
      // accumulators: e = 0, 1 -> voxel g, channels 8j + 2t4, + 1; e = 2, 3 -> voxel g + 8
      // (channels past C land in the row's padding and are not stored)
#pragma unroll
      for (int j = 0; j < Cfg::kNT; ++j) {
        unsigned char* p = st + g * Cfg::kRow + (8 * j + 2 * t4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * Cfg::kRow) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      }
      __syncwarp();
      const long long row = (plane * H + h0 + oh) * W + w0;  // voxel of output (oh, 0)
      constexpr int kTotal = 16 * Cfg::kPieces;
#pragma unroll
      for (int it = 0; it < (kTotal + 31) / 32; ++it) {
        const int piece = it * 32 + lane, ow = piece / Cfg::kPieces, pc = piece % Cfg::kPieces;
        if (piece >= kTotal || w0 + ow >= W) continue;
        __nv_bfloat16* dst = y + (row + ow) * C + pc * (Cfg::kPiece / 2);
        const unsigned char* src = st + ow * Cfg::kRow + pc * Cfg::kPiece;
        if constexpr (Cfg::kPiece == 16)
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        else
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      }
      __syncwarp();
    }
    if (more) planes.put(ring, d + 2, nxt);  // slot (d - 2) & 3: last read by output plane d - 1
    __syncthreads();
  }
}

template <int C>
__global__ void __launch_bounds__(256, kFromBlocksPerSm)
conv3d_from1_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           float* __restrict__ y, int D, int H, int W, int seg_len) {
  constexpr int kNT = From1Cfg<C>::kNT;
  __shared__ __align__(16) float ring[kFromZero + kPatchVox];
  // the split weights in fragment order: part (big, small, cross), then
  // (kk, j, lane) -> {b0, b1}, b0 = w[8kk + t4][8j + g], b1 = w[8kk + t4 + 4][8j + g]
  __shared__ uint2 wf[3][4 * kNT * 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles_w = (W + kPatch - 1) / kPatch;
  const int patches = tiles_w * ((H + kPatch - 1) / kPatch);
  const int patch = blockIdx.x % patches, b = blockIdx.x / patches;
  const int w0 = (patch % tiles_w) * kPatch, h0 = (patch / tiles_w) * kPatch;
  const int d0 = blockIdx.y * seg_len;
  const int d1 = min(D, d0 + seg_len);
  const From1Planes<float> planes(x, b, D, H, W, h0, w0);

  for (int i = tid; i < 4 * kNT * 32; i += 256) {
    const int l = i & 31, j = (i >> 5) % kNT, kk = (i >> 5) / kNT;
    const int n = 8 * j + (l >> 2), t = 8 * kk + (l & 3);
    const float v0 = t < 27 && n < C ? __ldg(w + t * C + n) : 0.f;
    const float v1 = t + 4 < 27 && n < C ? __ldg(w + (t + 4) * C + n) : 0.f;
    uint2 f[3];
    split_tf32(v0, f[0].x, f[1].x, f[2].x);
    split_tf32(v1, f[0].y, f[1].y, f[2].y);
#pragma unroll
    for (int part = 0; part < 3; ++part) wf[part][i] = f[part];
  }
  // this lane's 8 A columns, q = 2kk + h -> tap 8kk + 4h + t4
  int tkd[8], toff[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) from1_tap(8 * (q >> 1) + 4 * (q & 1) + t4, tkd[q], toff[q]);

  planes.prime(ring, d0);
  __syncthreads();

  for (int d = d0; d < d1; ++d) {
    float nxt[2];
    const bool more = d + 2 <= d1;  // plane d + 2 is read by output plane d + 1
    if (more) planes.fetch(d + 2, nxt);
    int pbase[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      pbase[q] = (tkd[q] == 3 ? kFromZero : ((d - 1 + tkd[q]) & 3) * kPatchVox) + toff[q] + g;
    const long long plane = static_cast<long long>(b) * D + d;
#pragma unroll
    for (int oh = warp; oh < kPatch; oh += 8) {  // one m16 tile: the 16 outputs of patch row oh
      if (h0 + oh >= H) break;
      // A register e of k-step kk: voxel g + 8 (e & 1), tap 8kk + 4 (e >> 1) + t4
      unsigned a[3][4][4];  // part (big, small, cross), k-step, register
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(ring[pbase[2 * kk + (e >> 1)] + oh * kHalo + 8 * (e & 1)], a[0][kk][e],
                     a[1][kk][e], a[2][kk][e]);
      float acc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      // small * cross', cross * small', big * big', each over every n8 tile
      // in turn: no product waits on the one before it (p = 0, 1, 2 takes
      // A part (p + 1) % 3 and B part 2 - p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const uint2 f = wf[2 - p][(kk * kNT + j) * 32 + lane];
            mma_tf32(acc[j], a[(p + 1) % 3][kk], f.x, f.y);
          }
      // e = 0, 1 -> voxel g, channels 8j + 2t4, + 1; e = 2, 3 -> voxel g + 8
      const long long row = (plane * H + h0 + oh) * W + w0;  // voxel of output (oh, 0)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = 8 * j + 2 * t4;
        if (c < C) {
          if (w0 + g < W)
            *reinterpret_cast<float2*>(y + (row + g) * C + c) = make_float2(acc[j][0], acc[j][1]);
          if (w0 + g + 8 < W)
            *reinterpret_cast<float2*>(y + (row + g + 8) * C + c) =
                make_float2(acc[j][2], acc[j][3]);
        }
      }
    }
    if (more) planes.put(ring, d + 2, nxt);  // slot (d - 2) & 3: last read by output plane d - 1
    __syncthreads();
  }
}

// Which tensor-core body a 1 -> C call writing into y runs: 1 = mma (bf16),
// 2 = tf32x3 (fp32), 0 = none (the CUDA-core body).
inline int from1_mma_body(const void* y, int C, int dtype) {
  if (C % 4 != 0 || C < 4 || C > 64 || (reinterpret_cast<uintptr_t>(y) & 15) != 0) return 0;
  return dtype == kBFloat16 ? 1 : dtype == kFloat32 ? 2 : 0;
}

template <int C>
inline int launch_from1_mma_c(const void* x, const void* w, void* y, int B, int D, int H, int W,
                              int dtype, cudaStream_t s) {
  const int patches = ((W + kPatch - 1) / kPatch) * ((H + kPatch - 1) / kPatch);
  const int seg_len = plane_seg_len(patches * B, D, kFromBlocksPerSm);
  const dim3 grid(patches * B, (D + seg_len - 1) / seg_len);
  if (dtype == kBFloat16)
    conv3d_from1_mma_kernel<C><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), D, H, W, seg_len);
  else
    conv3d_from1_tf32x3_kernel<C><<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                                       static_cast<const float*>(w),
                                                       static_cast<float*>(y), D, H, W, seg_len);
  return static_cast<int>(cudaGetLastError());
}

// x (B,D,H,W), w (27,C), y (B,D,H,W,C), on operands from1_mma_body() gives a
// body for.
inline int launch_from1_mma(const void* x, const void* w, void* y, int B, int D, int H, int W,
                            int C, int dtype, cudaStream_t s) {
  switch (C) {
#define SIVAE_FROM1_CASE(c) \
  case c:                   \
    return launch_from1_mma_c<c>(x, w, y, B, D, H, W, dtype, s);
    SIVAE_FROM1_CASE(4) SIVAE_FROM1_CASE(8) SIVAE_FROM1_CASE(12) SIVAE_FROM1_CASE(16)
    SIVAE_FROM1_CASE(20) SIVAE_FROM1_CASE(24) SIVAE_FROM1_CASE(28) SIVAE_FROM1_CASE(32)
    SIVAE_FROM1_CASE(36) SIVAE_FROM1_CASE(40) SIVAE_FROM1_CASE(44) SIVAE_FROM1_CASE(48)
    SIVAE_FROM1_CASE(52) SIVAE_FROM1_CASE(56) SIVAE_FROM1_CASE(60) SIVAE_FROM1_CASE(64)
#undef SIVAE_FROM1_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace sivae
