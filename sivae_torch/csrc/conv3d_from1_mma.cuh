// The tensor-core body of the 1 -> C 3x3x3 SAME convolution: bf16 with
// C = 16, 32 or 64 and a 16-byte aligned output, for sm_90 and later
// (mma.sync). The mirror of conv3d_to1_mma.cuh.
//
// What bounds it: the C-wide output (at 64 channels, 80x96x80, batch 2,
// bf16: 157 MB, 0.047 ms at 3.35 TB/s). The input is 1/C of those bytes and
// the 27 x C multiply-adds per voxel are a matrix product,
// y[v, c] = sum_t A[v, t] * w[t, c] with A[v, t] = x[v + off_t], K = 27
// taps padded to 32: ~5 us of tensor-core time at that size. The CUDA-core
// body (conv3d_from1_kernel in conv3d_small.cu) is held instead by its
// shared-memory weight reads: one 4-byte read per FMA, 2-way bank
// conflicted, ~12x its bytes bound. Here no FMA runs on the CUDA cores and
// each weight is read once per thread, into registers.
//
// A block owns a 16 x 16 in-plane patch of one batch element and marches
// along d over its segment of planes (the geometry of conv3d_to1_mma.cuh).
// Each input plane's 18 x 18 haloed 1-channel patch (648 B, zeros outside
// the volume: all of the SAME padding) goes into a ring of 4 planes in
// shared memory by plain loads, issued one plane ahead so that they are in
// flight during the products. The weights (27 -> 32 x C) sit in registers
// as mma.sync B fragments for the whole kernel (C / 2 registers; rows 27-31
// zero). Each m16 A tile is the 16 output voxels of one patch row: each lane
// gathers its 16 bf16 values of the 3 planes with scalar shared-memory
// loads (taps past 27 read a plane of zeros), 2 into each register;
// mma.sync m16n8k16 accumulates in fp32. The epilogue rounds once to bf16,
// stages each warp's 16 x C tile in its own piece of shared memory and
// writes it with 16-byte stores, consecutive lanes on consecutive addresses
// (the 16 voxels of a patch row are contiguous in y). Two blocks share an SM.

#pragma once

#include "common.cuh"
#include "conv3d_to1_mma.cuh"  // kPatch, kHalo, kPatchVox, plane_seg_len
#include "ptx.cuh"

namespace sivae {

constexpr int kFromRing = 4;  // input planes d - 1, d, d + 1, and d + 2 arriving
constexpr int kFromZero = kFromRing * kPatchVox;  // a plane of zeros for the taps past 27
constexpr int kFromBlocksPerSm = 2;

template <int C>
struct From1Cfg {
  static constexpr int kNT = C / 8;                // n8 tiles
  static constexpr int kRow = C * 2 + 16;          // staged output row, padded against conflicts
  static constexpr int kPieces = C / 8;            // 16-byte pieces per output voxel
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
  const long long HW = static_cast<long long>(H) * W;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + static_cast<long long>(b) * D * HW;

  // this thread's voxels of a haloed patch plane, i = tid and tid + 256:
  // their in-plane offset, or -1 outside the volume (or past the 324)
  int src[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = tid + 256 * k;
    const int hh = h0 - 1 + i / kHalo, ww = w0 - 1 + i % kHalo;
    src[k] = (i < kPatchVox && hh >= 0 && hh < H && ww >= 0 && ww < W) ? hh * W + ww : -1;
  }
  auto fetch = [&](int dd, unsigned short (&v)[2]) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      v[k] = (src[k] >= 0 && dd >= 0 && dd < D) ? __ldg(xb + dd * HW + src[k]) : 0;
  };
  auto put = [&](int dd, const unsigned short (&v)[2]) {  // slot dd & 3 (also for dd = -1)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (tid + 256 * k < kPatchVox) ring[(dd & 3) * kPatchVox + tid + 256 * k] = v[k];
  };

  // B fragments: b0 = {w[16kk + 2t4][n], w[16kk + 2t4 + 1][n]}, b1 the taps 8 on; n = 8j + g
  const unsigned short* wr = reinterpret_cast<const unsigned short*>(w);
  unsigned bw[2][Cfg::kNT][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int j = 0; j < Cfg::kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 16 * kk + 8 * h + 2 * t4, n = 8 * j + g;
        const unsigned lo = t < 27 ? __ldg(wr + t * C + n) : 0u;
        const unsigned hi = t + 1 < 27 ? __ldg(wr + (t + 1) * C + n) : 0u;
        bw[kk][j][h] = lo | (hi << 16);
      }
  // this lane's 8 A columns, q = 4kk + 2h + e -> tap 16kk + 8h + 2t4 + e:
  // its plane (kd; 3 for the taps past 27, which read the zero plane) and
  // its in-plane offset in the haloed patch
  int tkd[8], toff[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int t = 16 * (q >> 2) + 8 * ((q >> 1) & 1) + 2 * t4 + (q & 1);
    tkd[q] = t < 27 ? t / 9 : 3;
    toff[q] = t < 27 ? ((t / 3) % 3) * kHalo + t % 3 : 0;
  }

  {
    unsigned short v[2];
#pragma unroll
    for (int dd = -1; dd <= 1; ++dd) {
      fetch(d0 + dd, v);
      put(d0 + dd, v);
    }
    for (int i = tid; i < kPatchVox; i += 256) ring[kFromZero + i] = 0;
  }
  __syncthreads();

  unsigned char* st = stage[warp];
  for (int d = d0; d < d1; ++d) {
    unsigned short nxt[2];
    const bool more = d + 2 <= d1;  // plane d + 2 is read by output plane d + 1
    if (more) fetch(d + 2, nxt);
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
#pragma unroll
      for (int j = 0; j < Cfg::kNT; ++j) {
        unsigned char* p = st + g * Cfg::kRow + (8 * j + 2 * t4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * Cfg::kRow) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      }
      __syncwarp();
      const long long row = (plane * H + h0 + oh) * W + w0;  // voxel of output (oh, 0)
#pragma unroll
      for (int it = 0; it < 16 * Cfg::kPieces / 32; ++it) {
        const int piece = it * 32 + lane, ow = piece / Cfg::kPieces, pc = piece % Cfg::kPieces;
        if (w0 + ow < W)
          *reinterpret_cast<uint4*>(y + (row + ow) * C + pc * 8) =
              *reinterpret_cast<const uint4*>(st + ow * Cfg::kRow + pc * 16);
      }
      __syncwarp();
    }
    if (more) put(d + 2, nxt);  // slot (d - 2) & 3: last read by output plane d - 1
    __syncthreads();
  }
}

inline bool from1_mma_eligible(const void* y, int C, int dtype) {
  return dtype == kBFloat16 && (C == 16 || C == 32 || C == 64) &&
         (reinterpret_cast<uintptr_t>(y) & 15) == 0;
}

template <int C>
inline int launch_from1_mma_c(const void* x, const void* w, void* y, int B, int D, int H, int W,
                              cudaStream_t s) {
  const int patches = ((W + kPatch - 1) / kPatch) * ((H + kPatch - 1) / kPatch);
  const int seg_len = plane_seg_len(patches * B, D, kFromBlocksPerSm);
  const dim3 grid(patches * B, (D + seg_len - 1) / seg_len);
  conv3d_from1_mma_kernel<C><<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                  static_cast<const __nv_bfloat16*>(w),
                                                  static_cast<__nv_bfloat16*>(y), D, H, W, seg_len);
  return static_cast<int>(cudaGetLastError());
}

// x (B,D,H,W) bf16, w (27,C), y (B,D,H,W,C), on operands from1_mma_eligible() takes.
inline int launch_from1_mma(const void* x, const void* w, void* y, int B, int D, int H, int W,
                            int C, cudaStream_t s) {
  if (C == 64) return launch_from1_mma_c<64>(x, w, y, B, D, H, W, s);
  if (C == 32) return launch_from1_mma_c<32>(x, w, y, B, D, H, W, s);
  return launch_from1_mma_c<16>(x, w, y, B, D, H, W, s);
}

}  // namespace sivae
