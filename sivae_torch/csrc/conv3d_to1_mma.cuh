// The tensor-core bodies of the C -> 1 3x3x3 SAME convolution, C a multiple
// of 4 up to 64, for sm_90 and later (TMA or cp.async, mbarrier, mma.sync):
// "mma" in bf16 and "tf32x3" in fp32 (at the end of this file).
//
// The CUDA-core body re-reads every input voxel's C channels for each of the
// 27 output voxels whose window holds it, through L1, and multiplies on the
// CUDA cores. Here the channels are contracted ONCE per input voxel, on the
// tensor cores: Z[v, t] = sum_c x[v, c] * w[t, c] for the 27 taps t (padded
// to N = 32), in fp32; the output is then a 27-term sum of scalars,
// y[d, h, w] = sum_{kd, kh, kw} Z[(d + kd - 1, h + kh - 1, w + kw - 1), t],
// read from shared memory and rounded once. Every input byte crosses L2 once
// per block that holds it and no FMA runs on the CUDA cores; what is left is
// the input stream, the bound of this kernel (bytes).
//
// A block owns a 16 x 16 in-plane patch of one batch element and marches
// along d over its segment of planes. The channels are padded to K = 16, 32
// or 64 (KP). Per input plane the 18 x 18 haloed patch (324 voxels x KP
// channels) lands in one of two swizzled buffers. Where a voxel row is a
// multiple of 16 bytes (C % 8 == 0) one 5-D TMA box brings it, KP channels
// wide: coordinates outside the volume, and channels C .. KP - 1, arrive as
// zeros, which is all of the SAME padding (w, h and d edges) and the channel
// padding. A 24-byte row (C = 12; any C % 8 == 4) is a stride TMA cannot
// take: there every thread copies 8-byte pieces with cp.async into the same
// swizzled layout, zero-filled outside the volume, and the pad channels are
// zeros written once. The 8 warps share the 21 m16
// tiles of those voxels: ldmatrix for A, the 27 x C weights resident in
// registers as B fragments (zeros past C), mma.sync m16n8k16 (the tensor
// work is a few percent of the bound; wgmma is not needed). One plane's Z
// lives in shared memory, tap-major ([t][voxel], voxel stride 340 floats),
// so that the fragment stores and the 27 reads of consecutive w are free of
// bank conflicts. Each thread owns one output of the patch and keeps the
// running sums of the three output planes that the plane's Z feeds (kd = 0,
// 1, 2) in registers: the taps are added in the order kd, kh, kw as before,
// and a Z buffer of one plane, not three, lets 3 blocks share an SM at
// KP = 16 and 2 at KP = 32. The halo costs 324 / 256 = 1.27x the patch's bytes from L2
// (device memory sees each byte about once) and 2 extra planes per segment.
//
// "tf32x3" (conv3d_to1_tf32x3_kernel) is the same walk in fp32. One TF32
// product would miss the fp32 tolerance, so each operand is split into a
// TF32 big and small part (split_tf32, ptx.cuh) and each k8 step runs three
// m16n8k8 tf32 products, small * big, big * small and big * big
// (conv3d_tf32x3.cuh says why that holds fp32). What bounds it (64 -> 1 at
// 80x96x80, batch 2): the 315 MB input, 0.094 ms at 3.35 TB/s; the three
// products over the haloed voxels (K = 64, N = 32) are ~9e6 mma.sync, about
// 0.15 ms at the ~1 per 16 cycles per SM quarter an H100 issues them:
// the tensor pipe holds it, the bytes close behind (H100 80GB HBM3, 700 W,
// chip_smoke.py phase 3: 0.22 ms, the CUDA-core body 1.31 ms, cuDNN 4.7
// ms; 12 -> 1 at batch 8 0.26 ms against 3.2 and 3.9). What the CUDA-core body
// (conv3d_to1_kernel, conv3d_small.cu) lost: it reads each input voxel for
// each of the 27 outputs whose window holds it (through L1 / L2) and does
// every multiply on the CUDA cores. An fp32 row of C % 4 == 0 channels is a
// multiple of 16 bytes, so every C arrives by TMA: a box of min(KP, 32)
// channels (64- or 128-byte rows, swizzled), two boxes into two
// sub-buffers at KP = 64; channels C .. KP - 1 arrive as zeros. The split
// weights sit in shared memory in fragment order, big and small parts
// (cross is big where big is finite, formed at use: a third part would not
// fit beside two 86 KB planes and Z at KP = 64), and a k8 step past C is
// skipped.

#pragma once

#include "common.cuh"
#include "ptx.cuh"

namespace sivae {

constexpr int kPatch = 16;                    // outputs per side of a block's in-plane patch
constexpr int kHalo = kPatch + 2;
constexpr int kPatchVox = kHalo * kHalo;      // 324 input voxels a plane
constexpr int kPatchTiles = (kPatchVox + 15) / 16;
constexpr int kZStride = 340;                 // floats per tap row: 2 * 340 % 32 == 8
constexpr int kZPlane = 27 * kZStride * 4;    // bytes of one plane's Z
static_assert(kZStride >= kPatchTiles * 16 && (2 * kZStride) % 32 == 8, "Z layout");

template <int KP>
struct To1Cfg {
  static constexpr int kRow = KP * 2;                                     // bytes per voxel
  static constexpr int kBox = kPatchVox * kRow;                           // bytes a TMA box brings
  static constexpr int kIn = (kPatchTiles * 16 * kRow + 1023) / 1024 * 1024;
  static constexpr int kZOff = 2 * kIn;
  static constexpr int kBarOff = kZOff + kZPlane;
  static constexpr int kSmem = kBarOff + 16 + 1024;
  static constexpr unsigned kSwizzle = KP / 8 - 1;  // 16-byte pieces XORed: 128 / 64 / 32-byte mode
};

// The byte of a voxel-row buffer that holds byte `lin` of the unswizzled
// [voxel][KP] layout: TMA's swizzle, which the cp.async path writes too.
template <int KP>
__device__ __forceinline__ uint32_t to1_swizzle(uint32_t lin) {
  return lin ^ (((lin >> 7) & To1Cfg<KP>::kSwizzle) << 4);
}

// kTma: the input arrives by TMA (xmap), else by cp.async from x.
template <int KP, bool kTma>
__global__ void __launch_bounds__(256, KP == 16 ? 3 : KP == 32 ? 2 : 1)
conv3d_to1_mma_kernel(const __grid_constant__ CUtensorMap xmap, const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y, int D,
                      int H, int W, int C, int seg_len) {
  using Cfg = To1Cfg<KP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* zs = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + Cfg::kZOff);
  const uint32_t full0 = base + Cfg::kBarOff;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles_w = (W + kPatch - 1) / kPatch;
  const int patches = tiles_w * ((H + kPatch - 1) / kPatch);
  const int patch = blockIdx.x % patches, b = blockIdx.x / patches;
  const int w0 = (patch % tiles_w) * kPatch, h0 = (patch / tiles_w) * kPatch;
  const int d0 = blockIdx.y * seg_len;
  const int d1 = min(D, d0 + seg_len);
  const int n_it = d1 - d0 + 2;  // input planes d0 - 1 .. d1

  unsigned char* in_gen = smem_raw + (base - smem_u32(smem_raw));  // the buffers, generic
  if constexpr (kTma) {
    if (tid == 0) {
      mbar_init(full0, 1);
      mbar_init(full0 + 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  } else {  // channels C .. KP - 1 of both buffers: zeros, written once
    const int pad = (KP - C) / 4;
    for (int q = tid; q < 2 * kPatchVox * pad; q += 256) {
      const int v = q / pad, p = C / 4 + q % pad;
      const int buf = v / kPatchVox, vox = v - buf * kPatchVox;
      *reinterpret_cast<uint2*>(in_gen + buf * Cfg::kIn +
                                to1_swizzle<KP>(vox * Cfg::kRow + p * 8)) = make_uint2(0u, 0u);
    }
  }
  __syncthreads();
  auto fetch = [&](int it) {  // one thread: the haloed patch of input plane d0 - 1 + it
    const uint32_t full = full0 + 8 * (it & 1);
    mbar_expect_tx(full, Cfg::kBox);
    tma_load_5d(base + (it & 1) * Cfg::kIn, &xmap, full, 0, w0 - 1, h0 - 1, d0 - 1 + it, b);
  };
  // every thread: 8-byte pieces of the haloed patch of input plane d0 - 1 + it
  const int pieces = C / 4;
  auto copy = [&](int it) {
    if (it < n_it) {
      unsigned char* dst = in_gen + (it & 1) * Cfg::kIn;
      const int dd = d0 - 1 + it;
      const long long plane = static_cast<long long>(b) * D + dd;
      for (int q = tid; q < kPatchVox * pieces; q += 256) {
        const int v = q / pieces, p = q - v * pieces;
        const int hh = h0 - 1 + v / kHalo, ww = w0 - 1 + v % kHalo;
        const bool ok = dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W;
        cp_async8(dst + to1_swizzle<KP>(v * Cfg::kRow + p * 8),
                  ok ? x + ((plane * H + hh) * W + ww) * C + p * 4 : x, ok);
      }
    }
    cp_async_commit();
  };
  if constexpr (kTma) {
    if (tid == 0) {
      fetch(0);
      fetch(1);
    }
  } else {
    copy(0);
    copy(1);
  }

  // B fragments of all taps: b0 = w[t = 8j + g][16kk + 2 t4, +1], b1 the same 8 channels on
  // (zeros past tap 27 and past channel C)
  unsigned bw[KP / 16][4][2];
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = j * 8 + g, k = kk * 16 + 2 * t4;
      const unsigned* p = reinterpret_cast<const unsigned*>(w + t * C + k);
      bw[kk][j][0] = t < 27 && k < C ? __ldg(p) : 0u;
      bw[kk][j][1] = t < 27 && k + 8 < C ? __ldg(p + 4) : 0u;
    }

  const int oh = tid >> 4, ow = tid & 15;  // this thread's output of the patch
  const bool out_ok = h0 + oh < H && w0 + ow < W;
  float part[2] = {0.f, 0.f};  // running sums of output planes it - 1 and it - 2 (local)
  for (int it = 0; it < n_it; ++it) {
    if constexpr (kTma) {
      mbar_wait(full0 + 8 * (it & 1), (it >> 1) & 1);
    } else {
      cp_async_wait<1>();  // this thread's pieces of plane it have landed
      __syncthreads();     // ... and every thread's
    }
    const uint32_t in = base + (it & 1) * Cfg::kIn;
    for (int tile = warp; tile < kPatchTiles; tile += 8) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        const uint32_t lin = (tile * 16 + (lane & 15)) * Cfg::kRow + (kk * 2 + (lane >> 4)) * 16;
        unsigned fa[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(fa[0]), "=r"(fa[1]), "=r"(fa[2]), "=r"(fa[3])
                     : "r"(in + to1_swizzle<KP>(lin)));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[j], fa, bw[kk][j][0], bw[kk][j][1]);
      }
      // accumulators: e = 0, 1 -> voxel g, taps 8j + 2 t4, + 1; e = 2, 3 -> voxel g + 8
      float* zv = zs + tile * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = j * 8 + 2 * t4;
        if (t < 27) {
          zv[t * kZStride] = acc[j][0];
          zv[t * kZStride + 8] = acc[j][2];
        }
        if (t + 1 < 27) {
          zv[(t + 1) * kZStride] = acc[j][1];
          zv[(t + 1) * kZStride + 8] = acc[j][3];
        }
      }
    }
    __syncthreads();  // this plane's Z is written; its input buffer is free
    if constexpr (kTma) {
      if (tid == 0 && it + 2 < n_it) fetch(it + 2);
    } else {
      copy(it + 2);
    }
    // input plane it feeds output plane it (local; kd = 0), it - 1 (kd = 1)
    // and it - 2 (kd = 2), which is then complete
    float sum[3] = {0.f, part[0], part[1]};
    const float* zp = zs + oh * kHalo + ow;
#pragma unroll
    for (int kd = 0; kd < 3; ++kd)
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          sum[kd] += zp[(kd * 9 + kh * 3 + kw) * kZStride + kh * kHalo + kw];
    if (it >= 2 && out_ok) {
      const long long plane = static_cast<long long>(b) * D + (d0 + it - 2);
      y[(plane * H + h0 + oh) * W + w0 + ow] = __float2bfloat16(sum[2]);
    }
    part[0] = sum[0];
    part[1] = sum[1];
    __syncthreads();  // the Z plane may be overwritten
  }
}

// The fp32 form: KP channels in sub-buffers of KW = min(KP, 32) (rows of 64
// or 128 bytes, one TMA box each), two input planes, one Z plane, the split
// weights.
template <int KP>
struct To1Tf32Cfg {
  static constexpr int kKW = KP < 32 ? KP : 32;      // channels a sub-buffer row
  static constexpr int kRow = kKW * 4;               // bytes a sub-buffer row
  static constexpr int kSubs = KP / kKW;
  static constexpr int kBox = kPatchVox * kRow;      // bytes a TMA box brings
  static constexpr int kSub = (kPatchTiles * 16 * kRow + 1023) / 1024 * 1024;
  static constexpr int kIn = kSubs * kSub;           // one input plane
  static constexpr int kZOff = 2 * kIn;
  static constexpr int kWOff = kZOff + kZPlane;      // [2 parts][KP / 8][4 n8][32 lanes] uint2
  static constexpr int kBarOff = kWOff + KP * 256;
  static constexpr int kSmem = kBarOff + 16 + 1024;
  static constexpr unsigned kSwizzle = kRow / 16 - 1;  // 64-byte (3) or 128-byte (7) mode
  static_assert(kSmem <= 232448, "shared memory");
};

// xmap: x (B, D, H, W, C) fp32 as a 5-D map, box (KW, 18, 18, 1, 1).
template <int KP>
__global__ void __launch_bounds__(256, KP == 16 ? 2 : 1)
conv3d_to1_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ w,
                         float* __restrict__ y, int D, int H, int W, int C, int seg_len) {
  using Cfg = To1Tf32Cfg<KP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));  // base, generic
  float* zs = reinterpret_cast<float*>(gen + Cfg::kZOff);
  uint2* wf = reinterpret_cast<uint2*>(gen + Cfg::kWOff);
  const uint32_t full0 = base + Cfg::kBarOff;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles_w = (W + kPatch - 1) / kPatch;
  const int patches = tiles_w * ((H + kPatch - 1) / kPatch);
  const int patch = blockIdx.x % patches, b = blockIdx.x / patches;
  const int w0 = (patch % tiles_w) * kPatch, h0 = (patch / tiles_w) * kPatch;
  const int d0 = blockIdx.y * seg_len;
  const int d1 = min(D, d0 + seg_len);
  const int n_it = d1 - d0 + 2;  // input planes d0 - 1 .. d1

  if (tid == 0) {
    mbar_init(full0, 1);
    mbar_init(full0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the split weights in fragment order: (part, kk, j, lane) -> {b0, b1},
  // b0 = w[t = 8j + g][c = 8kk + t4], b1 = the channel 4 on; zeros past tap
  // 27 and past channel C
  for (int i = tid; i < (KP / 8) * 4 * 32; i += 256) {
    const int l = i & 31, j = (i >> 5) & 3, kk = i >> 7;
    const int t = 8 * j + (l >> 2), c = 8 * kk + (l & 3);
    const float v0 = t < 27 && c < C ? __ldg(w + t * C + c) : 0.f;
    const float v1 = t < 27 && c + 4 < C ? __ldg(w + t * C + c + 4) : 0.f;
    unsigned big0, small0, cross0, big1, small1, cross1;
    split_tf32(v0, big0, small0, cross0);
    split_tf32(v1, big1, small1, cross1);
    wf[i] = make_uint2(big0, big1);
    wf[(KP / 8) * 128 + i] = make_uint2(small0, small1);
  }
  __syncthreads();
  auto fetch = [&](int it) {  // one thread: the haloed patch of input plane d0 - 1 + it
    const uint32_t full = full0 + 8 * (it & 1);
    mbar_expect_tx(full, Cfg::kSubs * Cfg::kBox);
#pragma unroll
    for (int sub = 0; sub < Cfg::kSubs; ++sub)
      tma_load_5d(base + (it & 1) * Cfg::kIn + sub * Cfg::kSub, &xmap, full, sub * Cfg::kKW,
                  w0 - 1, h0 - 1, d0 - 1 + it, b);
  };
  if (tid == 0) {
    fetch(0);
    fetch(1);
  }

  const int oh = tid >> 4, ow = tid & 15;  // this thread's output of the patch
  const bool out_ok = h0 + oh < H && w0 + ow < W;
  const int ksteps = (C + 7) / 8;  // k8 steps that hold channels
  float part[2] = {0.f, 0.f};      // running sums of output planes it - 1 and it - 2 (local)
  for (int it = 0; it < n_it; ++it) {
    mbar_wait(full0 + 8 * (it & 1), (it >> 1) & 1);
    const uint32_t in = base + (it & 1) * Cfg::kIn;
    for (int tile = warp; tile < kPatchTiles; tile += 8) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP / 8; ++kk) {
        if (kk >= ksteps) break;
        // regs 0, 2: voxel g, channels 8kk + t4, + 4; regs 1, 3: voxel g + 8
        const uint32_t lin = (tile * 16 + (lane & 15)) * Cfg::kRow +
                             ((kk % (Cfg::kKW / 8)) * 2 + (lane >> 4)) * 16;
        const uint32_t sub = in + (kk / (Cfg::kKW / 8)) * Cfg::kSub;
        unsigned raw[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(raw[0]), "=r"(raw[1]), "=r"(raw[2]), "=r"(raw[3])
                     : "r"(sub + (lin ^ (((lin >> 7) & Cfg::kSwizzle) << 4))));
        unsigned a[3][4];  // part (big, small, cross), register
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(raw[e]), a[0][e], a[1][e], a[2][e]);
        // small * cross', cross * small', big * big', each over the 4 n8 tiles
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint2 bb = wf[(kk * 4 + j) * 32 + lane];
          const uint2 bs = wf[(KP / 8) * 128 + (kk * 4 + j) * 32 + lane];
          const unsigned c0 = fabsf(__uint_as_float(bb.x)) <= 3.402823466e38f ? bb.x : 0u;
          const unsigned c1 = fabsf(__uint_as_float(bb.y)) <= 3.402823466e38f ? bb.y : 0u;
          mma_tf32(acc[j], a[1], c0, c1);
          mma_tf32(acc[j], a[2], bs.x, bs.y);
          mma_tf32(acc[j], a[0], bb.x, bb.y);
        }
      }
      // accumulators: e = 0, 1 -> voxel g, taps 8j + 2 t4, + 1; e = 2, 3 -> voxel g + 8
      float* zv = zs + tile * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = j * 8 + 2 * t4;
        if (t < 27) {
          zv[t * kZStride] = acc[j][0];
          zv[t * kZStride + 8] = acc[j][2];
        }
        if (t + 1 < 27) {
          zv[(t + 1) * kZStride] = acc[j][1];
          zv[(t + 1) * kZStride + 8] = acc[j][3];
        }
      }
    }
    __syncthreads();  // this plane's Z is written; its input buffer is free
    if (tid == 0 && it + 2 < n_it) fetch(it + 2);
    // input plane it feeds output plane it (local; kd = 0), it - 1 (kd = 1)
    // and it - 2 (kd = 2), which is then complete
    float sum[3] = {0.f, part[0], part[1]};
    const float* zp = zs + oh * kHalo + ow;
#pragma unroll
    for (int kd = 0; kd < 3; ++kd)
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          sum[kd] += zp[(kd * 9 + kh * 3 + kw) * kZStride + kh * kHalo + kw];
    if (it >= 2 && out_ok) {
      const long long plane = static_cast<long long>(b) * D + (d0 + it - 2);
      y[(plane * H + h0 + oh) * W + w0 + ow] = sum[2];
    }
    part[0] = sum[0];
    part[1] = sum[1];
    __syncthreads();  // the Z plane may be overwritten
  }
}

// C % 8 == 0 goes by TMA (16-byte aligned x), C % 8 == 4 by 8-byte cp.async.
inline bool to1_mma_eligible(const void* x, int C, int dtype) {
  const uintptr_t align = C % 8 == 0 ? 15 : 7;
  return dtype == kBFloat16 && C % 4 == 0 && C > 0 && C <= 64 &&
         (reinterpret_cast<uintptr_t>(x) & align) == 0;
}

template <int KP, bool kTma>
inline int launch_to1_mma_c(const CUtensorMap& xmap, const void* x, const void* w, void* y, int B,
                            int D, int H, int W, int C, cudaStream_t s) {
  using Cfg = To1Cfg<KP>;
  auto kernel = conv3d_to1_mma_kernel<KP, kTma>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int patches = ((W + kPatch - 1) / kPatch) * ((H + kPatch - 1) / kPatch);
  int per_sm = 0;
  const cudaError_t occ =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, Cfg::kSmem);
  if (occ != cudaSuccess) return static_cast<int>(occ);
  const int seg_len = plane_seg_len(patches * B, D, per_sm > 0 ? per_sm : 1);
  const dim3 grid(patches * B, (D + seg_len - 1) / seg_len);
  kernel<<<grid, 256, Cfg::kSmem, s>>>(xmap, static_cast<const __nv_bfloat16*>(x),
                                       static_cast<const __nv_bfloat16*>(w),
                                       static_cast<__nv_bfloat16*>(y), D, H, W, C, seg_len);
  return static_cast<int>(cudaGetLastError());
}

// x (B,D,H,W,C) bf16, w (27,C), y (B,D,H,W), on operands to1_mma_eligible()
// takes. The tensor map is encoded per call; nothing is cached.
inline int launch_to1_mma(const void* x, const void* w, void* y, int B, int D, int H, int W, int C,
                          cudaStream_t s) {
  const int kp = C <= 16 ? 16 : C <= 32 ? 32 : 64;
  CUtensorMap xmap = {};
  if (C % 8 != 0) {  // cp.async; the map is not read
    if (kp == 64) return launch_to1_mma_c<64, false>(xmap, x, w, y, B, D, H, W, C, s);
    if (kp == 32) return launch_to1_mma_c<32, false>(xmap, x, w, y, B, D, H, W, C, s);
    return launch_to1_mma_c<16, false>(xmap, x, w, y, B, D, H, W, C, s);
  }
  const cuuint64_t row = static_cast<cuuint64_t>(C) * 2;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * D};
  // a box kp channels wide: channels C .. kp - 1 lie outside the tensor and arrive as zeros
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(kp), kHalo, kHalo, 1, 1};
  const CUtensorMapSwizzle swizzle = kp == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : kp == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  if (!encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 5, dims, strides, box, swizzle))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kp == 64) return launch_to1_mma_c<64, true>(xmap, x, w, y, B, D, H, W, C, s);
  if (kp == 32) return launch_to1_mma_c<32, true>(xmap, x, w, y, B, D, H, W, C, s);
  return launch_to1_mma_c<16, true>(xmap, x, w, y, B, D, H, W, C, s);
}

// The fp32 form: C a multiple of 4 up to 64 (a row of 16-byte multiples, so
// TMA takes every C) and a 16-byte aligned x.
inline bool to1_tf32x3_eligible(const void* x, int C, int dtype) {
  return dtype == kFloat32 && C % 4 == 0 && C > 0 && C <= 64 &&
         (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

template <int KP>
inline int launch_to1_tf32x3_c(const CUtensorMap& xmap, const void* w, void* y, int B, int D,
                               int H, int W, int C, cudaStream_t s) {
  using Cfg = To1Tf32Cfg<KP>;
  auto kernel = conv3d_to1_tf32x3_kernel<KP>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int patches = ((W + kPatch - 1) / kPatch) * ((H + kPatch - 1) / kPatch);
  int per_sm = 0;
  const cudaError_t occ =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, Cfg::kSmem);
  if (occ != cudaSuccess) return static_cast<int>(occ);
  const int seg_len = plane_seg_len(patches * B, D, per_sm > 0 ? per_sm : 1);
  const dim3 grid(patches * B, (D + seg_len - 1) / seg_len);
  kernel<<<grid, 256, Cfg::kSmem, s>>>(xmap, static_cast<const float*>(w), static_cast<float*>(y),
                                       D, H, W, C, seg_len);
  return static_cast<int>(cudaGetLastError());
}

// x (B,D,H,W,C) fp32, w (27,C), y (B,D,H,W), on operands to1_tf32x3_eligible()
// takes. The tensor map is encoded per call; nothing is cached.
inline int launch_to1_tf32x3(const void* x, const void* w, void* y, int B, int D, int H, int W,
                             int C, cudaStream_t s) {
  const int kp = C <= 16 ? 16 : C <= 32 ? 32 : 64;
  const int kw = kp < 32 ? kp : 32;  // channels a box
  const cuuint64_t row = static_cast<cuuint64_t>(C) * 4;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * D};
  // channels past C lie outside the tensor and arrive as zeros
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(kw), kHalo, kHalo, 1, 1};
  CUtensorMap xmap;
  if (!encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 5, dims, strides, box,
                  kw == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kp == 64) return launch_to1_tf32x3_c<64>(xmap, w, y, B, D, H, W, C, s);
  if (kp == 32) return launch_to1_tf32x3_c<32>(xmap, w, y, B, D, H, W, C, s);
  return launch_to1_tf32x3_c<16>(xmap, w, y, B, D, H, W, C, s);
}

}  // namespace sivae
