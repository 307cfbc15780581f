// The tensor-core body of the C -> 1 3x3x3 SAME convolution: bf16 with
// C = 16, 32 or 64 and a 16-byte aligned input, for sm_90 and later (TMA,
// mbarrier, mma.sync).
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
// along d over its segment of planes. Per input plane one 5-D TMA box brings
// the 18 x 18 haloed patch (324 voxels x C channels) into one of two
// swizzled buffers; coordinates outside the volume arrive as zeros, which is
// all of the SAME padding (w, h and d edges). The 8 warps share the 21 m16
// tiles of those voxels: ldmatrix for A, the 27 x C weights resident in
// registers as B fragments, mma.sync m16n8k16 (the tensor work is a few
// percent of the bound; wgmma is not needed). Z of the last three planes
// lives in a rolling buffer, tap-major ([t][voxel], voxel stride 340 floats),
// so that the fragment stores and the 27 reads of consecutive w are free of
// bank conflicts. The halo costs 324 / 256 = 1.27x the patch's bytes from L2
// (device memory sees each byte about once) and 2 extra planes per segment.

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

template <int C>
struct To1Cfg {
  static constexpr int kRow = C * 2;                                      // bytes per voxel
  static constexpr int kBox = kPatchVox * kRow;                           // bytes a TMA box brings
  static constexpr int kIn = (kPatchTiles * 16 * kRow + 1023) / 1024 * 1024;
  static constexpr int kZOff = 2 * kIn;
  static constexpr int kBarOff = kZOff + 3 * kZPlane;
  static constexpr int kSmem = kBarOff + 16 + 1024;
  static constexpr unsigned kSwizzle = C / 8 - 1;  // 16-byte pieces XORed: 128 / 64 / 32-byte mode
};

template <int C>
__global__ void __launch_bounds__(256, 1)
conv3d_to1_mma_kernel(const __grid_constant__ CUtensorMap xmap, const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ y, int D, int H, int W, int seg_len) {
  using Cfg = To1Cfg<C>;
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

  if (tid == 0) {
    mbar_init(full0, 1);
    mbar_init(full0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto fetch = [&](int it) {  // one thread: the haloed patch of input plane d0 - 1 + it
    const uint32_t full = full0 + 8 * (it & 1);
    mbar_expect_tx(full, Cfg::kBox);
    tma_load_5d(base + (it & 1) * Cfg::kIn, &xmap, full, 0, w0 - 1, h0 - 1, d0 - 1 + it, b);
  };
  if (tid == 0) {
    fetch(0);
    fetch(1);
  }

  // B fragments of all taps: b0 = w[t = 8j + g][16kk + 2 t4, +1], b1 the same 8 channels on
  unsigned bw[C / 16][4][2];
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = j * 8 + g;
      const unsigned* p = reinterpret_cast<const unsigned*>(w + t * C + kk * 16 + 2 * t4);
      bw[kk][j][0] = t < 27 ? __ldg(p) : 0u;
      bw[kk][j][1] = t < 27 ? __ldg(p + 4) : 0u;
    }

  const int oh = tid >> 4, ow = tid & 15;  // this thread's output of the patch
  const bool out_ok = h0 + oh < H && w0 + ow < W;
  for (int it = 0; it < n_it; ++it) {
    mbar_wait(full0 + 8 * (it & 1), (it >> 1) & 1);
    const uint32_t in = base + (it & 1) * Cfg::kIn;
    float* z = zs + (it % 3) * (kZPlane / 4);
    for (int tile = warp; tile < kPatchTiles; tile += 8) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        const uint32_t lin = (tile * 16 + (lane & 15)) * Cfg::kRow + (kk * 2 + (lane >> 4)) * 16;
        unsigned fa[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(fa[0]), "=r"(fa[1]), "=r"(fa[2]), "=r"(fa[3])
                     : "r"(in + (lin ^ (((lin >> 7) & Cfg::kSwizzle) << 4))));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[j], fa, bw[kk][j][0], bw[kk][j][1]);
      }
      // accumulators: e = 0, 1 -> voxel g, taps 8j + 2 t4, + 1; e = 2, 3 -> voxel g + 8
      float* zv = z + tile * 16 + g;
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
    if (it >= 2) {    // output plane d0 + it - 2 from the Z of input planes it - 2, it - 1, it
      float acc = 0.f;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const float* zp = zs + ((it + 1 + kd) % 3) * (kZPlane / 4) + oh * kHalo + ow;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            acc += zp[(kd * 9 + kh * 3 + kw) * kZStride + kh * kHalo + kw];
      }
      if (out_ok) {
        const long long plane = static_cast<long long>(b) * D + (d0 + it - 2);
        y[(plane * H + h0 + oh) * W + w0 + ow] = __float2bfloat16(acc);
      }
    }
    __syncthreads();  // the oldest Z plane may be overwritten
  }
}

inline bool to1_mma_eligible(const void* x, int C, int dtype) {
  return dtype == kBFloat16 && (C == 16 || C == 32 || C == 64) &&
         (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// Planes per segment of a block that marches along d (this body and the
// 1 -> C one): per_sm blocks run on an SM at a time, so the kernel lasts
// (rounds of blocks over the SMs) x (planes a block reads, 2 of them halo); take the
// split of D that makes that product least.
inline int plane_seg_len(int patches, int D, int per_sm) {
  const int sms = device_sms() * per_sm;
  int best_len = D;
  long long best = -1;
  for (int segs = 1; segs <= D; ++segs) {
    const int len = (D + segs - 1) / segs;
    const long long blocks = static_cast<long long>(patches) * ((D + len - 1) / len);
    const long long cost = (blocks + sms - 1) / sms * (len + 2);
    if (best < 0 || cost < best) {
      best = cost;
      best_len = len;
    }
  }
  return best_len;
}

template <int C>
inline int launch_to1_mma_c(const CUtensorMap& xmap, const void* w, void* y, int B, int D, int H,
                            int W, cudaStream_t s) {
  using Cfg = To1Cfg<C>;
  auto kernel = conv3d_to1_mma_kernel<C>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int patches = ((W + kPatch - 1) / kPatch) * ((H + kPatch - 1) / kPatch);
  const int seg_len = plane_seg_len(patches * B, D, 1);
  const dim3 grid(patches * B, (D + seg_len - 1) / seg_len);
  kernel<<<grid, 256, Cfg::kSmem, s>>>(xmap, static_cast<const __nv_bfloat16*>(w),
                                       static_cast<__nv_bfloat16*>(y), D, H, W, seg_len);
  return static_cast<int>(cudaGetLastError());
}

// x (B,D,H,W,C) bf16, w (27,C), y (B,D,H,W), on operands to1_mma_eligible()
// takes. The tensor map is encoded per call; nothing is cached.
inline int launch_to1_mma(const void* x, const void* w, void* y, int B, int D, int H, int W, int C,
                          cudaStream_t s) {
  CUtensorMap xmap;
  const cuuint64_t row = static_cast<cuuint64_t>(C) * 2;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * D};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(C), kHalo, kHalo, 1, 1};
  const CUtensorMapSwizzle swizzle = C == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : C == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  if (!encode_bf16_map(&xmap, x, 5, dims, strides, box, swizzle))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 64) return launch_to1_mma_c<64>(xmap, w, y, B, D, H, W, s);
  if (C == 32) return launch_to1_mma_c<32>(xmap, w, y, B, D, H, W, s);
  return launch_to1_mma_c<16>(xmap, w, y, B, D, H, W, s);
}

}  // namespace sivae
