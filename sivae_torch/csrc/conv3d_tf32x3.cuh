// The fp32 body of the 3x3x3 SAME stride-1 convolution on the tensor cores,
// "tf32x3": fp32 with Ci % 32 == 0, Co % 32 == 0 and 16-byte aligned tensors
// (every fp32 site of spatial_1200 and spatial_1200_fullsize, 32-256
// channels, forward and input gradient), sm_90a only (wgmma, TMA, mbarrier,
// setmaxnreg). The implicit GEMM of conv3d_wgmma.cuh (M = B*D*H*W voxels,
// N = Co, K = 27*Ci), in fp32.
//
// Why three products. A TF32 operand keeps 11 of fp32's 24 significand
// bits: one TF32 product over K = 27 * 64 = 1728 is off by ~3e-4 of the
// largest output, over the port's 1e-4 fp32 tolerance. Each operand is
// split into big = tf32(v) and small = tf32(v - big) (split_tf32,
// ptx.cuh), and each k-step multiplies small * big' and big * small', then
// big * big', into fp32 accumulators; small * small' is below fp32's last
// bit and is dropped. (The cross products take big as 0 where it is not
// finite, so that inf propagates as in one fp32 product.) That holds fp32
// accuracy (~2e-7 of the largest output at K = 1728 against a float64
// reference, as fp32 FMA in order) at a third of the 495 TF/s TF32 rate:
// 165 TF/s, the bound chip_smoke.py takes for fp32 work, against the CUDA
// cores' 67 TF/s that held the "fma" body (conv3d_body.cuh), which this one
// replaces at these shapes. mma.sync cannot get there: on this card an
// m16n8k8 tf32 mma.sync issues about once per 16 cycles per SM quarter
// (~134 TF/s), and the same three-product split on it took 7.4 ms at
// 64->64, 80x96x80, batch 2, slower than cuDNN's 6.7 ms (H100 80GB HBM3,
// 700 W); wgmma runs the TF32 rate.
//
// Structure: conv3d_wgmma.cuh's. One producer thread feeds a ring of stages
// by TMA, two consumer warpgroups multiply with wgmma.mma_async m64nNk8
// tf32, synchronised by mbarriers. A stage holds one (kd, kh) line buffer
// of 32 fp32 channels (kMT boxes of 136 rows of 128 B, swizzled) and, for
// the 3 kw taps, the weights' three parts (big, small, cross), each a
// K-major N x 32 tile: tf32 wgmma takes B only K-major, so the launch first
// splits and transposes the weights once into a scratch tensor (27 x Ci x
// Co values, a few microseconds) that TMA reads. A comes from registers
// (the RS form): ldmatrix on the swizzled line buffer gives the m16n8k8 A
// fragment directly (an 8x8 b16 matrix is 8 rows of 4 fp32), the SAME
// padding is the tap mask of conv3d_wgmma.cuh zeroing fragment rows, and
// the split runs per fragment. Three register sets of A fragments keep two
// k-steps' wgmmas in flight while the next one is loaded and split. The
// epilogue stores each thread's accumulator pairs as 8-byte stores, 4 lanes
// to a row's 32-byte sector.

#pragma once

#include <stdint.h>

#include "common.cuh"
#include "conv3d_wgmma.cuh"  // kBoxRows, kConsumerWarps, kSmemMax, tap_mask
#include "ptx.cuh"

namespace sivae {

constexpr int TK = 32;  // fp32 channels a stage: one 128-byte swizzled row

// kMT m64 tiles per consumer warpgroup (block rows = 128 * kMT), kN output
// channels per block (64, or 32 where Co is not a multiple of 64)
template <int kMT, int kN>
struct Tf32Cfg {
  static constexpr int kM = 128 * kMT;
  static constexpr int kABytes = kMT * kBoxRows * TK * 4;  // line buffer
  static constexpr int kBTile = kN * TK * 4;               // one tap's one part, K-major
  static constexpr int kStage = kABytes + 9 * kBTile;      // + 3 kw taps x 3 parts
  static constexpr int kFit = (kSmemMax - 2048) / kStage;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static constexpr int kBarOff = kStages * kStage;
  static constexpr int kSmem = kBarOff + 128 + 1024;  // barriers, room to align the base
  static_assert(kABytes % 1024 == 0 && kBTile % 1024 == 0, "swizzle atoms are 1024 B");
  static_assert(kStages >= 2 && 2 * kStages * 8 <= 128, "ring depth");
};

// w (27, Ci, Co) -> ws (3, 27, Co, Ci): the big, small and cross parts of
// every weight (split_tf32), K-major for the wgmma B operand
__global__ void __launch_bounds__(256)
tf32x3_split_weights(const float* __restrict__ w, float* __restrict__ ws, int Ci, int Co) {
  const long long n = 27LL * Ci * Co;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int ci = static_cast<int>(i % Ci);
    const long long r = i / Ci;  // tap * Co + co
    const int co = static_cast<int>(r % Co), tap = static_cast<int>(r / Co);
    unsigned big, small, cross;
    split_tf32(__ldg(w + (static_cast<long long>(tap) * Ci + ci) * Co + co), big, small, cross);
    ws[i] = __uint_as_float(big);
    ws[n + i] = __uint_as_float(small);
    ws[2 * n + i] = __uint_as_float(cross);
  }
}

// 384 threads: warpgroups 0 and 1 consume (each kMT m64 tiles of the block's
// rows), warpgroup 2 produces (one thread; the rest leave). xmap: the input
// as (n_vox, Ci) fp32, box 136 x 32, 128-byte swizzle. wmap: the split
// weights as (3 * 27 * Co, Ci), box kN x 32, 128-byte swizzle.
template <int kMT, int kN>
__global__ void __launch_bounds__(384, 1)
conv3d_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, float* __restrict__ y, int B, int D,
                     int H, int W, int Ci, int Co) {
  using Cfg = Tf32Cfg<kMT, kN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t full0 = base + Cfg::kBarOff, empty0 = full0 + Cfg::kStages * 8;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  const unsigned m0 = blockIdx.x * Cfg::kM;
  const int n0 = blockIdx.y * kN;
  const int chunks = Ci / TK;
  const int steps = 9 * chunks;

  if (tid == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                // the producer's arrive + the copies' bytes
      mbar_init(empty0 + 8 * s, kConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer -----------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      const int HW = H * W;
      int stage = 0;
      uint32_t parity = 1;  // a fresh "empty" barrier lets the first round pass
      for (int lp = 0; lp < 9; ++lp) {
        const int row0 = static_cast<int>(m0) - 1 + (lp / 3 - 1) * HW + (lp % 3 - 1) * W;
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(empty0 + 8 * stage, parity);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t a = base + stage * Cfg::kStage;
          mbar_expect_tx(full, Cfg::kStage);
#pragma unroll
          for (int q = 0; q < kMT; ++q)
            tma_load_2d(a + q * kBoxRows * TK * 4, &xmap, full, c * TK, row0 + q * kBoxRows);
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int part = 0; part < 3; ++part)
              tma_load_2d(a + Cfg::kABytes + (kw * 3 + part) * Cfg::kBTile, &wmap, full, c * TK,
                          (part * 27 + lp * 3 + kw) * Co + n0);
          if (++stage == Cfg::kStages) {
            stage = 0;
            parity ^= 1u;
          }
        }
      }
    }
  } else {
    // ---- consumers ------------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid & 31, wq = (tid >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int row_wg = wg * 64 * kMT + wq * 16;  // this warp's first row of tile 0

    // the A-fragment rows this thread holds: g and g + 8 of each m64 tile's 16
    uint32_t mask[kMT][2];
#pragma unroll
    for (int t = 0; t < kMT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mask[t][h] = tap_mask(m0 + row_wg + t * 64 + g + 8 * h, n_vox, D, H, W);

    float acc[kMT][kN / 2];
#pragma unroll
    for (int t = 0; t < kMT; ++t)
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[t][i] = 0.f;

    // ldmatrix row address of this lane: slot (output row + kw), 16-byte piece
    const int l_row = lane & 15, l_hi = lane >> 4;
    // three sets of A fragments (two k-steps' wgmmas read theirs while the
    // third is loaded): [set][tile][part: big, small, cross][register]
    unsigned fa[3][kMT][3][4];

    int stage = 0, lp = 0;
    uint32_t parity = 0;
    for (int step = 0, lc = 0; step < steps; ++step) {
      mbar_wait(full0 + 8 * stage, parity);
      const uint32_t a_base = base + stage * Cfg::kStage;
      const uint32_t b_base = a_base + Cfg::kABytes;
      uint32_t ok[kMT][2];  // this (kd, kh)'s three kw bits of each owned row
#pragma unroll
      for (int t = 0; t < kMT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) ok[t][h] = mask[t][h] >> (3 * lp);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
        for (int kk = 0; kk < TK / 8; ++kk) {  // k8 steps: 32 bytes of each 128-byte row
          const int gi = kw * (TK / 8) + kk, set = gi % 3;
          if (gi >= 3) wgmma_wait<2>();  // the wgmmas of k-step gi - 3 have read this set
#pragma unroll
          for (int t = 0; t < kMT; ++t) {
            const int slot = row_wg + t * 64 + l_row + kw;
            const uint32_t piece = static_cast<uint32_t>((kk * 2 + l_hi) ^ (slot & 7));
            unsigned raw[4];  // regs 0, 2: row g; regs 1, 3: row g + 8
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                         : "=r"(raw[0]), "=r"(raw[1]), "=r"(raw[2]), "=r"(raw[3])
                         : "r"(a_base + slot * (TK * 4) + (piece << 4)));
            if (!((ok[t][0] >> kw) & 1u)) raw[0] = raw[2] = 0u;  // row g
            if (!((ok[t][1] >> kw) & 1u)) raw[1] = raw[3] = 0u;  // row g + 8
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_tf32(__uint_as_float(raw[e]), fa[set][t][0][e], fa[set][t][1][e],
                         fa[set][t][2][e]);
          }
          wgmma_fence();
          // the k8 slice of a K-major swizzled tile starts 32 bytes further
          const uint32_t bt = b_base + kw * 3 * Cfg::kBTile + kk * 32;
#pragma unroll
          for (int t = 0; t < kMT; ++t) {
            wgmma_tf32_rs<kN>(acc[t], fa[set][t][1], smem_desc(bt + 2 * Cfg::kBTile));  // s * c'
            wgmma_tf32_rs<kN>(acc[t], fa[set][t][2], smem_desc(bt + Cfg::kBTile));      // c * s'
            wgmma_tf32_rs<kN>(acc[t], fa[set][t][0], smem_desc(bt));                    // b * b'
          }
          wgmma_commit();
        }
      }
      wgmma_wait<0>();  // the stage's weight tiles have been read
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == Cfg::kStages) {
        stage = 0;
        parity ^= 1u;
      }
      if (++lc == chunks) {
        lc = 0;
        ++lp;
      }
    }
#pragma unroll
    for (int t = 0; t < kMT; ++t)
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) asm volatile("" : "+f"(acc[t][i])::"memory");

    // accumulator layout: registers 4j .. 4j+3 are columns 8j + 2 t4, + 1 of
    // row g (first two) and row g + 8 (last two)
#pragma unroll
    for (int t = 0; t < kMT; ++t) {
      const unsigned m = m0 + row_wg + t * 64 + g;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        float* yr = y + static_cast<long long>(m) * Co + n0 + 8 * j + 2 * t4;
        if (m < n_vox)
          *reinterpret_cast<float2*>(yr) = make_float2(acc[t][4 * j], acc[t][4 * j + 1]);
        if (m + 8 < n_vox)
          *reinterpret_cast<float2*>(yr + 8LL * Co) =
              make_float2(acc[t][4 * j + 2], acc[t][4 * j + 3]);
      }
    }
  }
}

inline bool tf32x3_eligible(const void* x, const void* w, const void* y, int Ci, int Co,
                            int dtype) {
  const uintptr_t mask = 15;
  return dtype == kFloat32 && Ci % TK == 0 && Co % 32 == 0 &&
         ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
           reinterpret_cast<uintptr_t>(y)) & mask) == 0;
}

template <int kMT, int kN>
inline int launch_tf32x3(const CUtensorMap& xmap, const CUtensorMap& wmap, void* y, int B, int D,
                         int H, int W, int Ci, int Co, unsigned n_vox, cudaStream_t s) {
  using Cfg = Tf32Cfg<kMT, kN>;
  auto kernel = conv3d_tf32x3_kernel<kMT, kN>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((n_vox + Cfg::kM - 1) / Cfg::kM, Co / kN);
  kernel<<<grid, 384, Cfg::kSmem, s>>>(xmap, wmap, static_cast<float*>(y), B, D, H, W, Ci, Co);
  return static_cast<int>(cudaGetLastError());
}

// x (B,D,H,W,Ci), w (3,3,3,Ci,Co), y (B,D,H,W,Co) fp32, on operands
// tf32x3_eligible() takes; scratch: 3 * 27 * Ci * Co floats, 16-byte aligned,
// for the split weights. Blocks of 256 rows where that fills the card, of
// 128 where it does not (the small sites). The tensor maps are encoded per
// call; nothing is cached. Returns cudaGetLastError() after the launches.
inline int launch_conv3d_tf32x3(const void* x, const void* w, void* y, void* scratch, int B,
                                int D, int H, int W, int Ci, int Co, cudaStream_t s) {
  if (scratch == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_w = 27LL * Ci * Co;
  const int split_blocks = static_cast<int>(n_w / 256 + 1 < 1024 ? n_w / 256 + 1 : 1024);
  tf32x3_split_weights<<<split_blocks, 256, 0, s>>>(static_cast<const float*>(w),
                                                    static_cast<float*>(scratch), Ci, Co);
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  const int kn = Co % 64 == 0 ? 64 : 32;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(Ci), n_vox};
  const cuuint64_t xstr[1] = {static_cast<cuuint64_t>(Ci) * 4};
  const cuuint32_t xbox[2] = {TK, kBoxRows};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(Ci), static_cast<cuuint64_t>(3 * 27) * Co};
  const cuuint64_t wstr[1] = {static_cast<cuuint64_t>(Ci) * 4};
  const cuuint32_t wbox[2] = {TK, static_cast<cuuint32_t>(kn)};
  if (!encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 2, xdims, xstr, xbox,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scratch, 2, wdims, wstr, wbox,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks256 = (static_cast<long long>(n_vox) + 255) / 256 * (Co / kn);
  const bool wide = blocks256 >= device_sms();
  if (kn == 64)
    return wide ? launch_tf32x3<2, 64>(xmap, wmap, y, B, D, H, W, Ci, Co, n_vox, s)
                : launch_tf32x3<1, 64>(xmap, wmap, y, B, D, H, W, Ci, Co, n_vox, s);
  return wide ? launch_tf32x3<2, 32>(xmap, wmap, y, B, D, H, W, Ci, Co, n_vox, s)
              : launch_tf32x3<1, 32>(xmap, wmap, y, B, D, H, W, Ci, Co, n_vox, s);
}

}  // namespace sivae
