// "narrow_tf32x3": the fp32 body of the 3x3x3 SAME stride-1 convolution at
// the channel counts of the FC family and of spatial_150 (fp32, Ci and Co
// multiples of 4 up to 64, not both multiples of 32: 12/16/24/32/48,
// forward and input gradient; the eval CLI's default and `--no-bf16`
// training), sm_90a only. It replaces the CUDA-core "fma" body
// (conv3d_body.cuh) there.
//
// What bounds it (12->12 at 80x96x80, batch 8): 3.8e10 fp32 flops, 0.23 ms
// at 165 TF/s (the three TF32 products fp32 accuracy takes, a third of
// the 495 TF/s TF32 rate; conv3d_tf32x3.cuh says why three); 472 MB in and
// out, 0.14 ms at 3.35 TB/s.
//
// Structure: conv3d_tf32x3.cuh's implicit GEMM (M = B*D*H*W voxels, K =
// 27*Ci) with one producer thread feeding a ring of stages, one per (kd, kh)
// and 32-channel chunk, and two consumer warpgroups multiplying with
// wgmma.mma_async m64nNk8 tf32 on A fragments split in registers (ldmatrix
// on the fp32 line, big / small / cross) and B tiles in shared memory. What
// differs, and why:
// - Fewer, wider wgmmas. At N <= 64 a wgmma m64nNk8 tf32 with A from
//   registers costs the SM about the same time whatever N: the first form
//   of this body, the tf32x3 kernel with N = Co rounded up to 16, spent
//   about as long per wgmma at 12->12 as the wide body does at N = 64
//   (H100 80GB HBM3, 700 W; chip_smoke.py phase 3: 2.89 ms there, 8% of
//   the bound). So where Co <= 32 (kKwInN) the 3 kw taps are N's three
//   thirds: one m64n48k8 (N = 3 x 16; 72 and 96 at Co = 24 and 32) takes a
//   line row's A fragment against all 3 taps, a third of the wgmmas and of
//   the A splits. A block's 256 rows are then line rows, Z[r, kw, co] sums
//   line row r times tap (kd, kh, kw) over (kd, kh) and the channels, and
//   output j (254 a block) is Z[j, 0] + Z[j + 1, 1] + Z[j + 2, 2], summed
//   from shared memory after the loop with the kw that cross a row's edge
//   left out. A (kd, kh) mask then depends on the line row alone
//   (line_mask), since a kw that stays in the output's row keeps its d and
//   h. Where Co > 32 the accumulators of N = 144 or 192 would not fit, and
//   each tap keeps its own wgmma (N = 48 or 64), as in tf32x3.
// - Copies, not box rows, where they cost nothing: each stage's weight
//   tiles (3 kw taps x big, small, cross, 32 channels, K-major, 128-byte
//   swizzled) are ONE contiguous bulk copy; the launch's split pass writes
//   the weights into the scratch in that byte order, stage by stage, zeros
//   past Ci and Co. Where Ci % 8 == 4 (12, 20, 28: a voxel row is an odd
//   number of 16-byte units, so 8 consecutive rows fall in 8 distinct bank
//   groups without a swizzle) the stage's input line, the voxels the
//   block's rows read for one (kd, kh), is one bulk copy of its in-volume
//   voxels, unpadded; elsewhere (Ci % 8 == 0, where unpadded rows would
//   conflict, and where such a line leaves room for fewer than 3 stages) it
//   comes as 2 TMA boxes of 136 voxel rows x 32 channels (the channels past
//   Ci as zeros), swizzled.
// - K = Ci rounded up to 8: the last chunk runs only the k8 steps that hold
//   channels (kKT). An unpadded line puts the next voxel's channels where a
//   padded one has zeros, so A registers of channels >= Ci are set to 0
//   (the weights there are 0 too, and an inf there would give NaN).
// - The ring's depth follows the stage's size (up to 8 stages: 7 at
//   12 -> 12), since a narrow stage is small.
// Voxels outside the volume are masked to zeros, so the part of a line
// outside [0, B*D*H*W) is never copied or read.

#pragma once

#include <stdint.h>

#include "common.cuh"
#include "conv3d_tf32x3.cuh"  // TK, tf32x3_eligible
#include "conv3d_wgmma.cuh"   // kBoxRows, kConsumerWarps, kSmemMax, tap_mask
#include "ptx.cuh"

namespace sivae {

constexpr int kNarrowTfRows = 256;  // rows a block: 2 warpgroups x 2 m64 tiles
constexpr int kNarrowTfMaxStages = 8;

// a count of k8 steps as a type, for a loop the compiler unrolls
template <int N>
struct KSteps {
  static constexpr int value = N;
};

// w (27, Ci, Co) -> ws: for each stage s = (kd * 3 + kh) * chunks + c,
// the B tiles of the stage's 3 kw taps and 3 parts (big, small, cross) for
// the 32 channels of chunk c as one contiguous run. kw_in_n: 3 tiles [part]
// of 3 * kn rows (row kw * kn + output channel), else 9 tiles [kw][part] of
// kn rows. K-major and 128-byte swizzled (16-byte piece q of row n at piece
// q ^ (n % 8)); zeros past Ci and Co.
__global__ void __launch_bounds__(256)
narrow_tf32x3_split_weights(const float* __restrict__ w, float* __restrict__ ws, int Ci, int Co,
                            int kn, int chunks, int kw_in_n) {
  const long long n = 81LL * chunks * kn * TK;
  const int rows = kw_in_n ? 3 * kn : kn;  // rows a tile
  const int tiles = kw_in_n ? 3 : 9;        // tiles a stage
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long r = i;
    const int k = static_cast<int>(r % TK);
    r /= TK;
    const int row = static_cast<int>(r % rows);
    r /= rows;
    const int tile = static_cast<int>(r % tiles);
    r /= tiles;
    const int c = static_cast<int>(r % chunks), lp = static_cast<int>(r / chunks);
    const int kw = kw_in_n ? row / kn : tile / 3, part = kw_in_n ? tile : tile % 3;
    const int co = kw_in_n ? row % kn : row, ci = c * TK + k, tap = lp * 3 + kw;
    unsigned p[3] = {0u, 0u, 0u};
    if (ci < Ci && co < Co)
      split_tf32(__ldg(w + (static_cast<long long>(tap) * Ci + ci) * Co + co), p[0], p[1], p[2]);
    ws[(i - k) + (((k >> 2) ^ (row & 7)) << 2) + (k & 3)] = __uint_as_float(p[part]);
  }
}

// The 9 (kd, kh) bits of a line row whose centre voxel (the kw = 1 source of
// its output) is b: bit kd * 3 + kh is set where that tap stays in the
// volume along d and h. kw is the epilogue's (the kw_in_n form).
__device__ __forceinline__ uint32_t line_mask(int b, unsigned n_vox, int D, int H, int W) {
  if (b < 0 || static_cast<unsigned>(b) >= n_vox) return 0u;
  const Vox v = decode_vox(static_cast<unsigned>(b), n_vox, D, H, W);
  const uint32_t okh = (v.h > 0 ? 1u : 0u) | 2u | (v.h < H - 1 ? 4u : 0u);  // kh = 0, 1, 2
  return (v.d > 0 ? okh : 0u) | (okh << 3) | (v.d < D - 1 ? okh << 6 : 0u);
}

// 384 threads: warpgroups 0 and 1 consume (2 m64 tiles each), warpgroup 2
// produces (one thread). flat: the line arrives unpadded by one bulk copy
// from x, else by xmap (the input as (n_vox, Ci), box 136 x 32, 128-byte
// swizzle). ws: the split weights in stage order. a_bytes: the input region
// of a stage (a multiple of 1024); the weight tiles follow it. kN: Co
// rounded up to 16, 24, 32, 48 or 64; kKwInN (kN <= 32): the 3 kw taps in
// N, 254 outputs a block (the header says how).
template <int kN, int kKT, bool kKwInN>
__global__ void __launch_bounds__(384, 1)
conv3d_narrow_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                            const float* __restrict__ x, const float* __restrict__ ws,
                            float* __restrict__ y, int B, int D, int H, int W, int Ci, int Co,
                            int flat, int a_bytes, int n_stages) {
  constexpr int kMT = 2;
  constexpr int kNA = kKwInN ? 3 * kN : kN;  // columns a wgmma (accumulator width)
  constexpr int kBTile = kNA * TK * 4;       // one B tile: a part (and a tap unless kKwInN)
  constexpr int kWBytes = 9 * kN * TK * 4;   // a stage's weights: 3 kw taps x 3 parts
  constexpr int kOut = kKwInN ? kNarrowTfRows - 2 : kNarrowTfRows;  // outputs a block
  static_assert(kBTile % 1024 == 0, "swizzle atoms are 1024 B");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int stage_bytes = a_bytes + kWBytes;
  const uint32_t full0 = base + n_stages * stage_bytes, empty0 = full0 + n_stages * 8;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  const unsigned m0 = blockIdx.x * kOut;
  const int chunks = (Ci + TK - 1) / TK;
  const int steps = 9 * chunks;

  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
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
        // the line: voxels row0 .. row0 + 257 (kw 0 .. 2 of outputs m0 ..
        // m0 + 255; 256 rows where kKwInN), of which those in [0, n_vox) are
        // copied in the flat form
        const int row0 = static_cast<int>(m0) - 1 + (lp / 3 - 1) * HW + (lp % 3 - 1) * W;
        const int lo = max(row0, 0);
        const int hi = min(row0 + kNarrowTfRows + (kKwInN ? 0 : 2), static_cast<int>(n_vox));
        const uint32_t line = hi > lo ? static_cast<uint32_t>(hi - lo) * Ci * 4 : 0u;
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(empty0 + 8 * stage, parity);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t a = base + stage * stage_bytes;
          if (flat) {
            mbar_expect_tx(full, line + kWBytes);
            if (line)
              bulk_load(a + (lo - row0) * Ci * 4, x + static_cast<long long>(lo) * Ci, line, full);
          } else {
            mbar_expect_tx(full, kMT * kBoxRows * TK * 4 + kWBytes);
#pragma unroll
            for (int q = 0; q < kMT; ++q)
              tma_load_2d(a + q * kBoxRows * TK * 4, &xmap, full, c * TK, row0 + q * kBoxRows);
          }
          bulk_load(a + a_bytes, ws + static_cast<long long>(lp * chunks + c) * (kWBytes / 4),
                    kWBytes, full);
          if (++stage == n_stages) {
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

    // the A-fragment rows this thread holds: g and g + 8 of each m64 tile's
    // 16; their 27 tap bits (9 (kd, kh) bits where kKwInN)
    uint32_t mask[kMT][2];
#pragma unroll
    for (int t = 0; t < kMT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_wg + t * 64 + g + 8 * h;
        mask[t][h] = kKwInN ? line_mask(static_cast<int>(m0) - 1 + row, n_vox, D, H, W)
                            : tap_mask(m0 + row, n_vox, D, H, W);
      }

    float acc[kMT][kNA / 2];
#pragma unroll
    for (int t = 0; t < kMT; ++t)
#pragma unroll
      for (int i = 0; i < kNA / 2; ++i) acc[t][i] = 0.f;

    // ldmatrix row address of this lane: slot (output row + kw, or line
    // row), 16-byte piece
    const int l_row = lane & 15, l_hi = lane >> 4;

    int stage = 0, lp = 0;
    uint32_t parity = 0;
    for (int step = 0, lc = 0; step < steps; ++step) {
      mbar_wait(full0 + 8 * stage, parity);
      const uint32_t a_base = base + stage * stage_bytes;
      const uint32_t b_base = a_base + a_bytes;
      uint32_t ok[kMT][2];  // this (kd, kh)'s bits (its three kw bits) of each owned row
#pragma unroll
      for (int t = 0; t < kMT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) ok[t][h] = mask[t][h] >> (kKwInN ? lp : 3 * lp);
      // the stage's k8 steps: 3 kw taps x KT (KT where kKwInN)
      auto consume = [&](auto kt) {
        constexpr int KT = decltype(kt)::value;
        constexpr int kTaps = kKwInN ? 1 : 3;
        // three sets of A fragments (two k-steps' wgmmas read theirs while
        // the third is loaded): [set][tile][part: big, small, cross][register]
        unsigned fa[3][kMT][3][4];
#pragma unroll
        for (int kw = 0; kw < kTaps; ++kw) {
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            const int gi = kw * KT + kk, set = gi % 3;
            if (gi >= 3) wgmma_wait<2>();  // the wgmmas of k-step gi - 3 have read this set
            // this lane's channels: regs 0, 1 hold ch, regs 2, 3 hold ch + 4
            const int ch = lc * TK + kk * 8 + t4;
#pragma unroll
            for (int t = 0; t < kMT; ++t) {
              const int slot = row_wg + t * 64 + l_row + kw;
              const uint32_t addr =
                  flat ? a_base + (slot * Ci + lc * TK + kk * 8 + l_hi * 4) * 4
                       : a_base + slot * (TK * 4) +
                             (static_cast<uint32_t>((kk * 2 + l_hi) ^ (slot & 7)) << 4);
              unsigned raw[4];  // regs 0, 2: row g; regs 1, 3: row g + 8
              asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                           : "=r"(raw[0]), "=r"(raw[1]), "=r"(raw[2]), "=r"(raw[3])
                           : "r"(addr));
              const bool r0 = (ok[t][0] >> kw) & 1u, r1 = (ok[t][1] >> kw) & 1u;
              if (!r0 || ch >= Ci) raw[0] = 0u;  // row g
              if (!r1 || ch >= Ci) raw[1] = 0u;  // row g + 8
              if (!r0 || ch + 4 >= Ci) raw[2] = 0u;
              if (!r1 || ch + 4 >= Ci) raw[3] = 0u;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                split_tf32(__uint_as_float(raw[e]), fa[set][t][0][e], fa[set][t][1][e],
                           fa[set][t][2][e]);
            }
            wgmma_fence();
            // the k8 slice of a K-major swizzled tile starts 32 bytes further;
            // tiles [kw][part] of kN rows, or [part] of 3 kN where kKwInN
            const uint32_t bt = b_base + kw * 3 * kBTile + kk * 32;
#pragma unroll
            for (int t = 0; t < kMT; ++t) {
              wgmma_tf32_rs<kNA>(acc[t], fa[set][t][1], smem_desc(bt + 2 * kBTile));  // s*c'
              wgmma_tf32_rs<kNA>(acc[t], fa[set][t][2], smem_desc(bt + kBTile));      // c*s'
              wgmma_tf32_rs<kNA>(acc[t], fa[set][t][0], smem_desc(bt));               // b*b'
            }
            wgmma_commit();
          }
        }
      };
      // every chunk but the last holds 32 channels; the last one kKT k8 steps
      if (lc == chunks - 1)
        consume(KSteps<kKT>{});
      else
        consume(KSteps<TK / 8>{});
      wgmma_wait<0>();  // the stage's weight tiles have been read
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == n_stages) {
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
      for (int i = 0; i < kNA / 2; ++i) asm volatile("" : "+f"(acc[t][i])::"memory");

    // accumulator layout: registers 4j .. 4j+3 are columns 8j + 2 t4, + 1 of
    // row g (first two) and row g + 8 (last two)
    if constexpr (kKwInN) {
      // Z into shared memory (the ring is free once both warpgroups are
      // past it), then output j of the block sums Z[j + kw, kw] over the
      // kw that stay in its row
      constexpr int kLdz = kNA + 4;  // floats a Z row: 16-byte rows, spread banks
      float* zs = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
      consumer_sync();
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        const int row = row_wg + t * 64 + g;
#pragma unroll
        for (int j = 0; j < kNA / 8; ++j) {
          float* z = zs + row * kLdz + 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(z) = make_float2(acc[t][4 * j], acc[t][4 * j + 1]);
          *reinterpret_cast<float2*>(z + 8 * kLdz) =
              make_float2(acc[t][4 * j + 2], acc[t][4 * j + 3]);
        }
      }
      consumer_sync();
      const unsigned m = m0 + tid;
      if (tid < kOut && m < n_vox) {
        const int w = static_cast<int>(m % static_cast<unsigned>(W));
        const float* z = zs + tid * kLdz;
        for (int c4 = 0; c4 < Co; c4 += 4) {
          float4 o = *reinterpret_cast<const float4*>(z + kLdz + kN + c4);  // kw = 1
          if (w > 0) {                                                       // kw = 0
            const float4 a = *reinterpret_cast<const float4*>(z + c4);
            o.x += a.x, o.y += a.y, o.z += a.z, o.w += a.w;
          }
          if (w < W - 1) {                                                   // kw = 2
            const float4 a = *reinterpret_cast<const float4*>(z + 2 * kLdz + 2 * kN + c4);
            o.x += a.x, o.y += a.y, o.z += a.z, o.w += a.w;
          }
          *reinterpret_cast<float4*>(y + static_cast<long long>(m) * Co + c4) = o;
        }
      }
    } else {
      // columns past Co are not stored (Co % 4 == 0: a pair is in or out)
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        const unsigned m = m0 + row_wg + t * 64 + g;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          if (8 * j + 2 * t4 >= Co) continue;
          float* yr = y + static_cast<long long>(m) * Co + 8 * j + 2 * t4;
          if (m < n_vox)
            *reinterpret_cast<float2*>(yr) = make_float2(acc[t][4 * j], acc[t][4 * j + 1]);
          if (m + 8 < n_vox)
            *reinterpret_cast<float2*>(yr + 8LL * Co) =
                make_float2(acc[t][4 * j + 2], acc[t][4 * j + 3]);
        }
      }
    }
  }
}

// fp32, Ci and Co multiples of 4 up to 64, 16-byte aligned tensors, the
// operands tf32x3_eligible() leaves.
inline bool narrow_tf32x3_eligible(const void* x, const void* w, const void* y, int Ci, int Co,
                                   int dtype) {
  const uintptr_t mask = 15;
  return dtype == kFloat32 && Ci % 4 == 0 && Co % 4 == 0 && Ci > 0 && Co > 0 && Ci <= 64 &&
         Co <= 64 && !tf32x3_eligible(x, w, y, Ci, Co, dtype) &&
         ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
           reinterpret_cast<uintptr_t>(y)) & mask) == 0;
}

// N of the one column block: Co rounded up to 16, 24, 32, 48 or 64
inline int narrow_tf32x3_n(int Co) {
  return Co <= 16 ? 16 : Co <= 24 ? 24 : Co <= 32 ? 32 : Co <= 48 ? 48 : 64;
}

// floats of the split weights in stage order (the scratch the launch fills)
inline long long narrow_tf32x3_scratch(int Ci, int Co) {
  return 81LL * ((Ci + TK - 1) / TK) * narrow_tf32x3_n(Co) * TK;
}

template <int kN, int kKT, bool kKwInN>
inline int launch_narrow_tf32x3_k(const CUtensorMap& xmap, const void* x, const float* ws, void* y,
                                  int B, int D, int H, int W, int Ci, int Co, cudaStream_t s) {
  auto kernel = conv3d_narrow_tf32x3_kernel<kN, kKT, kKwInN>;
  // a stage: the line, then the weights. The line flat where Ci % 8 == 4
  // and 3 such stages fit (258 voxels x Ci, and the 16 bytes a k8 step past
  // Ci reads), else as 2 boxes of 136 rows x 128 bytes
  const int room = kSmemMax - 1024 - 16 * kNarrowTfMaxStages;
  const int w_bytes = 9 * kN * TK * 4;
  const int flat_bytes = ((kNarrowTfRows + 2) * Ci * 4 + 16 + 1023) / 1024 * 1024;
  const int flat = Ci % 8 != 0 && room / (flat_bytes + w_bytes) >= 3;
  const int a_bytes = flat ? flat_bytes : 2 * kBoxRows * TK * 4;
  const int stage_bytes = a_bytes + w_bytes;
  const int n_stages = room / stage_bytes < kNarrowTfMaxStages ? room / stage_bytes
                                                               : kNarrowTfMaxStages;
  // the kKwInN epilogue's Z (256 rows of 3 kN + 4 floats) reuses the ring
  if (n_stages < 2 || (kKwInN && n_stages * stage_bytes < kNarrowTfRows * (3 * kN + 4) * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + n_stages * stage_bytes + 16 * n_stages;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  const int out = kKwInN ? kNarrowTfRows - 2 : kNarrowTfRows;  // outputs a block
  const dim3 grid((n_vox + out - 1) / out);
  kernel<<<grid, 384, smem, s>>>(xmap, static_cast<const float*>(x), ws, static_cast<float*>(y),
                                 B, D, H, W, Ci, Co, flat, a_bytes, n_stages);
  return static_cast<int>(cudaGetLastError());
}

template <int kN, bool kKwInN = false>
inline int launch_narrow_tf32x3_n(const CUtensorMap& xmap, const void* x, const float* ws, void* y,
                                  int B, int D, int H, int W, int Ci, int Co, int kkt,
                                  cudaStream_t s) {
  if (kkt == 2)
    return launch_narrow_tf32x3_k<kN, 2, kKwInN>(xmap, x, ws, y, B, D, H, W, Ci, Co, s);
  if (kkt == 3)
    return launch_narrow_tf32x3_k<kN, 3, kKwInN>(xmap, x, ws, y, B, D, H, W, Ci, Co, s);
  return launch_narrow_tf32x3_k<kN, 4, kKwInN>(xmap, x, ws, y, B, D, H, W, Ci, Co, s);
}

// x (B,D,H,W,Ci), w (3,3,3,Ci,Co), y (B,D,H,W,Co) fp32, on operands
// narrow_tf32x3_eligible() takes; scratch: narrow_tf32x3_scratch(Ci, Co)
// floats, 16-byte aligned. The kw taps in N where Co <= 16; the last
// chunk's k8 steps cover its channels (at least 2: Ci = 4, 8, 36 and 40, on
// no model path, run a step of zeros). The tensor map is encoded per call;
// nothing is cached. Returns cudaGetLastError() after the launches.
inline int launch_conv3d_narrow_tf32x3(const void* x, const void* w, void* y, void* scratch, int B,
                                       int D, int H, int W, int Ci, int Co, cudaStream_t s) {
  if (scratch == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kn = narrow_tf32x3_n(Co), chunks = (Ci + TK - 1) / TK;
  const int last = Ci - (chunks - 1) * TK;  // channels of the last 32-channel chunk
  const int kkt = (last + 7) / 8 < 2 ? 2 : (last + 7) / 8;
  const int kw_in_n = kn <= 32;
  float* ws = static_cast<float*>(scratch);
  const long long n_w = narrow_tf32x3_scratch(Ci, Co);
  const int split_blocks = static_cast<int>(n_w / 256 + 1 < 1024 ? n_w / 256 + 1 : 1024);
  narrow_tf32x3_split_weights<<<split_blocks, 256, 0, s>>>(static_cast<const float*>(w), ws, Ci,
                                                           Co, kn, chunks, kw_in_n);
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  CUtensorMap xmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(Ci), n_vox};
  const cuuint64_t xstr[1] = {static_cast<cuuint64_t>(Ci) * 4};
  const cuuint32_t xbox[2] = {TK, kBoxRows};
  if (!encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 2, xdims, xstr, xbox,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kn) {
    case 16: return launch_narrow_tf32x3_n<16, true>(xmap, x, ws, y, B, D, H, W, Ci, Co, kkt, s);
    case 24: return launch_narrow_tf32x3_n<24, true>(xmap, x, ws, y, B, D, H, W, Ci, Co, kkt, s);
    case 32: return launch_narrow_tf32x3_n<32, true>(xmap, x, ws, y, B, D, H, W, Ci, Co, kkt, s);
    case 48: return launch_narrow_tf32x3_n<48>(xmap, x, ws, y, B, D, H, W, Ci, Co, kkt, s);
    default: return launch_narrow_tf32x3_n<64>(xmap, x, ws, y, B, D, H, W, Ci, Co, kkt, s);
  }
}

}  // namespace sivae
