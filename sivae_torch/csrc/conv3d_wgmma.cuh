// The Hopper body of the 3x3x3 SAME stride-1 convolution: bf16, Ci % 64 == 0,
// Co % 64 == 0, 16-byte aligned tensors, sm_90a only (wgmma, TMA, mbarrier,
// setmaxnreg). Same implicit GEMM and numerics as the mma.sync body of
// conv3d_body.cuh (M = B*D*H*W voxels, N = Co, K = 27*Ci, all taps summed in
// fp32, one rounding); what changes is how the operands reach the tensor cores.
// conv3d.cu runs it plain; conv3d_fused.cu with its prologue and plane sums
// (the kernel's template parts, below).
//
// What bounded the mma.sync body on this card, and what this one does:
// - Shared-memory bandwidth: 8 warps each re-read the weight tile with
//   ldmatrix (256 B/clk asked of a 128 B/clk SM). Here the product is
//   wgmma.mma_async m64n64k16: the weight tile (B) is read from shared memory
//   once per warpgroup, through a descriptor, in the 128-byte swizzle the TMA
//   wrote it in (MN-major: the DHWIO weight keeps Co contiguous). A comes from
//   registers (the RS form), loaded with ldmatrix from the line buffer.
// - L2 -> shared bytes: a block of 256 output voxels (kMT = 2) reads the
//   weights once for twice the voxels of the old 128-row tile, and a block of
//   128 output channels (kNT = 2, where Co % 128 == 0) reads the input once
//   for twice the channels, its A fragments serving both column tiles.
// - Address arithmetic and block-wide barriers: one producer thread starts
//   TMA copies into a ring of stages; two consumer warpgroups wait on each
//   stage's "full" mbarrier and release it through its "empty" mbarrier. No
//   __syncthreads in the K loop.
//
// The line buffer without bounds checks. For a fixed (kd, kh) the three kw
// taps of output rows m0 .. m0 + M - 1 read the M + 2 consecutive rows of the
// flat (n_vox, Ci) input that start at m0 - 1 + (kd - 1) * H * W + (kh - 1) * W:
// one 2-D TMA box per 136 rows (rows outside the tensor arrive as zeros).
// Flat-index neighbours are the true neighbours exactly when the tap lies
// inside the volume, so each thread keeps a 27-bit mask per A-fragment row it
// owns (bit t: tap t of that output voxel is inside) and zeroes the
// fragment registers of a tap outside it: the SAME padding, d, h and w edges
// and the ragged last tile alike, costs a few selects per ldmatrix.
//
// A stage holds one (kd, kh) line buffer of 64 channels (136 * kMT rows of
// 128 B, swizzled) and the 3 kw weight tiles (64 x 64 kNT each): 41 KB
// (128 x 64 blocks, 5 stages) to 82 KB (256 x 128 blocks, 2 stages);
// wgmma_block_shape() picks the block shape per call. The epilogue rounds once, stages
// each warp's 16 x 64 tile in its own piece of shared memory and stores 16
// bytes per lane.

#pragma once

#include "common.cuh"
#include "conv3d_body.cuh"
#include "ptx.cuh"

namespace sivae {

constexpr int GK = 64;         // channels per stage: one 128-byte swizzled row
constexpr int GN = 64;         // output channels per block
constexpr int kBoxRows = 136;  // rows per input TMA box (>= 128 + 2, a multiple of 8)
constexpr int kBTile = GK * GN * 2;           // bytes of one tap's weight tile
constexpr int kEpiRow = GN * 2 + 16;          // staged output row, padded against bank conflicts
constexpr int kEpiWarp = 16 * kEpiRow;        // one warp's 16 x 64 staged tile
constexpr int kConsumerWarps = 8;

constexpr int kSmemMax = 232448;  // shared memory one block may use

// kMT m64 tiles per consumer warpgroup (block rows = 128 * kMT), kNT 64-wide
// column tiles per block
template <int kMT, int kNT>
struct WgmmaCfg {
  static constexpr int kM = 128 * kMT;                        // output voxels per block
  static constexpr int kN = GN * kNT;                         // output channels per block
  static constexpr int kABytes = kMT * kBoxRows * GK * 2;     // line buffer
  static constexpr int kStage = kABytes + 3 * kNT * kBTile;
  static constexpr int kFixed = kConsumerWarps * kEpiWarp + 128 + 1024;  // epilogue, barriers, slack
  static constexpr int kFit = (kSmemMax - kFixed) / kStage;
  static constexpr int kStages = kFit > 5 ? 5 : kFit;
  static constexpr int kEpiOff = kStages * kStage;
  static constexpr int kBarOff = kEpiOff + kConsumerWarps * kEpiWarp;
  static constexpr int kSmem = kStages * kStage + kFixed;  // with room to align the base
  static constexpr int kSlots = kM / 16;  // warp tiles of 16 rows: the plane sums' slots
  static constexpr int kRewritePasses = (kM + 2 + 31) / 32;  // line-buffer rows / 32
  static_assert(kStage % 1024 == 0 && kABytes % 1024 == 0, "swizzle atoms are 1024 B");
  static_assert(kStages >= 2 && 2 * kStages * 8 <= 128, "ring depth");
  static_assert(kSlots * (2 * kN + 1) * 4 <= kStages * kStage, "the slots fit in the ring");
};

// 27-bit mask of the taps of output voxel m that lie inside the volume
// (0 for the padding rows of the last tile)
__device__ __forceinline__ uint32_t tap_mask(unsigned m, unsigned n_vox, int D, int H, int W) {
  const Vox v = decode_vox(m, n_vox, D, H, W);
  if (!v.in) return 0u;
  const uint32_t okw = (v.w > 0 ? 1u : 0u) | 2u | (v.w < W - 1 ? 4u : 0u);      // kw = 0, 1, 2
  const uint32_t okh = (v.h > 0 ? okw : 0u) | (okw << 3) | (v.h < H - 1 ? okw << 6 : 0u);
  return (v.d > 0 ? okh : 0u) | (okh << 9) | (v.d < D - 1 ? okh << 18 : 0u);
}

// g (prologue_act, rounded once) on the two bf16 of a packed pair, channels
// with scales a0, a1 and shifts b0, b1
__device__ __forceinline__ unsigned prologue_bf16x2(unsigned v, float a0, float a1, float b0,
                                                    float b1, float slope) {
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(prologue_act(__uint_as_float(v << 16), a0, b0, slope),
                            prologue_act(__uint_as_float(v & 0xffff0000u), a1, b1, slope));
  return *reinterpret_cast<const unsigned*>(&r);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the 256 consumer threads only (the producer warpgroup has left)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// --- the kernel --------------------------------------------------------------
//
// 384 threads: warpgroups 0 and 1 consume (each kMT m64 tiles of the block's
// rows), warpgroup 2 produces (one thread; the rest leave). xmap: the input as
// (n_vox, Ci) bf16, box 136 x 64, 128-byte swizzle. wmap: the weight as
// (27 * Ci, Co), box 64 x 64, 128-byte swizzle.
//
// The fused form's two optional parts (conv3d_body.cuh says what they
// compute; kernel 1 runs with neither):
// - kPrologue, the input prologue g: the consumers apply it once per stage to
//   the next stage's line buffer in shared memory, a third of its rows after
//   each kw group's wgmmas are issued, so that it runs while they do; a named
//   barrier among the consumers orders it before the next stage's ldmatrix.
//   The tap masks then zero every out-of-volume tap, the rows TMA filled with
//   zeros (g(0) != 0) included.
// - kStats: plane sums of the rounded output, from each warp's staged 16-row
//   tile (the rounded values the epilogue stores), each lane summing two
//   columns over the rows. A tile in one plane goes to its own slot (shared
//   memory, the drained ring); the block then adds the slots of each plane
//   and issues one atomicAdd per (plane, column, sum). A tile that straddles
//   planes adds each plane's part to psum / psumsq directly.
template <int kMT, int kNT, bool kPrologue, bool kStats>
__global__ void __launch_bounds__(384, 1)
conv3d_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ y, int B,
                    int D, int H, int W, int Ci, int Co, Fusion f) {
  using Cfg = WgmmaCfg<kMT, kNT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + Cfg::kBarOff, empty0 = full0 + Cfg::kStages * 8;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  const unsigned m0 = blockIdx.x * Cfg::kM;
  const int n0 = blockIdx.y * Cfg::kN;
  const int chunks = Ci / GK;
  const int steps = 9 * chunks;

  if (tid == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's arrive + the copies' bytes
      mbar_init(empty0 + 8 * s, kConsumerWarps);   // one arrive per consumer warp
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
            tma_load_2d(a + q * kBoxRows * GK * 2, &xmap, full, c * GK, row0 + q * kBoxRows);
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
              tma_load_2d(a + Cfg::kABytes + (kw * kNT + nt) * kBTile, &wmap, full, n0 + nt * GN,
                          (lp * 3 + kw) * Ci + c * GK);
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

    float acc[kMT][kNT][32];
#pragma unroll
    for (int t = 0; t < kMT; ++t)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[t][nt][i] = 0.f;

    // ldmatrix row address of this lane: slot (output row + kw), 16-byte piece
    const int l_row = lane & 15, l_hi = lane >> 4;
    unsigned fa[2][kMT][GK / 16][4];  // two sets: one is read by wgmmas in flight

    // kPrologue: (a, b) of the 8 channels of this thread's 16-byte piece
    // (tid & 7) of the line buffer, for a channel chunk
    float a8[8], b8[8];
    auto load_ab = [&](int c) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a8[e] = __ldg(f.in_a + c * GK + (tid & 7) * 8 + e);
        b8[e] = __ldg(f.in_b + c * GK + (tid & 7) * 8 + e);
      }
    };
    // g on the rows of stage st's line buffer that feed this block (kM + 2):
    // this thread's piece of rows tid / 8 + 32 p, for the passes p0 <= p < p1
    auto rewrite = [&](int st, int p0, int p1) {
      const int piece = tid & 7;
      unsigned char* buf = smem + st * Cfg::kStage;
#pragma unroll 3
      for (int p = p0; p < p1; ++p) {
        const int r = (tid >> 3) + 32 * p;
        if (r >= Cfg::kM + 2) break;
        uint4* q = reinterpret_cast<uint4*>(buf + r * (GK * 2) + ((piece ^ (r & 7)) << 4));
        uint4 v = *q;
        v.x = prologue_bf16x2(v.x, a8[0], a8[1], b8[0], b8[1], f.slope);
        v.y = prologue_bf16x2(v.y, a8[2], a8[3], b8[2], b8[3], f.slope);
        v.z = prologue_bf16x2(v.z, a8[4], a8[5], b8[4], b8[5], f.slope);
        v.w = prologue_bf16x2(v.w, a8[6], a8[7], b8[6], b8[7], f.slope);
        *q = v;
      }
      // generic-proxy writes to a buffer that TMA (the async proxy) refills
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };

    int stage = 0, lp = 0, lc = 0;
    uint32_t parity = 0;
    if constexpr (kPrologue) {
      load_ab(0);
      mbar_wait(full0, 0);
      rewrite(0, 0, Cfg::kRewritePasses);
      consumer_sync();
    }
    for (int step = 0; step < steps; ++step) {
      if constexpr (!kPrologue) mbar_wait(full0 + 8 * stage, parity);  // else waited for below
      const int ns = stage + 1 == Cfg::kStages ? 0 : stage + 1;  // the next stage
      const uint32_t a_base = base + stage * Cfg::kStage;
      const uint32_t b_base = a_base + Cfg::kABytes;
      uint32_t ok[kMT][2];  // this (kd, kh)'s three kw bits of each owned row
#pragma unroll
      for (int t = 0; t < kMT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) ok[t][h] = mask[t][h] >> (3 * lp);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int set = kw & 1;
        if (kw == 2) wgmma_wait<1>();  // the wgmmas of kw = 0 have read set 0
#pragma unroll
        for (int t = 0; t < kMT; ++t) {
          const int slot = row_wg + t * 64 + l_row + kw;
          const uint32_t row_addr = a_base + slot * (GK * 2);
#pragma unroll
          for (int kk = 0; kk < GK / 16; ++kk) {
            unsigned(&fr)[4] = fa[set][t][kk];
            const uint32_t piece = static_cast<uint32_t>((kk * 2 + l_hi) ^ (slot & 7));
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                         : "=r"(fr[0]), "=r"(fr[1]), "=r"(fr[2]), "=r"(fr[3])
                         : "r"(row_addr + (piece << 4)));
            if (!((ok[t][0] >> kw) & 1u)) fr[0] = fr[2] = 0u;  // row g
            if (!((ok[t][1] >> kw) & 1u)) fr[1] = fr[3] = 0u;  // row g + 8
          }
        }
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < kMT; ++t)
#pragma unroll
          for (int kk = 0; kk < GK / 16; ++kk)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)  // the A fragments serve every column tile
              wgmma_m64n64k16_rs(
                  acc[t][nt], fa[set][t][kk],
                  smem_desc(b_base + (kw * kNT + nt) * kBTile + kk * (16 * GN * 2)));
        wgmma_commit();
        if constexpr (kPrologue) {  // a third of the next stage, while this group's wgmmas run
          if (step + 1 < steps) {
            if (kw == 0) {
              if (chunks > 1) load_ab(lc + 1 == chunks ? 0 : lc + 1);
              mbar_wait(full0 + 8 * ns, ns == 0 ? parity ^ 1u : parity);
            }
            rewrite(ns, kw * Cfg::kRewritePasses / 3, (kw + 1) * Cfg::kRewritePasses / 3);
          }
        }
      }
      wgmma_wait<0>();  // the stage's weight tiles have been read
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if constexpr (kPrologue) consumer_sync();  // the next stage is rewritten
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
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[t][nt][i])::"memory");

    // epilogue: round once, stage the warp's 16 x 64 tile, 16-byte stores.
    // accumulator layout: registers 4j .. 4j+3 are columns 8j + 2 t4, + 1 of
    // row g (first two) and row g + 8 (last two)
    unsigned char* epi = smem + Cfg::kEpiOff + (wg * 4 + wq) * kEpiWarp;

    // kStats: the slots of the warp tiles, [tile row / 16][s1, s2][kN] fp32,
    // and each slot's plane (~0 for a tile that straddles planes), in the ring
    // (every stage has been read)
    const unsigned HW = static_cast<unsigned>(H) * W;
    float* slots = reinterpret_cast<float*>(smem);
    unsigned* slot_plane = reinterpret_cast<unsigned*>(slots + Cfg::kSlots * 2 * Cfg::kN);
    if constexpr (kStats) consumer_sync();  // both warpgroups are done with the ring

#pragma unroll
    for (int t = 0; t < kMT; ++t) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          unsigned char* p = epi + g * kEpiRow + (j * 8 + 2 * t4) * 2;
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(acc[t][nt][4 * j], acc[t][nt][4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(p + 8 * kEpiRow) =
              __floats2bfloat162_rn(acc[t][nt][4 * j + 2], acc[t][nt][4 * j + 3]);
        }
        __syncwarp();
#pragma unroll
        for (int it = 0; it < 4; ++it) {
          const int row = it * 4 + (lane >> 3), piece = lane & 7;
          const unsigned m = m0 + row_wg + t * 64 + row;
          if (m < n_vox)
            *reinterpret_cast<uint4*>(y + static_cast<long long>(m) * Co + n0 + nt * GN +
                                      piece * 8) =
                *reinterpret_cast<const uint4*>(epi + row * kEpiRow + piece * 16);
        }
        __syncwarp();
        if constexpr (kStats) {  // of the staged, rounded tile: lane owns columns 2 lane, + 1
          const unsigned ma = m0 + row_wg + t * 64;  // the tile's first row
          unsigned plane = ma / HW, rem = ma - plane * HW;
          const bool whole = ma + 15 < n_vox && rem + 15 < HW;  // 16 real rows, one plane
          float s1a = 0.f, s1b = 0.f, s2a = 0.f, s2b = 0.f;
          float* sums = f.psum + n0 + nt * GN + 2 * lane;
          float* sqs = f.psumsq + n0 + nt * GN + 2 * lane;
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            if (!whole && ma + r >= n_vox) break;
            const unsigned v = *reinterpret_cast<const unsigned*>(epi + r * kEpiRow + 4 * lane);
            const float lo = __uint_as_float(v << 16), hi = __uint_as_float(v & 0xffff0000u);
            s1a += lo;
            s1b += hi;
            s2a = fmaf(lo, lo, s2a);
            s2b = fmaf(hi, hi, s2b);
            if (!whole && (++rem == HW || r == 15 || ma + r + 1 == n_vox)) {  // a plane's part ends
              const size_t at = static_cast<size_t>(plane) * Co;
              atomicAdd(sums + at, s1a);
              atomicAdd(sums + at + 1, s1b);
              atomicAdd(sqs + at, s2a);
              atomicAdd(sqs + at + 1, s2b);
              s1a = s1b = s2a = s2b = 0.f;
              if (rem == HW) {
                rem = 0;
                ++plane;
              }
            }
          }
          const int sl = (ma - m0) >> 4;
          if (whole) {
            float* slot = slots + sl * 2 * Cfg::kN + nt * GN + 2 * lane;
            *reinterpret_cast<float2*>(slot) = make_float2(s1a, s1b);
            *reinterpret_cast<float2*>(slot + Cfg::kN) = make_float2(s2a, s2b);
          }
          if (lane == 0 && nt == 0) slot_plane[sl] = whole ? plane : ~0u;
          __syncwarp();  // the next tile is staged over this one
        }
      }
    }
    if constexpr (kStats) {  // one atomicAdd per (plane, column, sum) of the block
      consumer_sync();
      if (tid < 2 * Cfg::kN) {
        const int col = tid % Cfg::kN, k = tid / Cfg::kN;
        float* sums = (k ? f.psumsq : f.psum) + n0 + col;
        unsigned plane = ~0u;
        float run = 0.f;
        for (int sl = 0; sl < Cfg::kSlots; ++sl) {  // in row order: one plane's slots are adjacent
          const unsigned p = slot_plane[sl];
          if (p == ~0u) continue;
          if (p != plane) {
            if (plane != ~0u) atomicAdd(sums + static_cast<size_t>(plane) * Co, run);
            plane = p;
            run = 0.f;
          }
          run += slots[(sl * 2 + k) * Cfg::kN + col];
        }
        if (plane != ~0u) atomicAdd(sums + static_cast<size_t>(plane) * Co, run);
      }
    }
  }
}

// --- host side ---------------------------------------------------------------

inline bool wgmma_eligible(const void* x, const void* w, const void* y, int Ci, int Co, int dtype) {
  return mma_eligible(x, w, y, Ci, Co, dtype) && Ci % GK == 0;
}

// The block shape for a call, as 10 * kMT + kNT. One block runs per SM at a
// time, so a call lasts about (rounds of blocks over the SMs) x (a block's
// work, 128 kMT x 64 kNT outputs) x (the shape's cost per output): wider
// blocks re-read less (the A fragments serve both column tiles, 256 rows
// share one pass over the weights), smaller ones fill the card at the small
// sites. The relative costs are rounded from measured ones (H100, the sites
// with many rounds of blocks at batch 8: 256 x 64 blocks are ~10% faster per
// output than 128 x 64, the 128-wide ones another 10-20%);
// tools/torch_conv_blocks.py times the four shapes at every site and marks
// the pick.
//
// The fused forms (`fused`) leave out 256 x 128: with the statistics
// epilogue that shape no longer fits the registers (ptxas spills).
inline int wgmma_block_shape(unsigned n_vox, int Co, bool fused = false) {
  const int sms = device_sms();
  const struct { int shape, mt, nt; double cost; } shapes[4] = {
      {11, 1, 1, 1.10}, {21, 2, 1, 1.00}, {12, 1, 2, 0.85}, {22, 2, 2, 0.80}};
  int best = 11;
  double best_t = -1.0;
  for (const auto& c : shapes) {
    if (Co % (GN * c.nt) != 0 || (fused && c.shape == 22)) continue;
    const long long blocks =
        (static_cast<long long>(n_vox) + 128 * c.mt - 1) / (128 * c.mt) * (Co / (GN * c.nt));
    const double t = static_cast<double>((blocks + sms - 1) / sms) * c.mt * c.nt * c.cost;
    if (best_t < 0 || t < best_t) {
      best_t = t;
      best = c.shape;
    }
  }
  return best;
}

template <int kMT, int kNT, bool kPrologue, bool kStats>
inline int launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap, void* y, int B, int D,
                        int H, int W, int Ci, int Co, unsigned n_vox, const Fusion& f,
                        cudaStream_t s) {
  using Cfg = WgmmaCfg<kMT, kNT>;
  auto kernel = conv3d_wgmma_kernel<kMT, kNT, kPrologue, kStats>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((n_vox + Cfg::kM - 1) / Cfg::kM, Co / Cfg::kN);
  kernel<<<grid, 384, Cfg::kSmem, s>>>(xmap, wmap, static_cast<__nv_bfloat16*>(y), B, D, H, W, Ci,
                                       Co, f);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma body on operands that wgmma_eligible() takes, with the optional
// parts kPrologue / kStats (the conv alone: <false, false>), in the block shape
// wgmma_block_shape() picks (shape == 0) or in a given one (for measurements;
// it must divide Co). The two tensor maps are encoded per call on the host
// (about a microsecond; nothing is cached, so nothing outlives the call).
template <bool kPrologue, bool kStats>
inline int launch_conv3d_wgmma(const void* x, const void* w, void* y, int B, int D, int H, int W,
                               int Ci, int Co, const Fusion& f, cudaStream_t s, int shape = 0) {
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(Ci), n_vox};
  const cuuint64_t xstr[1] = {static_cast<cuuint64_t>(Ci) * 2};
  const cuuint32_t xbox[2] = {GK, kBoxRows};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(Co), static_cast<cuuint64_t>(27) * Ci};
  const cuuint64_t wstr[1] = {static_cast<cuuint64_t>(Co) * 2};
  const cuuint32_t wbox[2] = {GN, GK};
  if (!encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, xdims, xstr, xbox,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, wdims, wstr, wbox,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (shape == 0) shape = wgmma_block_shape(n_vox, Co, kStats);
  if (Co % (GN * (shape % 10)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (shape) {
    case 21:
      return launch_wgmma<2, 1, kPrologue, kStats>(xmap, wmap, y, B, D, H, W, Ci, Co, n_vox, f, s);
    case 12:
      return launch_wgmma<1, 2, kPrologue, kStats>(xmap, wmap, y, B, D, H, W, Ci, Co, n_vox, f, s);
    case 22:
      return launch_wgmma<2, 2, kPrologue, kStats>(xmap, wmap, y, B, D, H, W, Ci, Co, n_vox, f, s);
    default:
      return launch_wgmma<1, 1, kPrologue, kStats>(xmap, wmap, y, B, D, H, W, Ci, Co, n_vox, f, s);
  }
}

}  // namespace sivae
