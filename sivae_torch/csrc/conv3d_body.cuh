// The implicit-GEMM bodies of the 3x3x3 SAME stride-1 convolution
// (NDHWC x DHWIO -> NDHWC, for sm_90a), shared by conv3d.cu (the plain
// conv) and conv3d_fused.cu (the conv with an input prologue and per-plane
// output statistics). M = B*D*H*W output voxels, N = Co, K = 27*Ci
// (tap-major, channel-minor, the DHWIO weight order). Every tap's input row
// is gathered with a bounds check (SAME padding without a padded copy), all
// 27 taps accumulate in fp32 and the result is rounded once to the output
// type.
//
// Two bodies, each a template over the two optional parts:
// - conv3d_mma_kernel: bf16 with Ci % 32 == 0 and Co % 64 == 0. A 128x64
//   output tile per block, 8 warps of 32x32, mma.sync m16n8k16 on ldmatrix
//   fragments with fp32 accumulators; per K-step one line buffer of input
//   rows serves the 3 kw taps of a (kd, kh) (details above the kernel).
// - conv3d_fma_kernel: every other case of the fused kernel (its fp32
//   among them), and of the conv what the wgmma, narrow and tf32x3 bodies
//   do not take either (fp32 with Ci or Co not a multiple of 32;
//   bf16 channel counts not a multiple of 4, above 64, or misaligned). A
//   64x64 tile per block, 4x4 outputs per thread, fp32 FMA on CUDA cores.
//   What bounds it at narrow channels: a 64-column tile whatever Co is,
//   16-channel chunks and every tap's rows gathered again by scalar loads
//   (12->12 at 80x96x80, batch 8: 8.9 ms on an H100 80GB HBM3 at 700 W,
//   against 0.070 ms of bytes); the "narrow" body (conv3d_narrow.cuh) took
//   those shapes over. In fp32 at 64 channels the CUDA cores' 67 TF/s hold
//   it (64->64 at 80x96x80, batch 2: 11.1 ms, cuDNN 6.7 ms); the "tf32x3"
//   body (conv3d_tf32x3.cuh) took those shapes over.
//
// kPrologue: the input passes through g(x) = leaky_relu(x * a[c] + b[c]) in
// fp32, rounded once to the conv type, before it is multiplied. The padding
// comes AFTER g: an out-of-bounds tap contributes 0, not g(0).
// kStats: per-(b, d) plane sums of the ROUNDED output and of its square, in
// fp32, added with atomicAdd into buffers the caller has zeroed. A tile of
// consecutive voxels may lie in one plane or straddle several; each thread
// walks its rows of one column and flushes its running sums whenever the
// plane changes. The order of the atomic additions changes from run to run,
// so the sums agree with a fixed-order fp32 sum to ~1e-6 relative.

#pragma once

#include <stdint.h>

#include "common.cuh"
#include "ptx.cuh"

namespace sivae {

// The optional parts' operands (unused members are null).
struct Fusion {
  const float* in_a;  // (Ci) prologue scale
  const float* in_b;  // (Ci) prologue shift
  float slope;        // prologue LeakyReLU slope
  float* psum;        // (B * D, Co) sums of the rounded output, zeroed by the caller
  float* psumsq;      // (B * D, Co) sums of its square
};

__device__ __forceinline__ float prologue_act(float x, float a, float b, float slope) {
  const float v = __fadd_rn(__fmul_rn(x, a), b);  // no FMA contraction: as the plain version
  return v >= 0.f ? v : slope * v;
}

// Plane sums of one output tile staged as fp32 in shared memory:
// Cs[row * ldc + col] is voxel m0 + row, channel n0 + col. 256 threads;
// thread (col, group) walks kRows / (256 / kCols) consecutive rows.
template <typename T, int kRows, int kCols>
__device__ __forceinline__ void tile_stats(const float* Cs, int ldc, unsigned m0, unsigned n_vox,
                                           unsigned HW, int n0, int Co, const Fusion& f) {
  constexpr int kGroups = 256 / kCols;
  constexpr int kPer = kRows / kGroups;
  const int col = threadIdx.x % kCols, grp = threadIdx.x / kCols;
  const int n = n0 + col;
  unsigned m = m0 + grp * kPer;
  if (n >= Co || m >= n_vox) return;
  unsigned plane = m / HW, rem = m - plane * HW;
  float s1 = 0.f, s2 = 0.f;
  for (int r = 0; r < kPer && m < n_vox; ++r, ++m) {
    const float v = to_f(from_f<T>(Cs[(grp * kPer + r) * ldc + col]));  // the stored value
    s1 += v;
    s2 = fmaf(v, v, s2);
    if (++rem == HW) {  // last voxel of its plane
      atomicAdd(f.psum + static_cast<size_t>(plane) * Co + n, s1);
      atomicAdd(f.psumsq + static_cast<size_t>(plane) * Co + n, s2);
      s1 = s2 = 0.f;
      rem = 0;
      ++plane;
    }
  }
  if (rem != 0) {  // rows since the last plane boundary
    atomicAdd(f.psum + static_cast<size_t>(plane) * Co + n, s1);
    atomicAdd(f.psumsq + static_cast<size_t>(plane) * Co + n, s2);
  }
}

// ---------------------------------------------------------------------------
// FMA body (any dtype, any Ci / Co)
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;

template <typename T, bool kPrologue, bool kStats>
__global__ void __launch_bounds__(256)
conv3d_fma_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                  int B, int D, int H, int W, int Ci, int Co, Fusion f) {
  __shared__ __align__(16) float As[FK][FM + 4];  // transposed: [k][m]
  __shared__ __align__(16) float Bs[FK][FN + 4];  // [k][n]
  __shared__ float Cs[kStats ? FM : 1][FN + 1];   // the output tile, for the plane sums
  const int tid = threadIdx.x;
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  const unsigned m0 = blockIdx.x * FM;
  const int n0 = blockIdx.y * FN;

  // loader roles: A row (one voxel) x 4 channels, B row (one channel) x 4 outputs
  const int a_row = tid >> 2, a_k = (tid & 3) * 4;
  const Vox vox = decode_vox(m0 + a_row, n_vox, D, H, W);
  const int b_k = tid >> 4, b_n = (tid & 15) * 4;
  // compute role: 4 rows x 4 columns of the 64x64 tile
  const int ty = tid >> 4, tx = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < 27; ++t) {
    const int src = tap_voxel(vox, t / 9, (t / 3) % 3, t % 3, D, H, W);
    const T* xr = x + (src < 0 ? 0 : static_cast<long long>(src) * Ci);
    const T* wt = w + static_cast<long long>(t) * Ci * Co;
    for (int c0 = 0; c0 < Ci; c0 += FK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + a_k + j;
        float v = 0.f;  // the padding, after the prologue
        if (src >= 0 && c < Ci) {
          v = to_f(xr[c]);
          if constexpr (kPrologue)
            v = to_f(from_f<T>(prologue_act(v, f.in_a[c], f.in_b[c], f.slope)));
        }
        As[a_k + j][a_row] = v;
      }
      const int cb = c0 + b_k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + b_n + j;
        Bs[b_k][b_n + j] =
            (cb < Ci && n < Co) ? to_f(wt[static_cast<long long>(cb) * Co + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < n_vox && n < Co) y[static_cast<long long>(m) * Co + n] = from_f<T>(acc[i][j]);
      if constexpr (kStats) Cs[ty * 4 + i][tx * 4 + j] = acc[i][j];
    }
  }
  if constexpr (kStats) {
    __syncthreads();
    tile_stats<T, FM, FN>(&Cs[0][0], FN + 1, m0, n_vox, static_cast<unsigned>(H) * W, n0, Co, f);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core body (bf16, Ci % 32 == 0, Co % 64 == 0, 16-byte aligned tensors)
// ---------------------------------------------------------------------------
//
// A block computes WM = 128 consecutive output voxels x WN = 64 output
// channels. For a fixed (kd, kh) the 3 kw taps of those rows read 130
// consecutive input voxels (the rows shifted by -1, 0, +1), so each K-step
// loads one "line buffer" of WM + 2 input rows for one (kd, kh) and a
// 32-channel chunk, and the 3 taps read it at row offsets 0, 1, 2. Slot s of
// the buffer holds input (b, d + kd - 1, h + kh - 1, w) of output row
// m0 + s - 1, or zeros where that is outside the volume (SAME padding, by
// cp.async zero-fill). A row whose kw neighbour crosses a w edge would read
// the next or previous line there, so the kw = 0 / kw = 2 A fragments of
// rows at w = 0 / w = W - 1 are zeroed in registers. Fragments are loaded
// with ldmatrix (.trans for the [k][n] weight tile) and multiplied with
// mma.sync m16n8k16 into fp32 accumulators; a 3-deep cp.async ring keeps
// the next two K-steps' copies in flight.
//
// With kPrologue, cp.async cannot transform what it copies, so each thread
// applies g in shared memory to the 16-byte pieces it copied itself, once
// they have arrived (its own wait_group suffices) and before the block's
// barrier; zero-filled pieces are left alone, which keeps the padding 0.

constexpr int WM = 128, WN = 64, WK = 32;
constexpr int kRows = WM + 2;  // line buffer rows
constexpr int kStages = 3;
constexpr int LDA = WK + 8;    // bf16 per buffer row (80 B: 16-byte aligned, no bank conflicts)
constexpr int LDB = WN + 8;    // bf16 per weight row
constexpr int LDC = WN + 4;    // fp32 per staged output row
constexpr int kAElems = kRows * LDA;
constexpr int kStageElems = kAElems + 3 * WK * LDB;  // line buffer + weights of 3 taps
constexpr int kSmemAB = kStages * kStageElems * 2;
constexpr int kSmemC = WM * LDC * 4;
constexpr int kSmemW = kSmemC > kSmemAB ? kSmemC : kSmemAB;  // > 48 KB: dynamic, opt-in
constexpr int kACopies = kRows * (WK / 8);  // 16-byte copies per line buffer
static_assert(kACopies <= 3 * 256 && (kAElems * 2) % 16 == 0, "loader layout");

// kMinBlocks blocks of 72.7 KB per SM: 3 (<= 85 registers) for the plain
// conv, 2 for the fused forms, whose extra state would spill under 85.
template <bool kPrologue, bool kStats, int kMinBlocks>
__global__ void __launch_bounds__(256, kMinBlocks)
conv3d_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, int B, int D, int H, int W, int Ci, int Co,
                  Fusion f) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // kStages x {A, B[3]}
  float* Cs = reinterpret_cast<float*>(smem);                    // [WM][LDC], after the loop

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps, 32 x 32 each
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  const unsigned m0 = blockIdx.x * WM;
  const int n0 = blockIdx.y * WN;

  // line-buffer loader: copies tid, tid + 256, tid + 512 (slot = copy / 4);
  // each slot's output row is decoded once
  Vox av[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int slot = (tid + 256 * r) >> 2;
    av[r] = decode_vox(m0 + slot - 1, n_vox, D, H, W);  // m0 - 1 wraps: not in
  }
  const int a_part = (tid & 3) * 8;
  // weight loader: 8 outputs of one channel row for each of the 3 taps
  const int b_k = tid >> 3, b_n = (tid & 7) * 8;
  // is input row r of line (kd, kh) inside the volume?
  auto row_ok = [&](int r, int kd, int kh, int& dd, int& hh) {
    const Vox& v = av[r];
    dd = v.d + kd - 1;
    hh = v.h + kh - 1;
    return v.in && dd >= 0 && dd < D && hh >= 0 && hh < H;
  };
  // K walks 9 (kd, kh) lines x Ci/WK channel chunks; (lp, lc) is the next to load
  const int steps = 9 * (Ci / WK);
  int lp = 0, lc = 0;
  auto load_step = [&](int stage) {
    __nv_bfloat16* As = ring + stage * kStageElems;
    __nv_bfloat16* Bs = As + kAElems;
    const int kd = lp / 3, kh = lp % 3;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int copy = tid + 256 * r;
      if (copy >= kACopies) break;
      int dd, hh;
      const bool ok = row_ok(r, kd, kh, dd, hh);
      const Vox& v = av[r];
      const __nv_bfloat16* src =
          ok ? x + (((static_cast<long long>(v.b) * D + dd) * H + hh) * W + v.w) * Ci + lc + a_part
             : x;
      cp_async16(As + (copy >> 2) * LDA + a_part, src, ok);
    }
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
      cp_async16(Bs + (kw * WK + b_k) * LDB + b_n,
                 w + (static_cast<long long>(lp * 3 + kw) * Ci + lc + b_k) * Co + n0 + b_n, true);
    lc += WK;
    if (lc == Ci) {
      lc = 0;
      ++lp;
    }
  };
  // the prologue on this thread's own pieces of the line buffer of the step
  // being computed, (tp, tc); pieces that were zero-filled stay zero
  int tp = 0, tc = 0;
  auto transform = [&](int stage) {
    __nv_bfloat16* As = ring + stage * kStageElems;
    const int kd = tp / 3, kh = tp % 3;
    float a8[8], b8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a8[j] = __ldg(f.in_a + tc + a_part + j);
      b8[j] = __ldg(f.in_b + tc + a_part + j);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int copy = tid + 256 * r;
      if (copy >= kACopies) break;
      int dd, hh;
      if (!row_ok(r, kd, kh, dd, hh)) continue;
      __nv_bfloat16* p = As + (copy >> 2) * LDA + a_part;
      float v8[8];
      Vec16<__nv_bfloat16>::load(p, v8);
#pragma unroll
      for (int j = 0; j < 8; ++j) v8[j] = prologue_act(v8[j], a8[j], b8[j], f.slope);
      Vec16<__nv_bfloat16>::store(p, v8);  // one rounding to the conv type
    }
    tc += WK;
    if (tc == Ci) {
      tc = 0;
      ++tp;
    }
  };

  // warp tile 32 x 32 = 2 (m16) x 4 (n8) mma tiles of 4 fp32 per thread
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int l_row = lane & 15, l_col = (lane >> 4) * 8;  // this lane's ldmatrix row address
  // the A-fragment rows this thread holds (g and g + 8 of each m16 tile) at a w edge
  const int g = lane >> 2, t4 = lane & 3;
  bool w_first[2][2], w_last[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int wq = static_cast<int>((m0 + wm * 32 + i * 16 + g + 8 * h) % W);
      w_first[i][h] = wq == 0;
      w_last[i][h] = wq == W - 1;
    }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this step's copies have landed (own thread)
    if constexpr (kPrologue) transform(step % kStages);
    __syncthreads();               // ... for every thread; the previous stage is free
    const int next = step + kStages - 1;
    if (next < steps) load_step(next % kStages);
    cp_async_commit();
    const __nv_bfloat16* As = ring + (step % kStages) * kStageElems;
    const __nv_bfloat16* Bs = As + kAElems;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
      for (int kk = 0; kk < WK; kk += 16) {
        unsigned fa[2][4], fb[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ldsm_x4(fa[i], As + (wm * 32 + i * 16 + l_row + kw) * LDA + kk + l_col);
          if (kw != 1) {  // regs 0, 2: row g; regs 1, 3: row g + 8
            if (kw == 0 ? w_first[i][0] : w_last[i][0]) fa[i][0] = fa[i][2] = 0u;
            if (kw == 0 ? w_first[i][1] : w_last[i][1]) fa[i][1] = fa[i][3] = 0u;
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)  // n16 pair j: n8 tiles 2j ({r0, r1}) and 2j+1 ({r2, r3})
          ldsm_x4_trans(fb[j], Bs + (kw * WK + kk + l_row) * LDB + wn * 32 + j * 16 + l_col);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], fa[i], fb[j >> 1][(j & 1) * 2], fb[j >> 1][(j & 1) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is reused for the output tile

  // stage the fp32 tile through shared memory, round once, 16-byte stores
  // accumulator layout: e = 0,1 -> row g, columns 2t, 2t+1; e = 2,3 -> row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* c = Cs + (wm * 32 + i * 16 + g) * LDC + wn * 32 + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(c + 8 * LDC) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  const int row = tid >> 1, col = (tid & 1) * 32;
  const unsigned m = m0 + row;
  if (m < n_vox) {
    const float* cr = Cs + row * LDC + col;
    __nv_bfloat16* yr = y + static_cast<long long>(m) * Co + n0 + col;
#pragma unroll
    for (int q = 0; q < 4; ++q) Vec16<__nv_bfloat16>::store(yr + q * 8, cr + q * 8);
  }
  if constexpr (kStats)
    tile_stats<__nv_bfloat16, WM, WN>(Cs, LDC, m0, n_vox, static_cast<unsigned>(H) * W, n0, Co, f);
}

inline bool mma_eligible(const void* x, const void* w, const void* y, int Ci, int Co, int dtype) {
  const uintptr_t mask = 15;
  return dtype == kBFloat16 && Ci % WK == 0 && Co % WN == 0 &&
         ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
           reinterpret_cast<uintptr_t>(y)) & mask) == 0;
}

// Launch the body that takes these operands. x (B,D,H,W,Ci), w (3,3,3,Ci,Co),
// y (B,D,H,W,Co), all contiguous, one dtype, B*D*H*W < 2^31. Returns
// cudaGetLastError() after the launch.
template <bool kPrologue, bool kStats, int kMinBlocks>
inline int launch_conv3d(const void* x, const void* w, void* y, int B, int D, int H, int W, int Ci,
                         int Co, int dtype, const Fusion& f, cudaStream_t s) {
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  if (mma_eligible(x, w, y, Ci, Co, dtype)) {
    auto kernel = conv3d_mma_kernel<kPrologue, kStats, kMinBlocks>;
    // more than 48 KB of dynamic shared memory needs this opt-in (per device)
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemW);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned>((n_vox + WM - 1) / WM), Co / WN);
    kernel<<<grid, 256, kSmemW, s>>>(static_cast<const __nv_bfloat16*>(x),
                                     static_cast<const __nv_bfloat16*>(w),
                                     static_cast<__nv_bfloat16*>(y), B, D, H, W, Ci, Co, f);
  } else {
    const dim3 grid(static_cast<unsigned>((n_vox + FM - 1) / FM), (Co + FN - 1) / FN);
    if (dtype == kFloat32) {
      conv3d_fma_kernel<float, kPrologue, kStats><<<grid, 256, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), B,
          D, H, W, Ci, Co, f);
    } else {
      conv3d_fma_kernel<__nv_bfloat16, kPrologue, kStats><<<grid, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
          static_cast<__nv_bfloat16*>(y), B, D, H, W, Ci, Co, f);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sivae
