// 3x3x3 SAME stride-1 convolutions with a 1-channel side, for sm_90a.
//
// A conv with one output (or one input) channel is a 27-tap stencil with a
// channel reduction (C -> 1) or a channel broadcast (1 -> C). Both are bound
// by the bytes of their C-wide side: at the flagship sites (64 channels at
// 80x96x80, batch 8, bf16) that side is ~629 MB, 0.19 ms at 3.35 TB/s, while
// the 1.7e10 multiply-adds are 0.03 ms of tensor-core time (both have a
// matrix product inside: the channel contraction per input voxel, the tap
// sum per output voxel) or 0.5 ms of CUDA-core time.
//
// - C -> 1 replaces sivae_tpu/kernels/conv3d_small.py:_small_out_impl
//   (_small_out_kernel). Three bodies:
//   "mma" (conv3d_to1_mma.cuh; bf16, C a multiple of 4 up to 64): the
//   channels, padded to K = 16, 32 or 64, are contracted once per input
//   voxel on the tensor cores and the 27 taps are summed from shared
//   memory, so each input byte is read about once; C = 12's 24-byte rows
//   arrive by cp.async, the others by TMA.
//   "tf32x3" (the same file; fp32 at the same C): the same contraction on
//   m16n8k8 tf32, each operand split into a TF32 big and small part and
//   three products a k-step (small*big, big*small, big*big), which holds
//   fp32 accuracy where one TF32 product would not (conv3d_tf32x3.cuh);
//   every fp32 row of C % 4 == 0 is a multiple of 16 bytes, so all arrive
//   by TMA.
//   "fma" (conv3d_to1_kernel below; every other C): eight threads per
//   output voxel, each
//   owning 16-byte chunks of the C contiguous channels; fp32 FMAs against the
//   27xC weights held in shared memory, then a shuffle reduce. The 27x
//   re-reads of overlapping windows hit L1/L2, which is what bounds it; at
//   C = 12 only two of the eight threads have channels (12->1 at 80x96x80,
//   batch 8, on an H100 80GB HBM3 at 700 W: 3.6 ms, where the mma body
//   takes 0.18 ms; chip_smoke.py phase 3).
// - 1 -> C replaces _small_in_impl (_small_in_kernel). Three bodies:
//   "mma" (conv3d_from1_mma.cuh; bf16, C a multiple of 4 up to 64, a
//   16-byte aligned output): the 27-tap window sum is a matrix product per
//   voxel, y[v, c] = sum_t x[v + off_t] w[t, c] with K = 27 padded to 32 and
//   N = C padded to a multiple of 8, on the tensor cores, the weights
//   resident in registers and the output leaving as 16-byte (8-byte where a
//   row is not a multiple of 16 bytes) stores of staged tiles; what is left
//   is the output stream.
//   "tf32x3" (the same file; fp32 at the same C): the same product on
//   m16n8k8 tf32, each operand split into a TF32 big and small part and
//   three products a k-step (small*big, big*small, big*big), which holds
//   fp32 accuracy where one TF32 product would not (conv3d_tf32x3.cuh).
//   "fma" (conv3d_from1_kernel below; every other C): one thread per
//   (voxel, group of 8 channels), the 27 input scalars in registers, the
//   27xC weights in shared memory. Every FMA reads its weight from shared
//   memory (the 8 threads of a voxel 8 floats apart: groups g and g + 4
//   share a bank), and those reads bound it, not its output stream: at
//   1 -> 64, 80x96x80, batch 2, fp32, 2.1e9 4-byte reads, twice over for
//   the conflict, are ~0.57 ms at 128 B/clk per SM.
// All accumulate in fp32 and round once. Odd channel counts (C not a
// multiple of the 16-byte vector) take the same walk with scalar accesses.

#include "common.cuh"
#include "conv3d_from1_mma.cuh"
#include "conv3d_to1_mma.cuh"

namespace sivae {
namespace {

constexpr int kVoxThreads = 8;  // threads per voxel in the C -> 1 kernel

template <typename T, bool kVec>
__global__ void __launch_bounds__(256)
conv3d_to1_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int B,
                  int D, int H, int W, int C) {
  extern __shared__ float ws[];  // [27][C]
  for (int i = threadIdx.x; i < 27 * C; i += blockDim.x) ws[i] = to_f(w[i]);
  __syncthreads();

  constexpr int V = Vec16<T>::N;
  const int g = threadIdx.x & (kVoxThreads - 1);
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  const unsigned per_block = blockDim.x / kVoxThreads;
  const unsigned stride = gridDim.x * per_block;
  // the loop bound is uniform over each warp (base is the warp's first
  // voxel), so every lane reaches the shuffles; voxels past the end compute
  // zeros and store nothing
  for (unsigned base = blockIdx.x * per_block + (threadIdx.x & ~31u) / kVoxThreads;
       base < n_vox; base += stride) {
    const unsigned m = base + (threadIdx.x & 31u) / kVoxThreads;
    const Vox v = decode_vox(m, n_vox, D, H, W);
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      const int src = tap_voxel(v, t / 9, (t / 3) % 3, t % 3, D, H, W);
      if (src < 0) continue;
      const T* xr = x + static_cast<long long>(src) * C;
      const float* wt = ws + t * C;
      for (int c0 = g * V; c0 < C; c0 += kVoxThreads * V) {
        float xv[V];
        if (kVec) {
          Vec16<T>::load(xr + c0, xv);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) xv[e] = c0 + e < C ? to_f(xr[c0 + e]) : 0.f;
        }
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (kVec || c0 + e < C) acc = fmaf(xv[e], wt[c0 + e], acc);
      }
    }
#pragma unroll
    for (int s = kVoxThreads / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (g == 0 && v.in) y[m] = from_f<T>(acc);
  }
}

constexpr int kGroup = 8;  // output channels per thread in the 1 -> C kernel

template <typename T, bool kVec>
__global__ void __launch_bounds__(256)
conv3d_from1_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int B,
                    int D, int H, int W, int C) {
  extern __shared__ float ws[];  // [27][C]
  for (int i = threadIdx.x; i < 27 * C; i += blockDim.x) ws[i] = to_f(w[i]);
  __syncthreads();

  const unsigned groups = (C + kGroup - 1) / kGroup;
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  const long long total = static_cast<long long>(n_vox) * groups;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const unsigned m = static_cast<unsigned>(e / groups);
    const int c0 = static_cast<int>(e - static_cast<long long>(m) * groups) * kGroup;
    const Vox v = decode_vox(m, n_vox, D, H, W);
    float xin[27];
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      const int src = tap_voxel(v, t / 9, (t / 3) % 3, t % 3, D, H, W);
      xin[t] = src < 0 ? 0.f : to_f(x[src]);
    }
    float out[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int c = kVec ? c0 + j : min(c0 + j, C - 1);
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < 27; ++t) acc = fmaf(xin[t], ws[t * C + c], acc);
      out[j] = acc;
    }
    T* yr = y + static_cast<long long>(m) * C + c0;
    if (kVec) {
#pragma unroll
      for (int j = 0; j < kGroup; j += Vec16<T>::N) Vec16<T>::store(yr + j, out + j);
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (c0 + j < C) yr[j] = from_f<T>(out[j]);
    }
  }
}

int grid_for(long long work, int per_block) {
  const long long blocks = (work + per_block - 1) / per_block;
  const long long cap = 132LL * 16;  // a few waves of 256-thread blocks on 132 SMs
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// 16-byte accesses need C a multiple of the vector (8 bf16 / 4 fp32; 8 for
// the 1 -> C stores in either type) and 16-byte aligned tensors.
bool vec_ok(const void* x, const void* y, int C, int elems) {
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(x) | reinterpret_cast<unsigned long long>(y);
  return C % elems == 0 && (addr & 15) == 0;
}

template <typename T>
void launch_to1(const void* x, const void* w, void* y, int B, int D, int H, int W, int C,
                cudaStream_t s) {
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  const int grid = grid_for(n_vox, 256 / kVoxThreads);
  const size_t smem = sizeof(float) * 27 * C;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (vec_ok(x, x, C, Vec16<T>::N))
    conv3d_to1_kernel<T, true><<<grid, 256, smem, s>>>(xt, wt, yt, B, D, H, W, C);
  else
    conv3d_to1_kernel<T, false><<<grid, 256, smem, s>>>(xt, wt, yt, B, D, H, W, C);
}

template <typename T>
void launch_from1(const void* x, const void* w, void* y, int B, int D, int H, int W, int C,
                  cudaStream_t s) {
  const unsigned n_vox = static_cast<unsigned>(B) * D * H * W;
  const int grid = grid_for(static_cast<long long>(n_vox) * ((C + kGroup - 1) / kGroup), 256);
  const size_t smem = sizeof(float) * 27 * C;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (vec_ok(y, y, C, kGroup))
    conv3d_from1_kernel<T, true><<<grid, 256, smem, s>>>(xt, wt, yt, B, D, H, W, C);
  else
    conv3d_from1_kernel<T, false><<<grid, 256, smem, s>>>(xt, wt, yt, B, D, H, W, C);
}

}  // namespace
}  // namespace sivae

extern "C" {

// Which body a C -> 1 call with these arguments runs: 1 = mma (bf16
// tensor-core contraction), 2 = tf32x3 (its fp32 form), 0 = fma.
int sivae_conv3d_to1_body(const void* x, int C, int dtype) {
  if (sivae::to1_mma_eligible(x, C, dtype)) return 1;
  return sivae::to1_tf32x3_eligible(x, C, dtype) ? 2 : 0;
}

// x (B,D,H,W,C), w (3,3,3,C), y (B,D,H,W); contiguous, one dtype, B*D*H*W < 2^31.
int sivae_conv3d_to1(const void* x, const void* w, void* y, int B, int D, int H, int W, int C,
                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sivae::to1_mma_eligible(x, C, dtype)) return sivae::launch_to1_mma(x, w, y, B, D, H, W, C, s);
  if (sivae::to1_tf32x3_eligible(x, C, dtype))
    return sivae::launch_to1_tf32x3(x, w, y, B, D, H, W, C, s);
  if (dtype == sivae::kFloat32)
    sivae::launch_to1<float>(x, w, y, B, D, H, W, C, s);
  else
    sivae::launch_to1<__nv_bfloat16>(x, w, y, B, D, H, W, C, s);
  return static_cast<int>(cudaGetLastError());
}

// The C -> 1 conv through the CUDA-core body whatever the dispatch would
// choose: the body the tensor-core ones superseded (bf16 at C = 12, 24, 48;
// fp32 at every C), its time beside the new one's, for measurements and
// tests. No model path calls it.
int sivae_conv3d_to1_fma(const void* x, const void* w, void* y, int B, int D, int H, int W, int C,
                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sivae::kFloat32)
    sivae::launch_to1<float>(x, w, y, B, D, H, W, C, s);
  else
    sivae::launch_to1<__nv_bfloat16>(x, w, y, B, D, H, W, C, s);
  return static_cast<int>(cudaGetLastError());
}

// The 1 -> C conv through the CUDA-core body whatever the dispatch would
// choose: the body the tensor-core ones superseded (bf16 at C = 12, 24, 48;
// fp32 at every C), its time beside the new one's, for measurements and
// tests. No model path calls it.
int sivae_conv3d_from1_fma(const void* x, const void* w, void* y, int B, int D, int H, int W,
                           int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sivae::kFloat32)
    sivae::launch_from1<float>(x, w, y, B, D, H, W, C, s);
  else
    sivae::launch_from1<__nv_bfloat16>(x, w, y, B, D, H, W, C, s);
  return static_cast<int>(cudaGetLastError());
}

// Which body a 1 -> C call writing into y runs: 1 = mma (bf16 tensor-core
// tap product), 2 = tf32x3 (its fp32 form), 0 = fma.
int sivae_conv3d_from1_body(const void* y, int C, int dtype) {
  return sivae::from1_mma_body(y, C, dtype);
}

// x (B,D,H,W), w (3,3,3,C), y (B,D,H,W,C); contiguous, one dtype, B*D*H*W < 2^31.
int sivae_conv3d_from1(const void* x, const void* w, void* y, int B, int D, int H, int W, int C,
                       int dtype, void* stream) {
  if (sivae::from1_mma_body(y, C, dtype) != 0)
    return sivae::launch_from1_mma(x, w, y, B, D, H, W, C, dtype,
                                   static_cast<cudaStream_t>(stream));
  return sivae_conv3d_from1_fma(x, w, y, B, D, H, W, C, dtype, stream);
}

}  // extern "C"
