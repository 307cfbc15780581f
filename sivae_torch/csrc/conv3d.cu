// 3x3x3 SAME stride-1 convolution, NDHWC x DHWIO -> NDHWC, for sm_90a.
//
// Replaces the Pallas kernel sivae_tpu/kernels/conv3d.py:_conv3d_impl
// (_conv_tap_kernel), in the forward and, on flipped IO-swapped weights, as
// its own input gradient. It is an implicit GEMM: M = B*D*H*W output voxels,
// N = Co, K = 27*Ci. All 27 taps accumulate in fp32 and the result is rounded
// once to the output type. (The Pallas kernel rounds the running sum to the
// activation type after every depth tap.)
//
// Bound on an H100 SXM at the flagship site (64->64 at 80x96x80, batch 8,
// bf16): 1.09 TFLOP against ~1.26 GB moved, so the tensor-core rate bounds
// it. Three bodies, chosen here by shape and type:
// - "wgmma" (conv3d_wgmma.cuh): bf16 with Ci % 64 == 0 and Co % 64 == 0.
//   Warp-specialised: one producer thread feeds a ring of stages by TMA
//   (input line buffers and weight tiles, 128-byte swizzle), two consumer
//   warpgroups multiply with wgmma.mma_async, synchronised by mbarriers.
// - "mma" (conv3d_body.cuh): the other bf16 shapes with Ci % 32 == 0 and
//   Co % 64 == 0: mma.sync on ldmatrix fragments over a cp.async ring.
// - "fma" (conv3d_body.cuh): fp32 and odd channel counts, on CUDA cores.
// The fused conv + statistics kernel (conv3d_fused.cu) instantiates the same
// bodies with their optional parts; the conv here has none.

#include "conv3d_body.cuh"
#include "conv3d_wgmma.cuh"

extern "C" {

// Which body a call with these arguments runs: 2 = wgmma, 1 = mma, 0 = fma.
int sivae_conv3d_same_body(const void* x, const void* w, const void* y, int Ci, int Co, int dtype) {
  if (sivae::wgmma_eligible(x, w, y, Ci, Co, dtype)) return 2;
  return sivae::mma_eligible(x, w, y, Ci, Co, dtype) ? 1 : 0;
}

// x (B,D,H,W,Ci), w (3,3,3,Ci,Co), y (B,D,H,W,Co), all contiguous, one dtype,
// B*D*H*W < 2^31.
// Returns cudaGetLastError() after the launch.
int sivae_conv3d_same(const void* x, const void* w, void* y, int B, int D, int H, int W, int Ci,
                      int Co, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sivae::Fusion none = {nullptr, nullptr, 0.f, nullptr, nullptr};
  if (sivae::wgmma_eligible(x, w, y, Ci, Co, dtype))
    return sivae::launch_conv3d_wgmma<false, false>(x, w, y, B, D, H, W, Ci, Co, none, s);
  return sivae::launch_conv3d<false, false, 3>(x, w, y, B, D, H, W, Ci, Co, dtype, none, s);
}

// The wgmma body's block shape, as 10 * (rows / 128) + (columns / 64): the one
// a call on B*D*H*W voxels and Co output channels takes.
int sivae_conv3d_same_wgmma_shape(int B, int D, int H, int W, int Co) {
  return sivae::wgmma_block_shape(static_cast<unsigned>(B) * D * H * W, Co);
}

// The conv through the wgmma body in a given block shape (11, 21, 12 or 22),
// for measuring the shapes against each other. No model path calls it.
// cudaErrorInvalidValue when the operands or the shape do not fit that body.
int sivae_conv3d_same_wgmma(const void* x, const void* w, void* y, int B, int D, int H, int W,
                            int Ci, int Co, int dtype, int shape, void* stream) {
  if (!sivae::wgmma_eligible(x, w, y, Ci, Co, dtype) || shape <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const sivae::Fusion none = {nullptr, nullptr, 0.f, nullptr, nullptr};
  return sivae::launch_conv3d_wgmma<false, false>(x, w, y, B, D, H, W, Ci, Co, none,
                                              static_cast<cudaStream_t>(stream), shape);
}

// The same conv through the bodies of conv3d_body.cuh only (mma or fma, never
// wgmma): the earlier tensor-core body's time beside the new one's, for
// measurements and tests. No model path calls it.
int sivae_conv3d_same_mma(const void* x, const void* w, void* y, int B, int D, int H, int W,
                          int Ci, int Co, int dtype, void* stream) {
  const sivae::Fusion none = {nullptr, nullptr, 0.f, nullptr, nullptr};
  return sivae::launch_conv3d<false, false, 3>(x, w, y, B, D, H, W, Ci, Co, dtype, none,
                                               static_cast<cudaStream_t>(stream));
}

const char* sivae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
