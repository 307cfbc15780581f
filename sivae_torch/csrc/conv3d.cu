// 3x3x3 SAME stride-1 convolution, NDHWC x DHWIO -> NDHWC, for sm_90a.
//
// Replaces the Pallas kernel sivae_tpu/kernels/conv3d.py:_conv3d_impl
// (_conv_tap_kernel), in the forward and, on flipped IO-swapped weights, as
// its own input gradient. It is an implicit GEMM: M = B*D*H*W output voxels,
// N = Co, K = 27*Ci; the two bodies (tensor-core mma.sync for bf16 with
// Ci % 32 == 0 and Co % 64 == 0, fp32 FMA for everything else) are in
// conv3d_body.cuh and are instantiated here without the optional prologue
// and statistics. All 27 taps accumulate in fp32 and the result is rounded
// once to the output type. (The Pallas kernel rounds the running sum to the
// activation type after every depth tap.)
//
// Bound on an H100 SXM at the flagship site (64->64 at 80x96x80, batch 8,
// bf16): 1.09 TFLOP against ~1.26 GB moved, so the tensor-core rate bounds
// it. Neither body uses TMA or wgmma yet: this is the simple, right version;
// making it fast is later work.

#include "conv3d_body.cuh"

extern "C" {

// Which body a call with these arguments runs: 1 = tensor-core (mma), 0 = FMA.
int sivae_conv3d_same_body(const void* x, const void* w, const void* y, int Ci, int Co, int dtype) {
  return sivae::mma_eligible(x, w, y, Ci, Co, dtype) ? 1 : 0;
}

// x (B,D,H,W,Ci), w (3,3,3,Ci,Co), y (B,D,H,W,Co), all contiguous, one dtype,
// B*D*H*W < 2^31.
// Returns cudaGetLastError() after the launch.
int sivae_conv3d_same(const void* x, const void* w, void* y, int B, int D, int H, int W, int Ci,
                      int Co, int dtype, void* stream) {
  const sivae::Fusion none = {nullptr, nullptr, 0.f, nullptr, nullptr};
  return sivae::launch_conv3d<false, false, 3>(x, w, y, B, D, H, W, Ci, Co, dtype, none,
                                               static_cast<cudaStream_t>(stream));
}

const char* sivae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
