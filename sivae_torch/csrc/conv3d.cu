// 3x3x3 SAME stride-1 convolution, NDHWC x DHWIO -> NDHWC, for sm_90a.
//
// Replaces the Pallas kernel sivae_tpu/kernels/conv3d.py:_conv3d_impl
// (_conv_tap_kernel), in the forward and, on flipped IO-swapped weights, as
// its own input gradient. It is an implicit GEMM: M = B*D*H*W output voxels,
// N = Co, K = 27*Ci. All 27 taps accumulate in fp32 and the result is rounded
// once to the output type. (The Pallas kernel rounds the running sum to the
// activation type after every depth tap.)
//
// Five bodies on the dispatch, chosen here by shape, type and alignment:
// - "wgmma" (conv3d_wgmma.cuh): bf16 with Ci % 32 == 0 and Co % 64 == 0. At
//   the flagship site (64->64 at 80x96x80, batch 8) 1.09 TFLOP against
//   ~1.26 GB moved: the tensor-core rate bounds it. Warp-specialised: one
//   producer thread feeds a ring of stages by TMA (input line buffers and
//   weight tiles, 128-byte swizzle), two consumer warpgroups multiply with
//   wgmma.mma_async, synchronised by mbarriers. 64-channel chunks where
//   Ci % 64 == 0; 32-channel ones (64-byte swizzle) at Ci = 32 (fc_600's and
//   spatial_1200_fullsize's 32 -> 64) and 96.
// - "narrow" (conv3d_narrow.cuh): the other bf16 shapes with Ci and Co
//   multiples of 4 up to 64 (the FC and spatial_150 channels). The bytes
//   bound it (12->12 at 80x96x80, batch 8: 0.070 ms at 3.35 TB/s); a block
//   reads each haloed input plane into shared memory once and multiplies
//   with mma.sync, K padded to 16 and N to 8. H100 80GB HBM3, 700 W: 0.37 ms
//   there (cuDNN 1.9 ms, the fma body 8.9 ms; chip_smoke.py phase 3).
// - "tf32x3" (conv3d_tf32x3.cuh): fp32 with Ci % 32 == 0 and Co % 32 == 0
//   (every fp32 site of spatial_1200 and spatial_1200_fullsize). One TF32
//   product would miss the fp32 tolerance (11 significand bits: ~3e-4 of
//   the largest output at K = 1728); each operand is split into a TF32 big
//   and small part and three wgmma tf32 products (small*big, big*small,
//   big*big) hold fp32 accuracy at a third of the 495 TF/s TF32 rate. The
//   structure of the "wgmma" body, in fp32, with the weights split and
//   transposed once per call into a scratch tensor the caller allocates.
// - "narrow_tf32x3" (conv3d_narrow_tf32x3.cuh): the other fp32 shapes with
//   Ci and Co multiples of 4 up to 64 (the fp32 convs of the FC family and
//   of spatial_150: 12/16/24/32/48 channels, the eval CLI's default and
//   `--no-bf16` training). tf32x3's split products and warp roles, K = Ci
//   rounded up to 8; where Co <= 32 the 3 kw taps are one wgmma's N (a
//   wgmma costs about the same at N = 16 as at 64, so a third as many),
//   their shifts summed after the loop. Each stage's weights, split and
//   laid out by the launch, arrive as one bulk copy, and so does the input
//   line where Ci % 8 == 4.
// - "fma" (conv3d_body.cuh): fp32 at the channel counts neither tf32x3
//   form takes, and bf16 at those no other body takes, on CUDA cores.
// The mma.sync body of conv3d_body.cuh ("mma"), which "wgmma" superseded at
// every shape it took, is reachable through sivae_conv3d_same_mma only, for
// measurements and tests. The fused conv + statistics kernel
// (conv3d_fused.cu) instantiates the wgmma, tf32x3, mma and fma bodies with
// their optional parts; the conv here has none.

#include "conv3d_body.cuh"
#include "conv3d_narrow.cuh"
#include "conv3d_narrow_tf32x3.cuh"
#include "conv3d_tf32x3.cuh"
#include "conv3d_wgmma.cuh"

extern "C" {

// Which body a call with these arguments runs: 2 = wgmma, 3 = narrow,
// 4 = tf32x3, 5 = narrow_tf32x3, 0 = fma.
int sivae_conv3d_same_body(const void* x, const void* w, const void* y, int Ci, int Co, int dtype) {
  if (sivae::wgmma_eligible(x, w, y, Ci, Co, dtype)) return 2;
  if (sivae::tf32x3_eligible(x, w, y, Ci, Co, dtype)) return 4;
  if (sivae::narrow_eligible(x, y, Ci, Co, dtype)) return 3;
  return sivae::narrow_tf32x3_eligible(x, w, y, Ci, Co, dtype) ? 5 : 0;
}

// Floats of scratch an fp32 call needs (the split weights of either tf32x3
// form); 0 for bf16.
int sivae_conv3d_same_scratch(int Ci, int Co, int dtype) {
  if (dtype != sivae::kFloat32) return 0;
  const long long wide = 3LL * 27 * Ci * Co;
  const long long narrow = Ci <= 64 && Co <= 64 ? sivae::narrow_tf32x3_scratch(Ci, Co) : 0;
  return static_cast<int>(wide > narrow ? wide : narrow);
}

// x (B,D,H,W,Ci), w (3,3,3,Ci,Co), y (B,D,H,W,Co), all contiguous, one dtype,
// B*D*H*W < 2^31; scratch: sivae_conv3d_same_scratch() floats, 16-byte
// aligned, for an fp32 call, else unused.
// Returns cudaGetLastError() after the launch.
int sivae_conv3d_same(const void* x, const void* w, void* y, int B, int D, int H, int W, int Ci,
                      int Co, int dtype, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sivae::Fusion none = {nullptr, nullptr, 0.f, nullptr, nullptr};
  if (sivae::wgmma_eligible(x, w, y, Ci, Co, dtype))
    return sivae::launch_conv3d_wgmma<false, false>(x, w, y, B, D, H, W, Ci, Co, none, s);
  if (sivae::tf32x3_eligible(x, w, y, Ci, Co, dtype))
    return sivae::launch_conv3d_tf32x3<false, false>(x, w, y, scratch, B, D, H, W, Ci, Co, none, s);
  if (sivae::narrow_eligible(x, y, Ci, Co, dtype))
    return sivae::launch_conv3d_narrow(x, w, y, B, D, H, W, Ci, Co, s);
  if (sivae::narrow_tf32x3_eligible(x, w, y, Ci, Co, dtype))
    return sivae::launch_conv3d_narrow_tf32x3(x, w, y, scratch, B, D, H, W, Ci, Co, s);
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
// wgmma, narrow or either tf32x3 form): the body each of those superseded on
// its operands (mma for wgmma's, fma for the others'), its time beside the
// new one's, for measurements and tests. No model path calls it.
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
