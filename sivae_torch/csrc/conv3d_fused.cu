// Fused [affine + LeakyReLU prologue] -> 3x3x3 SAME stride-1 conv ->
// [per-plane output statistics], NDHWC x DHWIO -> NDHWC, for sm_90a.
//
// Replaces the Pallas kernel sivae_tpu/kernels/conv3d_fused.py:
// conv3d_fused_stats (_fused_kernel). What it computes:
//   y      = conv3d_same(g(x), w), all 27 taps in fp32, rounded once,
//            with g = identity, or g(x) = leaky_relu(x * a[c] + b[c]) in fp32
//            rounded once to the conv type; the zero padding comes after g;
//   psum   = sum over (h, w) of the ROUNDED y, fp32, per (b, d, co);
//   psumsq = sum over (h, w) of its square.
//
// It is not the Pallas kernel carried over. That one walks a (b, d, h-block,
// k) grid in order and keeps the statistics in an output block that stays
// resident across grid steps, and it stacks kh into the matrix unit's N;
// blocks on this card run in no order and mma.sync has no use for the
// stacking. Here the implicit GEMM of conv3d_body.cuh runs with its two
// optional parts switched on: the prologue is applied in shared memory to
// the line buffer after cp.async has delivered it (by registers in the FMA
// body), and the statistics are taken from the fp32 tile that the epilogue
// stages through shared memory anyway, then added with atomicAdd into
// (B*D, Co) buffers that the caller zeroes. Atomics, not a second reduction
// kernel: the additions' order changes from run to run, so the sums agree
// with a fixed-order fp32 sum of the same H*W values to ~1e-6 relative (the
// smoke run allows 1e-3 of the largest sum).
//
// Bound on an H100 SXM at the flagship site (64->64 at 80x96x80, batch 8,
// bf16): the conv's 1.09 TFLOP at the tensor-core rate, as for conv3d.cu;
// the prologue and the statistics add no device-memory bytes beyond the
// (B*D, Co) sums. What the fusion saves is the separate elementwise pass
// before the conv and the two reductions that re-read y after it.

#include "conv3d_body.cuh"

extern "C" {

// x (B,D,H,W,Ci), w (3,3,3,Ci,Co), y (B,D,H,W,Co) contiguous, one dtype;
// in_a, in_b (Ci) fp32 or both null (no prologue); psum, psumsq (B*D, Co)
// fp32, zeroed by the caller. B*D*H*W < 2^31.
// Returns cudaGetLastError() after the launch.
int sivae_conv3d_fused_stats(const void* x, const void* w, const void* in_a, const void* in_b,
                             float slope, void* y, void* psum, void* psumsq, int B, int D, int H,
                             int W, int Ci, int Co, int dtype, void* stream) {
  const sivae::Fusion f = {static_cast<const float*>(in_a), static_cast<const float*>(in_b), slope,
                           static_cast<float*>(psum), static_cast<float*>(psumsq)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_a != nullptr)
    return sivae::launch_conv3d<true, true, 2>(x, w, y, B, D, H, W, Ci, Co, dtype, f, s);
  return sivae::launch_conv3d<false, true, 2>(x, w, y, B, D, H, W, Ci, Co, dtype, f, s);
}

}  // extern "C"
