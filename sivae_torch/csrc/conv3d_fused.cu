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
// blocks on this card run in no order. Here the implicit GEMM of conv3d.cu
// runs with its two optional parts switched on. Bodies, chosen in C by shape,
// type and alignment:
// - "wgmma" (conv3d_wgmma.cuh; bf16 with Ci % 64 == 0 and Co % 64 == 0; the
//   conv's 32-channel chunk is not used here, its prologue walks 128-byte rows):
//   conv3d_same's warp-specialised mainloop. The consumers apply g once per
//   stage to the TMA-written line buffer in shared memory, a third of its rows
//   after each kw group's wgmmas are issued (the tap masks zero the padding
//   afterwards, so it stays 0); the plane sums come from each warp's staged,
//   rounded output tile, one slot per 16-row tile in the drained ring, and
//   the block adds them with one atomicAdd per (plane, column, sum). The
//   256 x 128 block shape is left out: with the epilogue it spills.
// - "tf32x3" (conv3d_tf32x3.cuh; fp32 with Ci % 32 == 0 and Co % 32 == 0):
//   conv3d_same's three-product TF32 mainloop. g is applied in registers to
//   each raw fp32 A fragment between its ldmatrix and its split, before the
//   tap mask zeroes the padding; the plane sums come from the fp32
//   accumulators, a warp tile's 16 rows of one plane reduced by shuffles into
//   a slot, one atomicAdd per (plane, column, sum) a block. Its weights are
//   split into the scratch the caller passes, as for conv3d_same.
// - "mma" / "fma" (conv3d_body.cuh): the other shapes. The prologue is
//   applied in shared memory after cp.async (by registers in the FMA body);
//   the statistics come from the fp32 tile the epilogue stages. "fma" is the
//   fp32 body "tf32x3" superseded (64->64 at 80x96x80, batch 2, with the
//   prologue: 11.675 ms, the unfused stage 7.844, H100 80GB HBM3, 700 W).
// Atomics, not a second reduction kernel: the additions' order changes from
// run to run, so the sums agree with a fixed-order fp32 sum of the same H*W
// values to ~1e-6 relative (the smoke run allows 1e-3 of the largest sum).
//
// Bound on an H100 SXM at the flagship site (64->64 at 80x96x80, batch 8,
// bf16): the conv's 1.09 TFLOP at the tensor-core rate, as for conv3d.cu;
// the prologue and the statistics add no device-memory bytes beyond the
// (B*D, Co) sums. What the fusion saves is the separate elementwise pass
// before the conv and the two reductions that re-read y after it. What the
// wgmma body pays for it: the prologue's shared-memory rewrite (a quarter
// more shared-memory traffic in a mainloop that shared-memory reads already
// hold) and the statistics epilogue, which no other block overlaps (one
// block runs per SM). In fp32 the same 1.09 TFLOP at 165 TF/s (a third of
// the TF32 rate: the three products fp32 accuracy takes), ~6.6 ms; the
// tf32x3 body pays for the prologue in ALU work on the A fragments (g on
// each of the 27 taps' loads), where its split already costs the most.

#include "conv3d_body.cuh"
#include "conv3d_tf32x3.cuh"
#include "conv3d_wgmma.cuh"

namespace {

sivae::Fusion fusion(const void* in_a, const void* in_b, float slope, void* psum, void* psumsq) {
  return {static_cast<const float*>(in_a), static_cast<const float*>(in_b), slope,
          static_cast<float*>(psum), static_cast<float*>(psumsq)};
}

int launch_fused_wgmma(const void* x, const void* w, void* y, int B, int D, int H, int W, int Ci,
                       int Co, const sivae::Fusion& f, cudaStream_t s, int shape = 0) {
  if (f.in_a != nullptr)
    return sivae::launch_conv3d_wgmma<true, true>(x, w, y, B, D, H, W, Ci, Co, f, s, shape);
  return sivae::launch_conv3d_wgmma<false, true>(x, w, y, B, D, H, W, Ci, Co, f, s, shape);
}

int launch_fused_tf32x3(const void* x, const void* w, void* y, void* scratch, int B, int D, int H,
                        int W, int Ci, int Co, const sivae::Fusion& f, cudaStream_t s) {
  if (f.in_a != nullptr)
    return sivae::launch_conv3d_tf32x3<true, true>(x, w, y, scratch, B, D, H, W, Ci, Co, f, s);
  return sivae::launch_conv3d_tf32x3<false, true>(x, w, y, scratch, B, D, H, W, Ci, Co, f, s);
}

}  // namespace

extern "C" {

// Which body a call with these operands runs (its y freshly allocated, so
// aligned): 2 = wgmma, 4 = tf32x3, 1 = mma, 0 = fma.
int sivae_conv3d_fused_stats_body(const void* x, const void* w, int Ci, int Co, int dtype) {
  if (sivae::wgmma_fused_eligible(x, w, nullptr, Ci, Co, dtype)) return 2;
  if (sivae::tf32x3_eligible(x, w, nullptr, Ci, Co, dtype)) return 4;
  return sivae::mma_eligible(x, w, nullptr, Ci, Co, dtype) ? 1 : 0;
}

// The fused kernel through the bodies of conv3d_body.cuh only (mma or fma,
// never wgmma or tf32x3): the dispatch for what neither takes, and the
// earlier body beside the new one (mma for wgmma's operands, fma for
// tf32x3's), for measurements and tests.
int sivae_conv3d_fused_stats_mma(const void* x, const void* w, const void* in_a, const void* in_b,
                                 float slope, void* y, void* psum, void* psumsq, int B, int D,
                                 int H, int W, int Ci, int Co, int dtype, void* stream) {
  const sivae::Fusion f = fusion(in_a, in_b, slope, psum, psumsq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_a != nullptr)
    return sivae::launch_conv3d<true, true, 2>(x, w, y, B, D, H, W, Ci, Co, dtype, f, s);
  return sivae::launch_conv3d<false, true, 2>(x, w, y, B, D, H, W, Ci, Co, dtype, f, s);
}

// x (B,D,H,W,Ci), w (3,3,3,Ci,Co), y (B,D,H,W,Co) contiguous, one dtype;
// in_a, in_b (Ci) fp32 or both null (no prologue); psum, psumsq (B*D, Co)
// fp32, zeroed by the caller; scratch: sivae_conv3d_same_scratch() floats,
// 16-byte aligned, for an fp32 call, else unused. B*D*H*W < 2^31.
// Returns cudaGetLastError() after the launch.
int sivae_conv3d_fused_stats(const void* x, const void* w, const void* in_a, const void* in_b,
                             float slope, void* y, void* psum, void* psumsq, int B, int D, int H,
                             int W, int Ci, int Co, int dtype, void* scratch, void* stream) {
  if (sivae::wgmma_fused_eligible(x, w, y, Ci, Co, dtype))
    return launch_fused_wgmma(x, w, y, B, D, H, W, Ci, Co, fusion(in_a, in_b, slope, psum, psumsq),
                              static_cast<cudaStream_t>(stream));
  if (sivae::tf32x3_eligible(x, w, y, Ci, Co, dtype))
    return launch_fused_tf32x3(x, w, y, scratch, B, D, H, W, Ci, Co,
                               fusion(in_a, in_b, slope, psum, psumsq),
                               static_cast<cudaStream_t>(stream));
  return sivae_conv3d_fused_stats_mma(x, w, in_a, in_b, slope, y, psum, psumsq, B, D, H, W, Ci,
                                      Co, dtype, stream);
}

// The fused kernel's wgmma block shape for B*D*H*W voxels and Co output
// channels, as 10 * (rows / 128) + (columns / 64).
int sivae_conv3d_fused_stats_wgmma_shape(int B, int D, int H, int W, int Co) {
  return sivae::wgmma_block_shape(static_cast<unsigned>(B) * D * H * W, Co, true);
}

// The fused kernel through the wgmma body in a given block shape (11, 21, 12
// or 22), for measuring the shapes against each other. No model path calls
// it. cudaErrorInvalidValue when the operands or the shape do not fit that body.
int sivae_conv3d_fused_stats_wgmma(const void* x, const void* w, const void* in_a,
                                   const void* in_b, float slope, void* y, void* psum,
                                   void* psumsq, int B, int D, int H, int W, int Ci, int Co,
                                   int dtype, int shape, void* stream) {
  if (!sivae::wgmma_fused_eligible(x, w, y, Ci, Co, dtype) || shape <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fused_wgmma(x, w, y, B, D, H, W, Ci, Co, fusion(in_a, in_b, slope, psum, psumsq),
                            static_cast<cudaStream_t>(stream), shape);
}

}  // extern "C"
