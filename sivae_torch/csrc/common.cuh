// Shared device helpers for the sivae_torch kernels (NDHWC voxel walks).
//
// Voxel indices are 32-bit (the wrappers reject B*D*H*W >= 2^31): a 64-bit
// division costs tens of instructions, and every thread decodes its voxel.
// Element offsets (voxel * channels) are formed in 64 bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sivae {

// dtype codes passed from the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Multiprocessors of the current device (asked once; an H100 SXM's 132 if
// the query fails): how many blocks run at a time when one fits per SM.
inline int device_sms() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
    return n;
  }();
  return sms;
}

// Planes per segment of a block that marches along d (the C -> 1 and 1 -> C
// bodies, the narrow conv): per_sm blocks run on an SM at a time, so the kernel lasts
// (rounds of blocks over the SMs) x (planes a block reads, 2 of them halo); take the
// split of D that makes that product least.
inline int plane_seg_len(int patches, int D, int per_sm) {
  const int sms = device_sms() * per_sm;
  int best_len = D;
  long long best = -1;
  for (int segs = 1; segs <= D; ++segs) {
    const int len = (D + segs - 1) / segs;
    const long long blocks = static_cast<long long>(patches) * ((D + len - 1) / len);
    const long long cost = (blocks + sms - 1) / sms * (len + 2);
    if (best < 0 || cost < best) {
      best = cost;
      best_len = len;
    }
  }
  return best_len;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, once per output
}

// 16 bytes of T as floats: 4 fp32 or 8 bf16 values, from a 16-byte aligned p.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

// One output voxel of a (B, D, H, W) grid, decoded from its flat index.
struct Vox {
  int b, d, h, w;
  bool in;  // false for the padding rows of the last tile
};

__device__ __forceinline__ Vox decode_vox(unsigned m, unsigned n_vox, unsigned D, unsigned H,
                                          unsigned W) {
  Vox v;
  v.in = m < n_vox;
  unsigned r = v.in ? m : 0u;
  v.w = static_cast<int>(r % W);
  r /= W;
  v.h = static_cast<int>(r % H);
  r /= H;
  v.d = static_cast<int>(r % D);
  v.b = static_cast<int>(r / D);
  return v;
}

// Flat voxel index of tap (kd, kh, kw) of a 3x3x3 SAME window centred on v,
// or -1 when that tap falls in the zero padding. SAME padding is applied by
// this bounds check; no padded copy of the input is made.
__device__ __forceinline__ int tap_voxel(const Vox& v, int kd, int kh, int kw, int D, int H,
                                         int W) {
  const int dd = v.d + kd - 1, hh = v.h + kh - 1, ww = v.w + kw - 1;
  if (!v.in || dd < 0 || dd >= D || hh < 0 || hh >= H || ww < 0 || ww >= W) return -1;
  return ((v.b * D + dd) * H + hh) * W + ww;
}

}  // namespace sivae
