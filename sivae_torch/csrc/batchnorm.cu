// Train-mode BatchNorm + LeakyReLU / ReLU over a channels-last [M, C] matrix, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which fuses it. The port's
// plain eager version (kernels/batchnorm.py batchnorm_train_plain) ran it as ~20 ATen passes
// forward and ~25 backward, most of them over fp32 temporaries of the whole tensor; those passes
// held ~60% of a training step's device time on an H100. Normalisation does a handful of
// operations a byte, far below the card's ~295, so what bounds it is bytes: these kernels read
// x once for the statistics, x once and y once to apply, x and g once for the gradient sums and
// x, g and dx once for the input gradient, and keep every temporary in registers.
//
// A tensor is read as a row-major [M, C] matrix, C innermost (the NDHWC memory of the port's
// activations; M = N*D*H*W, or the batch for a Linear's features). Offsets are 64-bit.
// Two layouts of one algorithm, chosen from [M, C] by kernels/batchnorm.py bn_grid:
// - "rows" (M >> C, every conv site): each thread walks 16-byte vectors with a grid stride that
//   is a multiple of lcm(V, C) elements (V = 8 bf16 or 4 fp32 a vector), so the V channels of
//   its vectors never change (C = 3, 12 and 24 included); per-channel parameters sit in shared
//   memory repeated over one period of lcm(V, C) entries, so a thread's V channels are V
//   consecutive, 16-byte aligned entries whatever C is; the statistics stay in registers until
//   one block reduction.
// - "cols" (small M, large C: FeatureBatchNorm): one thread a channel walking rows, 32 channels
//   x 8 row lanes a block.
// Sums are taken in a fixed order (per thread, then over the block's threads in shared memory,
// then over the blocks' partial rows in the finalize): no atomics, the same bits every run.
// Every elementwise step keeps the plain version's fp32 op order with separate roundings
// (__fmul_rn and friends: no fused multiply-add), so given the same statistics y and dx are
// the plain version's bit for bit.

#include <cstdint>

#include "common.cuh"

namespace sivae {
namespace {

constexpr int kRows = 0;  // layout codes (kernels/batchnorm.py LAYOUTS)
constexpr int kCols = 1;
constexpr int kColX = 32;  // "cols" block: 32 channels x 8 row lanes
constexpr int kColY = 8;
constexpr int kMaxRowThreads = 512;
constexpr int kMaxRowPeriod = 1024;  // lcm(V, C): the backward's 6 parameter arrays in 24 KB

constexpr int kActNone = 0;  // activation codes (kernels/batchnorm.py act_code); 2 LeakyReLU
constexpr int kActRelu = 1;

// forward modes of sivae_bn_forward
constexpr int kFwdSums = 0;   // statistics kernel + finalize to [sum x, sum x^2] (several ranks)
constexpr int kFwdLocal = 1;  // statistics kernel + finalize to the scalars + apply
constexpr int kFwdGiven = 2;  // finalize from the given mean and raw variance + apply
// backward modes of sivae_bn_backward
constexpr int kBwdSums = 0;   // gradient sums: reduce kernel + finalize to [sum g*xhat, sum g]
// 1: the sums, then the input gradient from them
constexpr int kBwdApply = 2;  // the input gradient from the given (all-reduced) sums

// act(round(v)) as the plain version's _act(y.to(out_dtype)) computes it: the activation acts
// on the rounded value; a LeakyReLU's negative side is rounded once more.
template <typename T>
__device__ __forceinline__ float bn_out(float v, int act, float slope) {
  const float r = to_f(from_f<T>(v));
  if (act == kActNone || r > 0.f || r != r) return r;
  return act == kActRelu ? 0.f : to_f(from_f<T>(__fmul_rn(r, slope)));
}

// The pre-activation in fp32, (x - mean) * mul + bias.
__device__ __forceinline__ float bn_pre(float x, float mean, float mul, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), b);
}

// The cotangent behind the activation: g above 0, g * slope below (the forward's own
// pre-activation, in fp32).
__device__ __forceinline__ float bn_gf(float g, float pre, int act, float slope) {
  return act == kActNone || pre > 0.f ? g : __fmul_rn(g, slope);
}

// V elements starting at element v * V, zero past `total`.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, long long v, long long total,
                                         float* out) {
  constexpr int V = Vec16<T>::N;
  const long long e = v * V;
  if (e + V <= total) {
    Vec16<T>::load(p + e, out);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = e + j < total ? to_f(p[e + j]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, long long v, long long total,
                                          const float* in) {
  constexpr int V = Vec16<T>::N;
  const long long e = v * V;
  if (e + V <= total) {
    Vec16<T>::store(p + e, in);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (e + j < total) p[e + j] = from_f<T>(in[j]);
}

// Four per-channel values, of the lanes i..i+3 of a thread whose vectors start at period
// position q0 (a multiple of V), from a parameter array repeated over the period in shared
// memory. Four lanes at a time keep the backward's six arrays in few registers.
__device__ __forceinline__ void chan4(const float* p, int q0, int i, float* out) {
  const float4 q = *reinterpret_cast<const float4*>(p + q0 + i);
  out[0] = q.x;
  out[1] = q.y;
  out[2] = q.z;
  out[3] = q.w;
}

// Fills `n` shared arrays of one period each: dst[a * period + e] = value a of channel e % C.
template <class F>
__device__ __forceinline__ void fill_period(float* dst, int n, int period, int C, F value) {
  for (int e = threadIdx.x; e < period; e += blockDim.x) {
    const int c = e % C;
    for (int a = 0; a < n; ++a) dst[a * period + e] = value(a, c);
  }
  __syncthreads();
}

// The "rows" walk: this thread's first vector and the period position of its first lane
// (its channel is q0 % C).
template <int V>
struct RowWalk {
  long long v0, stride, nvec;
  int q0;
  __device__ __forceinline__ RowWalk(long long total, int period) {
    v0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    stride = static_cast<long long>(gridDim.x) * blockDim.x;
    nvec = (total + V - 1) / V;
    q0 = static_cast<int>(v0 * V % period);
  }
};

// Block reduction of the "rows" kernels: thread t holds per-lane sums a[j], b[j] for the
// channels (t V + j) % C (the same for every thread of the same phase t % phases, as the block
// size is a multiple of phases = period / V, period = lcm(V, C)). out[0][c] = sum of a,
// out[1][c] = sum of b over every lane of channel c, in a fixed order: by period position, then
// by thread.
template <int V>
__device__ __forceinline__ void block_reduce_rows(const float* a, const float* b, float* red,
                                                  int C, int period, float* __restrict__ out) {
  const int t = threadIdx.x, nt = blockDim.x;
  __syncthreads();  // red may alias the parameters the walk read
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[t * 2 * V + j] = a[j];
    red[t * 2 * V + V + j] = b[j];
  }
  __syncthreads();
  const int phases = period / V;
  for (int o = t; o < 2 * C; o += nt) {
    const int s = o / C, c = o - s * C;
    float acc = 0.f;
    for (int e = c; e < period; e += C) {
      const int p = e / V, j = e - p * V;
      for (int u = p; u < nt; u += phases) acc += red[u * 2 * V + s * V + j];
    }
    out[o] = acc;
  }
}

// ---- statistics: per-block partial [sum x, sum x^2] ----

template <typename T>
__global__ void __launch_bounds__(kMaxRowThreads, 2)
bn_stats_rows(const T* __restrict__ x, long long total, int C, int period,
              float* __restrict__ partials) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ float red[];  // [blockDim.x][2V]
  const RowWalk<V> w(total, period);
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
  for (long long v = w.v0; v < w.nvec; v += 2 * w.stride) {
    float p[V], q[V];
    const bool two = v + w.stride < w.nvec;
    load_vec(x, v, total, p);
    if (two) load_vec(x, v + w.stride, total, q);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1[j] += p[j];
      s2[j] += __fmul_rn(p[j], p[j]);
    }
    if (two) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] += q[j];
        s2[j] += __fmul_rn(q[j], q[j]);
      }
    }
  }
  block_reduce_rows<V>(s1, s2, red, C, period,
                       partials + static_cast<long long>(blockIdx.x) * 2 * C);
}

// Reduction of the "cols" kernels: the 8 row lanes of each channel, in lane order.
__device__ __forceinline__ void block_reduce_cols(float a, float b, int C,
                                                  float* __restrict__ out) {
  __shared__ float red[kColY][2][kColX];
  const int tx = threadIdx.x, ty = threadIdx.y, c = blockIdx.x * kColX + tx;
  red[ty][0][tx] = a;
  red[ty][1][tx] = b;
  __syncthreads();
  if (ty != 0 || c >= C) return;
  a = red[0][0][tx];
  b = red[0][1][tx];
#pragma unroll
  for (int i = 1; i < kColY; ++i) {
    a += red[i][0][tx];
    b += red[i][1][tx];
  }
  out[static_cast<long long>(blockIdx.y) * 2 * C + c] = a;
  out[static_cast<long long>(blockIdx.y) * 2 * C + C + c] = b;
}

template <typename T>
__global__ void __launch_bounds__(kColX * kColY)
bn_stats_cols(const T* __restrict__ x, long long M, int C, float* __restrict__ partials) {
  const int c = blockIdx.x * kColX + threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
  if (c < C)
    for (long long r = static_cast<long long>(blockIdx.y) * kColY + threadIdx.y; r < M;
         r += static_cast<long long>(gridDim.y) * kColY) {
      const float v = to_f(x[r * C + c]);
      s1 += v;
      s2 += __fmul_rn(v, v);
    }
  block_reduce_cols(s1, s2, C, partials);
}

// ---- finalize: the partial rows summed in order, then the per-channel scalars ----
// out (modes other than sums): [mean, raw_var, var, rstd, mul = rstd * w, k] x [C], where
// raw_var = E[x^2] - mean^2 (flax's fast variance), var = max(raw_var, 0), rstd =
// 1 / sqrt(var + eps) and k the tie factor of max(0, .) (1 above 0, 1/2 at 0, 0 below).
constexpr int kFinSums = 0, kFinFromSums = 1, kFinGiven = 2;

__global__ void __launch_bounds__(kColX * kColY)
bn_finalize(const float* __restrict__ partials, int rows, int C, int mode, float n,
            const float* __restrict__ w, float eps, const float* __restrict__ mean_in,
            const float* __restrict__ raw_in, float* __restrict__ out) {
  __shared__ float red[kColY][2][kColX];
  const int tx = threadIdx.x, ty = threadIdx.y, c = blockIdx.x * kColX + tx;
  float a = 0.f, b = 0.f;
  if (mode != kFinGiven && c < C)
    for (int r = ty; r < rows; r += kColY) {
      a += partials[static_cast<long long>(r) * 2 * C + c];
      b += partials[static_cast<long long>(r) * 2 * C + C + c];
    }
  red[ty][0][tx] = a;
  red[ty][1][tx] = b;
  __syncthreads();
  if (ty != 0 || c >= C) return;
  a = red[0][0][tx];
  b = red[0][1][tx];
#pragma unroll
  for (int i = 1; i < kColY; ++i) {
    a += red[i][0][tx];
    b += red[i][1][tx];
  }
  if (mode == kFinSums) {
    out[c] = a;
    out[C + c] = b;
    return;
  }
  float mean, raw;
  if (mode == kFinFromSums) {
    mean = __fdiv_rn(a, n);
    raw = __fsub_rn(__fdiv_rn(b, n), __fmul_rn(mean, mean));
  } else {
    mean = mean_in[c];
    raw = raw_in[c];
  }
  const float var = raw < 0.f ? 0.f : raw;
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  out[c] = mean;
  out[C + c] = raw;
  out[2 * C + c] = var;
  out[3 * C + c] = rstd;
  out[4 * C + c] = __fmul_rn(rstd, w[c]);
  out[5 * C + c] = raw > 0.f ? 1.f : raw == 0.f ? 0.5f : 0.f;
}

// ---- apply: y = act(round((x - mean) * mul + b)) ----

template <typename T>
__global__ void __launch_bounds__(kMaxRowThreads, 2)
bn_apply_rows(const T* __restrict__ x, T* __restrict__ y, long long total, int C, int period,
              const float* __restrict__ st, const float* __restrict__ bias, int act,
              float slope) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ float prm[];  // mean, mul, bias: [3][period]
  fill_period(prm, 3, period, C, [&](int a, int c) {
    return a == 0 ? st[c] : a == 1 ? st[4 * C + c] : bias[c];
  });
  const RowWalk<V> w(total, period);
  for (long long v = w.v0; v < w.nvec; v += 2 * w.stride) {
    float p[V], q[V] = {};
    const bool two = v + w.stride < w.nvec;
    load_vec(x, v, total, p);
    if (two) load_vec(x, v + w.stride, total, q);
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      float m[4], k[4], b[4];
      chan4(prm, w.q0, i, m);
      chan4(prm + period, w.q0, i, k);
      chan4(prm + 2 * period, w.q0, i, b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i + j] = bn_out<T>(bn_pre(p[i + j], m[j], k[j], b[j]), act, slope);
        q[i + j] = bn_out<T>(bn_pre(q[i + j], m[j], k[j], b[j]), act, slope);
      }
    }
    store_vec(y, v, total, p);
    if (two) store_vec(y, v + w.stride, total, q);
  }
}

template <typename T>
__global__ void __launch_bounds__(kColX * kColY)
bn_apply_cols(const T* __restrict__ x, T* __restrict__ y, long long M, int C,
              const float* __restrict__ st, const float* __restrict__ bias, int act,
              float slope) {
  const int c = blockIdx.x * kColX + threadIdx.x;
  if (c >= C) return;
  const float m = st[c], k = st[4 * C + c], b = bias[c];
  for (long long r = static_cast<long long>(blockIdx.y) * kColY + threadIdx.y; r < M;
       r += static_cast<long long>(gridDim.y) * kColY)
    y[r * C + c] = from_f<T>(bn_out<T>(bn_pre(to_f(x[r * C + c]), m, k, b), act, slope));
}

// ---- backward sums: per-block partial [sum gf * xhat, sum gf] ----
// Per-channel parameters of the backward kernels, [6][C] in shared memory (rows) or
// registers (cols): mean, rstd, mul = rstd * w, bias, and (apply only) the coefficients
// A = (-k * sum_gx) / n and B = sum_g / n of dx = ((xhat * A + gf) - B) * mul.

template <typename T>
__global__ void __launch_bounds__(kMaxRowThreads, 2)
bn_bwd_reduce_rows(const T* __restrict__ x, const T* __restrict__ g, long long total, int C,
                   int period, const float* __restrict__ mean, const float* __restrict__ rstd,
                   const float* __restrict__ w, const float* __restrict__ bias, int act,
                   float slope, float* __restrict__ partials) {
  constexpr int V = Vec16<T>::N;
  // mean, rstd, mul, bias: [4][period]; then the block reduction
  extern __shared__ float sh[];
  fill_period(sh, 4, period, C, [&](int a, int c) {
    return a == 0 ? mean[c] : a == 1 ? rstd[c] : a == 2 ? __fmul_rn(rstd[c], w[c]) : bias[c];
  });
  const RowWalk<V> wk(total, period);
  float sgx[V], sg[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sgx[j] = sg[j] = 0.f;
  for (long long v = wk.v0; v < wk.nvec; v += wk.stride) {
    float xv[V], gv[V];
    load_vec(x, v, total, xv);
    load_vec(g, v, total, gv);
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      float m[4], r[4], k[4], b[4];
      chan4(sh, wk.q0, i, m);
      chan4(sh + period, wk.q0, i, r);
      chan4(sh + 2 * period, wk.q0, i, k);
      chan4(sh + 3 * period, wk.q0, i, b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = __fsub_rn(xv[i + j], m[j]);
        const float gf = bn_gf(gv[i + j], __fadd_rn(__fmul_rn(d, k[j]), b[j]), act, slope);
        sgx[i + j] += __fmul_rn(gf, __fmul_rn(d, r[j]));
        sg[i + j] += gf;
      }
    }
  }
  block_reduce_rows<V>(sgx, sg, sh, C, period,
                       partials + static_cast<long long>(blockIdx.x) * 2 * C);
}

template <typename T>
__global__ void __launch_bounds__(kColX * kColY)
bn_bwd_reduce_cols(const T* __restrict__ x, const T* __restrict__ g, long long M, int C,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const float* __restrict__ w, const float* __restrict__ bias, int act,
                   float slope, float* __restrict__ partials) {
  const int c = blockIdx.x * kColX + threadIdx.x;
  float sgx = 0.f, sg = 0.f;
  if (c < C) {
    const float m = mean[c], r = rstd[c], k = __fmul_rn(r, w[c]), b = bias[c];
    for (long long i = static_cast<long long>(blockIdx.y) * kColY + threadIdx.y; i < M;
         i += static_cast<long long>(gridDim.y) * kColY) {
      const float d = __fsub_rn(to_f(x[i * C + c]), m);
      const float gf = bn_gf(to_f(g[i * C + c]), __fadd_rn(__fmul_rn(d, k), b), act, slope);
      sgx += __fmul_rn(gf, __fmul_rn(d, r));
      sg += gf;
    }
  }
  block_reduce_cols(sgx, sg, C, partials);
}

// ---- backward apply: dx = ((xhat * A + gf) - B) * mul, cast to x's type ----

struct BwdScalars {
  const float* mean;
  const float* rstd;
  const float* w;
  const float* bias;
  const float* k;
  const float* sums;   // [sum gf * xhat][C], [sum gf][C]
  const float* n_dev;  // the count on the device (several ranks), else null
  float n;
};

// The six per-channel values of channel c: mean, rstd, mul, bias, A, B.
__device__ __forceinline__ void bwd_channel(const BwdScalars& s, int C, int c, float* o) {
  const float n = s.n_dev != nullptr ? *s.n_dev : s.n;
  o[0] = s.mean[c];
  o[1] = s.rstd[c];
  o[2] = __fmul_rn(o[1], s.w[c]);
  o[3] = s.bias[c];
  o[4] = __fdiv_rn(__fmul_rn(-s.k[c], s.sums[c]), n);
  o[5] = __fdiv_rn(s.sums[C + c], n);
}

__device__ __forceinline__ float bwd_dx(float x, float g, const float* p, int act, float slope) {
  const float d = __fsub_rn(x, p[0]);
  const float gf = bn_gf(g, __fadd_rn(__fmul_rn(d, p[2]), p[3]), act, slope);
  const float xhat = __fmul_rn(d, p[1]);
  return __fmul_rn(__fsub_rn(__fadd_rn(__fmul_rn(xhat, p[4]), gf), p[5]), p[2]);
}

template <typename T>
__global__ void __launch_bounds__(kMaxRowThreads, 2)
bn_bwd_apply_rows(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                  long long total, int C, int period, BwdScalars s, int act, float slope) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ float prm[];  // [6][period]
  for (int e = threadIdx.x; e < period; e += blockDim.x) {
    float o[6];
    bwd_channel(s, C, e % C, o);
#pragma unroll
    for (int a = 0; a < 6; ++a) prm[a * period + e] = o[a];
  }
  __syncthreads();
  const RowWalk<V> wk(total, period);
  for (long long v = wk.v0; v < wk.nvec; v += wk.stride) {
    float xv[V], gv[V];
    load_vec(x, v, total, xv);
    load_vec(g, v, total, gv);
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      float p[6][4];
#pragma unroll
      for (int a = 0; a < 6; ++a) chan4(prm + a * period, wk.q0, i, p[a]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj[6] = {p[0][j], p[1][j], p[2][j], p[3][j], p[4][j], p[5][j]};
        xv[i + j] = bwd_dx(xv[i + j], gv[i + j], pj, act, slope);
      }
    }
    store_vec(dx, v, total, xv);
  }
}

template <typename T>
__global__ void __launch_bounds__(kColX * kColY)
bn_bwd_apply_cols(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                  long long M, int C, BwdScalars s, int act, float slope) {
  const int c = blockIdx.x * kColX + threadIdx.x;
  if (c >= C) return;
  float p[6];
  bwd_channel(s, C, c, p);
  for (long long r = static_cast<long long>(blockIdx.y) * kColY + threadIdx.y; r < M;
       r += static_cast<long long>(gridDim.y) * kColY)
    dx[r * C + c] = from_f<T>(bwd_dx(to_f(x[r * C + c]), to_f(g[r * C + c]), p, act, slope));
}

// ---- launches ----

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

// Blocks of a "rows" kernel: at most `cap` (the rows the wrapper allocated for the partials),
// and no more than are resident at once, so that the grid stride is one wave.
template <typename K>
int row_blocks(K kernel, int threads, size_t smem, int cap) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const int resident = per_sm * device_sms();
  return cap < resident ? cap : resident;
}

dim3 col_grid(int C, int rows) { return dim3((C + kColX - 1) / kColX, rows); }
const dim3 kColBlock(kColX, kColY);

int period_of(int V, int C) { return V / gcd_int(V, C) * C; }  // lcm(V, C)

// statistics + finalize; returns the rows of partials written
template <typename T>
void launch_stats(const T* x, long long M, int C, int layout, int threads, int blocks,
                  float* partials, cudaStream_t s, int* rows) {
  constexpr int V = Vec16<T>::N;
  if (layout == kRows) {
    const size_t smem = static_cast<size_t>(threads) * 2 * V * sizeof(float);
    const int g = row_blocks(bn_stats_rows<T>, threads, smem, blocks);
    bn_stats_rows<T><<<g, threads, smem, s>>>(x, M * C, C, period_of(V, C), partials);
    *rows = g;
  } else {
    bn_stats_cols<T><<<col_grid(C, blocks), kColBlock, 0, s>>>(x, M, C, partials);
    *rows = blocks;
  }
}

template <typename T>
void launch_apply(const T* x, T* y, long long M, int C, int layout, int threads, int blocks,
                  const float* st, const float* bias, int act, float slope, cudaStream_t s) {
  constexpr int V = Vec16<T>::N;
  if (layout == kRows) {
    const int period = period_of(V, C);
    const size_t smem = 3 * static_cast<size_t>(period) * sizeof(float);
    const int g = row_blocks(bn_apply_rows<T>, threads, smem, blocks);
    bn_apply_rows<T><<<g, threads, smem, s>>>(x, y, M * C, C, period, st, bias, act, slope);
  } else {
    bn_apply_cols<T><<<col_grid(C, blocks), kColBlock, 0, s>>>(x, y, M, C, st, bias, act,
                                                                slope);
  }
}

template <typename T>
void launch_bwd_reduce(const T* x, const T* g, long long M, int C, int layout, int threads,
                       int blocks, const BwdScalars& sc, int act, float slope, float* partials,
                       cudaStream_t s, int* rows) {
  constexpr int V = Vec16<T>::N;
  if (layout == kRows) {
    const int period = period_of(V, C);
    const size_t prm = 4 * static_cast<size_t>(period);
    const size_t red = static_cast<size_t>(threads) * 2 * V;
    const size_t smem = (prm > red ? prm : red) * sizeof(float);
    const int gb = row_blocks(bn_bwd_reduce_rows<T>, threads, smem, blocks);
    bn_bwd_reduce_rows<T><<<gb, threads, smem, s>>>(x, g, M * C, C, period, sc.mean, sc.rstd,
                                                    sc.w, sc.bias, act, slope, partials);
    *rows = gb;
  } else {
    bn_bwd_reduce_cols<T><<<col_grid(C, blocks), kColBlock, 0, s>>>(
        x, g, M, C, sc.mean, sc.rstd, sc.w, sc.bias, act, slope, partials);
    *rows = blocks;
  }
}

template <typename T>
void launch_bwd_apply(const T* x, const T* g, T* dx, long long M, int C, int layout, int threads,
                      int blocks, const BwdScalars& sc, int act, float slope, cudaStream_t s) {
  constexpr int V = Vec16<T>::N;
  if (layout == kRows) {
    const int period = period_of(V, C);
    const size_t smem = 6 * static_cast<size_t>(period) * sizeof(float);
    const int gb = row_blocks(bn_bwd_apply_rows<T>, threads, smem, blocks);
    bn_bwd_apply_rows<T><<<gb, threads, smem, s>>>(x, g, dx, M * C, C, period, sc, act, slope);
  } else {
    bn_bwd_apply_cols<T><<<col_grid(C, blocks), kColBlock, 0, s>>>(x, g, dx, M, C, sc, act,
                                                                    slope);
  }
}

void launch_finalize(const float* partials, int rows, int C, int mode, float n, const float* w,
                     float eps, const float* mean_in, const float* raw_in, float* out,
                     cudaStream_t s) {
  bn_finalize<<<(C + kColX - 1) / kColX, kColBlock, 0, s>>>(partials, rows, C, mode, n, w, eps,
                                                           mean_in, raw_in, out);
}

template <typename T>
int bn_forward(const void* x, void* y, long long M, int C, int layout, int threads, int blocks,
               float* partials, int mode, float n, const float* w, const float* bias, float eps,
               int act, float slope, const float* mean_in, const float* raw_in, float* st,
               cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  int rows = 0;
  if (mode != kFwdGiven) launch_stats<T>(xt, M, C, layout, threads, blocks, partials, s, &rows);
  const int fin = mode == kFwdSums ? kFinSums : mode == kFwdLocal ? kFinFromSums : kFinGiven;
  launch_finalize(partials, rows, C, fin, n, w, eps, mean_in, raw_in, st, s);
  if (mode != kFwdSums)
    launch_apply<T>(xt, static_cast<T*>(y), M, C, layout, threads, blocks, st, bias, act, slope,
                    s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bn_backward(const void* x, const void* g, void* dx, long long M, int C, int layout,
                int threads, int blocks, float* partials, int mode, const BwdScalars& sc,
                int act, float slope, float* sums, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  if (mode != kBwdApply) {
    int rows = 0;
    launch_bwd_reduce<T>(xt, gt, M, C, layout, threads, blocks, sc, act, slope, partials, s,
                         &rows);
    launch_finalize(partials, rows, C, kFinSums, 0.f, nullptr, 0.f, nullptr, nullptr, sums, s);
  }
  if (mode != kBwdSums)
    launch_bwd_apply<T>(xt, gt, static_cast<T*>(dx), M, C, layout, threads, blocks, sc, act,
                        slope, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch parameters bn_grid chose, checked: a "rows" block is a whole number of channel
// phases and its period of parameters fits the shared memory the kernels ask for.
bool grid_ok(int C, int dtype, int layout, int threads, int blocks) {
  if (C < 1 || blocks < 1) return false;
  if (layout == kCols) return true;
  const int V = dtype == kFloat32 ? 4 : 8;
  const int period = period_of(V, C);
  return layout == kRows && period <= kMaxRowPeriod && threads >= 32 &&
         threads <= kMaxRowThreads && threads % 32 == 0 && threads % (period / V) == 0;
}

}  // namespace sivae

extern "C" {

// Train-mode BatchNorm forward of the [M, C] matrix x into y (same dtype), by `mode`:
// 0: statistics + finalize into st[0:2C] = [sum x, sum x^2] (several ranks: the caller
//    all-reduces them and calls again with mode 2); 1: statistics + finalize into st[0:6C] =
//    [mean, raw_var, var, rstd, mul, k] + apply; 2: finalize from mean_in, raw_in + apply.
// `partials` holds `blocks` rows of [2][C] floats; layout and threads from bn_grid.
int sivae_bn_forward(const void* x, void* y, long long M, int C, int dtype, int layout,
                     int threads, int blocks, float* partials, int mode, float n,
                     const float* w, const float* bias, float eps, int act, float slope,
                     const float* mean_in, const float* raw_in, float* st, void* stream) {
  if (!sivae::grid_ok(C, dtype, layout, threads, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sivae::kFloat32)
    return sivae::bn_forward<float>(x, y, M, C, layout, threads, blocks, partials, mode, n, w,
                                    bias, eps, act, slope, mean_in, raw_in, st, s);
  return sivae::bn_forward<__nv_bfloat16>(x, y, M, C, layout, threads, blocks, partials, mode, n,
                                          w, bias, eps, act, slope, mean_in, raw_in, st, s);
}

// Train-mode BatchNorm backward by `mode`: 0: sums[0:2C] = [sum gf * xhat, sum gf] (the
// weight's and the bias's gradients); 1: those, then dx from them; 2: dx from the given sums
// (all-reduced over the ranks). The count n is n_dev[0] where n_dev is given, else n.
int sivae_bn_backward(const void* x, const void* g, void* dx, long long M, int C, int dtype,
                      int layout, int threads, int blocks, float* partials, int mode,
                      const float* mean, const float* rstd, const float* k, const float* w,
                      const float* bias, int act, float slope, float n, const float* n_dev,
                      float* sums, void* stream) {
  if (!sivae::grid_ok(C, dtype, layout, threads, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sivae::BwdScalars sc{mean, rstd, w, bias, k, sums, n_dev, n};
  if (dtype == sivae::kFloat32)
    return sivae::bn_backward<float>(x, g, dx, M, C, layout, threads, blocks, partials, mode, sc,
                                     act, slope, sums, s);
  return sivae::bn_backward<__nv_bfloat16>(x, g, dx, M, C, layout, threads, blocks, partials,
                                           mode, sc, act, slope, sums, s);
}

}  // extern "C"
