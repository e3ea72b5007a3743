// Eval-mode BatchNorm, optional residual add and ReLU in one pass.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it into the convolution's epilogue. On the H100 the port's eager
// composition (models/resnet.py `_BatchNorm.forward`, then `F.relu`, and
// `y + x` in a block's second site) costs 9-11 launches and about 40 bytes
// of traffic per element at each of the net's BatchNorm sites, and led the
// self-play profile. This kernel does the same arithmetic in one launch:
//
//   y   = round_T(((x - mean[c]) * f[c]) + bias[c]),
//         f[c] = rsqrt(var[c] + eps) * weight[c]
//   y   = round_T(y + residual)          (when a residual is given)
//   out = isnan(y) ? y : max(y, 0)
//
// in float32, with T the tensor's dtype (bf16 or float32; round_T is the
// identity for float32). Each step is one IEEE operation rounded to nearest
// (`__fsub_rn`, `__fmul_rn`, `__fadd_rn`: no FMA contraction), in the eager
// path's order, and `rsqrtf` is what `torch.rsqrt` calls on the card, so
// the output is the eager output bit for bit. ReLU is PyTorch's
// `clamp_min(0)`: NaN passes unchanged, otherwise `fmaxf(y, 0)`.
//
// Layouts: element i of the flat buffer has channel (i / div) % C, with
// div = 1 for channels-last memory and div = H*W for NCHW-contiguous; the
// output has the input's layout.
//
// What bounds it on an H100: bytes. A trunk site at C2's shape (16,384 x
// 128 x 8 x 8 bf16) reads 268 MB and writes 268 MB (another 268 MB read
// with the residual): 0.16-0.24 ms at 3.35 TB/s; its 5-8 float operations
// an element are far below the card's rate. So each thread moves 16 bytes
// a load (8 bf16 or 4 float32) with the streaming cache hint, four vectors
// in flight per loop step, in a grid-stride loop over one wave of resident
// 256-thread blocks (on an H100 at the trunk's shapes: 76-82% of 3.35
// TB/s; 72-81% with plain loads and stores). The grid is
// chosen so that the loop's stride is a multiple of the channel period (C,
// or C*H*W); then a thread's elements keep their channels for the whole
// loop, and it loads its channels' mean, factor and bias once into
// registers before it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors in flight per thread and loop step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, bool RES>
__device__ __forceinline__ T bn_act_one(T x, T r, float mean, float f,
                                        float bias) {
  T y = from_f32<T>(
      __fadd_rn(__fmul_rn(__fsub_rn(to_f32(x), mean), f), bias));
  if (RES) y = from_f32<T>(__fadd_rn(to_f32(y), to_f32(r)));
  const float yf = to_f32(y);
  return isnan(yf) ? y : from_f32<T>(fmaxf(yf, 0.0f));
}

template <typename T, int VEC, bool RES>
__device__ __forceinline__ Vec<T, VEC> bn_act_vec(const Vec<T, VEC>& a,
                                                  const Vec<T, VEC>& r,
                                                  const float* m,
                                                  const float* f,
                                                  const float* b) {
  Vec<T, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    o.v[k] = bn_act_one<T, RES>(a.v[k], r.v[k], m[k], f[k], b[k]);
  return o;
}

// 16-byte vectors load and store with the streaming hint (evict first):
// each byte is read once and written once
template <typename V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (sizeof(V) == 16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    V v;
    memcpy(&v, &u, sizeof(v));
    return v;
  } else {
    return *p;
  }
}

template <typename V>
__device__ __forceinline__ void store(V* p, const V& v) {
  if constexpr (sizeof(V) == 16) {
    uint4 u;
    memcpy(&u, &v, sizeof(u));
    __stcs(reinterpret_cast<uint4*>(p), u);
  } else {
    *p = v;
  }
}

template <typename T, int VEC, bool RES>
__global__ void __launch_bounds__(kThreads)
    bn_act_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  T* __restrict__ out, const float* __restrict__ mean,
                  const float* __restrict__ var,
                  const float* __restrict__ weight,
                  const float* __restrict__ bias, float eps, int64_t n,
                  int channels, int64_t div) {
  using V = Vec<T, VEC>;
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  float m[VEC], f[VEC], b[VEC];
  // 32-bit channel arithmetic (the launch keeps the grid's elements under
  // 2^31), so this loop unrolls and the arrays stay in registers
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int c = (int(t) * VEC + k) / int(div) % channels;
    m[k] = mean[c];
    f[k] = __fmul_rn(rsqrtf(__fadd_rn(var[c], eps)), weight[c]);
    b[k] = bias[c];
  }
  const int64_t nvec = n / VEC;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* rv = reinterpret_cast<const V*>(res);
  V* ov = reinterpret_cast<V*>(out);
  int64_t i = t;
  // kUnroll vectors in flight per step, then one at a time
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    V a[kUnroll], r[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = load(xv + i + u * stride);
      if (RES) r[u] = load(rv + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      store(ov + i + u * stride, bn_act_vec<T, VEC, RES>(a[u], r[u], m, f, b));
  }
  for (; i < nvec; i += stride) {
    V r{};
    if (RES) r = load(rv + i);
    store(ov + i, bn_act_vec<T, VEC, RES>(load(xv + i), r, m, f, b));
  }
  // the ragged tail (n % VEC elements) falls to the thread whose next
  // vector it would be, so its channels are the ones loaded above
  if (t == nvec % stride) {
    for (int k = 0; k < n - nvec * VEC; ++k) {
      const int64_t e = nvec * VEC + k;
      out[e] = bn_act_one<T, RES>(x[e], RES ? res[e] : T(), m[k], f[k],
                                  b[k]);
    }
  }
}

int64_t gcd(int64_t a, int64_t b) {
  while (b) {
    const int64_t r = a % b;
    a = b;
    b = r;
  }
  return a;
}

template <typename T, int VEC, bool RES>
int resident_blocks_per_sm() {
  static const int blocks = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, bn_act_kernel<T, VEC, RES>, kThreads, 0) != cudaSuccess ||
        n < 1)
      n = 1;
    return n;
  }();
  return blocks;
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* res, void* out,
                   const float* mean, const float* var, const float* weight,
                   const float* bias, float eps, int64_t n, int channels,
                   int64_t div, int sms, cudaStream_t stream) {
  // one wave of resident blocks (or enough to cover n once), rounded up to
  // a multiple of `unit` so that the loop's stride in elements is a
  // multiple of the channel period
  const bool has_res = res != nullptr;
  const int64_t per_block = int64_t(kThreads) * VEC;
  const int64_t period = div * channels;
  const int64_t unit = period / gcd(period, per_block);
  int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t full =
      int64_t(sms) * (has_res ? resident_blocks_per_sm<T, VEC, true>()
                              : resident_blocks_per_sm<T, VEC, false>());
  if (blocks > full) blocks = full;
  if (blocks < 1) blocks = 1;
  blocks = (blocks + unit - 1) / unit * unit;
  if (blocks * per_block >= (int64_t(1) << 31) || div >= (int64_t(1) << 31))
    return cudaErrorInvalidConfiguration;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (has_res)
    bn_act_kernel<T, VEC, true><<<unsigned(blocks), kThreads, 0, stream>>>(
        xt, rt, ot, mean, var, weight, bias, eps, n, channels, div);
  else
    bn_act_kernel<T, VEC, false><<<unsigned(blocks), kThreads, 0, stream>>>(
        xt, rt, ot, mean, var, weight, bias, eps, n, channels, div);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. res may be null. div: 1 for channels-last,
// H*W for NCHW-contiguous. Returns the CUDA error of the launch (0: none).
extern "C" int azr_bn_act(const void* x, const void* res, void* out,
                          const float* mean, const float* var,
                          const float* weight, const float* bias, float eps,
                          int64_t n, int channels, int64_t div, int dtype,
                          int sms, void* stream) {
  if (n <= 0) return 0;
  const bool vec = aligned16(x) && aligned16(out) &&
                   (res == nullptr || aligned16(res));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vec ? launch<__nv_bfloat16, 8>(x, res, out, mean, var, weight,
                                         bias, eps, n, channels, div, sms, s)
              : launch<__nv_bfloat16, 1>(x, res, out, mean, var, weight,
                                         bias, eps, n, channels, div, sms, s);
  else
    err = vec ? launch<float, 4>(x, res, out, mean, var, weight, bias, eps, n,
                                 channels, div, sms, s)
              : launch<float, 1>(x, res, out, mean, var, weight, bias, eps, n,
                                 channels, div, sms, s);
  return int(err);
}
