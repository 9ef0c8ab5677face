// Convolution tail, for Hopper (sm_90a): bias, residual and ReLU in one pass,
// in place.
//
//   y[n, c, h, w] = act(y[n, c, h, w] + bias[c] (+ identity[n, c, h, w]))
//
// y and identity are channels_last (N, C, H, W) maps in float32 or bfloat16,
// so memory holds N*H*W rows of C channels; bias is float32 (C,).  The sum is
// taken in float32, in that order, and rounded once; act is ReLU or nothing.
//
// Replaces no TPU kernel.  XLA fuses the frozen BatchNorm's affine, the
// residual add and the ReLU of the JAX package's ResNet-50
// (memotr_tpu/models/resnet.py) into the convolution's epilogue.  The port's
// convolutions are cuDNN's, so without this kernel PyTorch runs each of
// those as a pass of its own over the activation.  With the BatchNorm folded
// into the convolution's weight and bias (models/resnet.py: fold), the
// bias, the residual and the ReLU are what is left, and this kernel does
// them in one pass.
//
// What bounds it.  About one float32 add per byte moved, so device memory:
// at the layer1 conv3 shape of the main path (B=8, 200x384, C=256, bf16,
// with identity) a call reads y and identity and writes y, 944 MB, 0.28 ms
// at 3.35 TB/s.
//
// Design.  A thread moves 16 bytes at a time (8 bf16 or 4 float32 channels
// of one row) with 16-byte loads and stores.  The launcher gives blocks a
// multiple of C*size/16 threads, so the grid's stride over 16-byte vectors
// is a multiple of a row's vectors and a thread meets the same channels on
// every step: their bias is read once into registers.  Each step issues
// UNROLL loads of y (and of identity) before any arithmetic, to keep enough
// bytes in flight; the grid is as many blocks as the SMs hold at once, which
// walk the map in a grid-stride loop.
//
// Interface: plain C, loaded with ctypes; the caller checks layouts and
// alignment and owns the stream.  Returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 4;
constexpr int MAX_THREADS = 1024;

// 16 bytes of T as float32 values.
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};

// n: 16-byte vectors in y; groups: vectors in a row of C channels.
template <typename T, bool IDENTITY, bool RELU>
__global__ void __launch_bounds__(MAX_THREADS)
conv_tail_kernel(uint4* __restrict__ y, const uint4* __restrict__ identity,
                 const float* __restrict__ bias, int64_t n, int groups) {
  using P = Pack<T>;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // stride is a multiple of groups, so this thread's channels never change
  const float4* bp =
      reinterpret_cast<const float4*>(bias + (i % groups) * P::N);
  float b[P::N];
#pragma unroll
  for (int k = 0; k < P::N / 4; ++k) {
    const float4 f = __ldg(bp + k);
    b[4 * k] = f.x;
    b[4 * k + 1] = f.y;
    b[4 * k + 2] = f.z;
    b[4 * k + 3] = f.w;
  }
  for (; i < n; i += UNROLL * stride) {
    uint4 ry[UNROLL], ri[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t j = i + u * stride;
      if (j < n) {
        ry[u] = y[j];
        if (IDENTITY) ri[u] = __ldg(identity + j);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t j = i + u * stride;
      if (j < n) {
        float v[P::N];
        P::unpack(ry[u], v);
        float w[P::N];
        if (IDENTITY) P::unpack(ri[u], w);
#pragma unroll
        for (int c = 0; c < P::N; ++c) {
          float s = v[c] + b[c];
          if (IDENTITY) s += w[c];
          if (RELU) s = s < 0.f ? 0.f : s;  // NaN stays NaN, as torch.relu
          v[c] = s;
        }
        y[j] = P::pack(v);
      }
    }
  }
}

template <typename T, bool IDENTITY, bool RELU>
cudaError_t launch(void* y, const void* identity, const void* bias, int64_t n,
                   int groups, cudaStream_t stream) {
  auto kernel = conv_tail_kernel<T, IDENTITY, RELU>;
  const int threads = groups <= 256 ? (256 / groups) * groups : groups;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return err;
  const int64_t need = (n + (int64_t)threads * UNROLL - 1) /
                       ((int64_t)threads * UNROLL);
  const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(need < most ? need : most);
  kernel<<<blocks, threads, 0, stream>>>(
      static_cast<uint4*>(y), static_cast<const uint4*>(identity),
      static_cast<const float*>(bias), n, groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(void* y, const void* identity, const void* bias,
                     int64_t n, int groups, int relu, cudaStream_t s) {
  if (identity != nullptr)
    return relu ? launch<T, true, true>(y, identity, bias, n, groups, s)
                : launch<T, true, false>(y, identity, bias, n, groups, s);
  return relu ? launch<T, false, true>(y, identity, bias, n, groups, s)
              : launch<T, false, false>(y, identity, bias, n, groups, s);
}

}  // namespace

// y, identity (null for none): channels_last maps, 16-byte aligned; bias:
// float32 (C,), 16-byte aligned; dtype 0 float32, 1 bfloat16; n: 16-byte
// vectors in y; groups: vectors in a row (C * size / 16, at most 1024).
extern "C" int conv_tail(void* y, const void* identity, const void* bias,
                         int dtype, long long n, int groups, int relu,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || groups <= 0 || groups > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(y, identity, bias, n, groups, relu, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(y, identity, bias, n, groups, relu, s);
  return (int)cudaErrorInvalidValue;
}
