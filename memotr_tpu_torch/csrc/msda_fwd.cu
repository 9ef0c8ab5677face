// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ms_deform_attn_pallas` (memotr_tpu/ops/msda_pallas.py,
// `_kernel` / `_forward`, the pallas_call at msda_pallas.py:187).  That kernel
// rewrites bilinear sampling as tent-weight matmuls because a TPU core cannot
// gather rows from VMEM.  A GPU gathers freely, so this is the reference
// im2col form (ms_deform_attn_im2col_bilinear): every (batch, query, head)
// reads its L*P samples x 4 bilinear corners straight from the value table.
//
//   out[b,q,m,d] = sum_l sum_p aw[b,q,m,l,p] *
//                  bilinear(value_l[b,:,:,m,d], x*W_l - 0.5, y*H_l - 0.5)
//
// Corners outside the map contribute zero (grid_sample padding "zeros").
//
// What bounds it.  At the encoder shape of the main path (B=1, Lq = sum HW =
// 25,512, M=8, L=4, P=4, D=32, bf16) one call gathers
// 25,512*8*16*4*32*2 B ~ 836 MB from a value table of 25,512*256*2 B ~ 13 MB,
// which fits in the 50 MB L2.  The arithmetic is ~2 FLOP per gathered element,
// so the kernel is bound by L2 bandwidth and latency of the gathers, not by
// HBM and not by the tensor cores.
//
// Design.  A group of G = min(D, 32) lanes owns one (b, q, m) and a 32-channel
// slice of D (lane = channel, so a corner read by a group is one contiguous
// G-element row: 64 B for bf16 at D=32).  The group first spreads the sample
// metadata over its lanes: lane j reads loc/aw of sample s0+j once and turns
// it into four (row, weight) corner pairs, with the attention weight folded
// in and out-of-bounds corners marked by row -1.  The group then walks the
// samples, broadcasting each sample's corners with __shfl_sync, and every
// lane accumulates its channel in f32.  The result is written in the value
// dtype.  Level shapes and start rows come in a small int32 device table
// (L, 3) = [H, W, start].
//
// Interface: plain C, loaded with ctypes; the caller allocates `out` and owns
// the stream.  Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int G>
__global__ void __launch_bounds__(256)
msda_fwd_kernel(const T* __restrict__ value, const int* __restrict__ shapes,
                const float* __restrict__ loc, const float* __restrict__ aw,
                T* __restrict__ out, int S, int Lq, int M, int D, int L, int P,
                long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // Every lane of a warp takes part in the shuffles, so threads past the end
  // run the loop on a clamped index and only skip their loads and store.
  const bool active = t < total;
  const long long tt = active ? t : 0;
  const int j = (int)(tt % G);
  const long long g = tt / G;
  const int chunks = D / G;
  const long long bqm = g / chunks;
  const int d = (int)(g % chunks) * G + j;
  const int m = (int)(bqm % M);
  const long long b = bqm / ((long long)Lq * M);
  const int LP = L * P;

  const float* loc_q = loc + bqm * LP * 2;
  const float* aw_q = aw + bqm * LP;
  const long long row_stride = (long long)M * D;
  const T* val = value + b * (long long)S * row_stride + (long long)m * D + d;

  float acc = 0.f;
  for (int s0 = 0; s0 < LP; s0 += G) {
    int off[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    const int s = s0 + j;
    if (active && s < LP) {
      const int l = s / P;
      const int h = __ldg(shapes + 3 * l);
      const int w = __ldg(shapes + 3 * l + 1);
      const int start = __ldg(shapes + 3 * l + 2);
      const float a = __ldg(aw_q + s);
      const float px = __ldg(loc_q + 2 * s) * (float)w - 0.5f;
      const float py = __ldg(loc_q + 2 * s + 1) * (float)h - 0.5f;
      // outside (-1, size) every corner is out of bounds (and NaN fails too)
      if (px > -1.f && py > -1.f && px < (float)w && py < (float)h) {
        const float x0f = floorf(px), y0f = floorf(py);
        const float fx = px - x0f, fy = py - y0f;
        const int x0 = (int)x0f, y0 = (int)y0f;
        const float cw[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy),
                             (1.f - fx) * fy, fx * fy};
        const int cx[4] = {x0, x0 + 1, x0, x0 + 1};
        const int cy[4] = {y0, y0, y0 + 1, y0 + 1};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cx[c] >= 0 && cx[c] < w && cy[c] >= 0 && cy[c] < h) {
            off[c] = start + cy[c] * w + cx[c];
            wt[c] = cw[c] * a;
          }
        }
      }
    }
    const int n = min(G, LP - s0);
    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = __shfl_sync(0xffffffffu, off[c], k, G);
        const float wk = __shfl_sync(0xffffffffu, wt[c], k, G);
        if (active && o >= 0) acc += wk * to_f32<T>(val[(long long)o * row_stride]);
      }
    }
  }
  if (active) out[bqm * D + d] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch(const void* value, const void* shapes, const void* loc,
                   const void* aw, void* out, int B, int S, int Lq, int M,
                   int D, int L, int P, cudaStream_t stream) {
  const long long total = (long long)B * Lq * M * D;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  const T* v = static_cast<const T*>(value);
  const int* sh = static_cast<const int*>(shapes);
  const float* lc = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  T* o = static_cast<T*>(out);
  const int G = D < 32 ? D : 32;
  switch (G) {
    case 4:
      msda_fwd_kernel<T, 4><<<(unsigned)blocks, threads, 0, stream>>>(
          v, sh, lc, a, o, S, Lq, M, D, L, P, total);
      break;
    case 8:
      msda_fwd_kernel<T, 8><<<(unsigned)blocks, threads, 0, stream>>>(
          v, sh, lc, a, o, S, Lq, M, D, L, P, total);
      break;
    case 16:
      msda_fwd_kernel<T, 16><<<(unsigned)blocks, threads, 0, stream>>>(
          v, sh, lc, a, o, S, Lq, M, D, L, P, total);
      break;
    case 32:
      msda_fwd_kernel<T, 32><<<(unsigned)blocks, threads, 0, stream>>>(
          v, sh, lc, a, o, S, Lq, M, D, L, P, total);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 4, 8, 16 or a multiple of 32
// (the Python wrapper checks this and every shape before the call).
extern "C" int msda_fwd(const void* value, const void* shapes, const void* loc,
                        const void* aw, void* out, int dtype, int B, int S,
                        int Lq, int M, int D, int L, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(value, shapes, loc, aw, out, B, S, Lq, M, D, L,
                              P, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(value, shapes, loc, aw, out, B, S, Lq,
                                      M, D, L, P, s);
  return (int)cudaErrorInvalidValue;
}
