// Multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// The gradient of msda_fwd.cu's function.  In the JAX package it is the
// custom VJP of `ms_deform_attn_pallas` (memotr_tpu/ops/msda_pallas.py,
// `_bwd` at :237): `jax.vjp` of `ms_deform_attn_xla`, which XLA compiles
// into gathers and scatter-adds.  Here it is the reference MeMOTR's
// `ms_deform_attn_backward` form: one pass over the samples that re-reads
// the four bilinear corners of each and produces all three gradients.
//
// With g = grad_out[b,q,m,:], a = aw[b,q,m,l,p], the sample at pixel
// (px, py) = (x W_l - 0.5, y H_l - 0.5), fx = px - floor(px), fy likewise,
// corner weights w00 = (1-fx)(1-fy), w01 = fx(1-fy), w10 = (1-fx)fy,
// w11 = fx fy, and v_c the corner's value row (zero where the corner lies
// outside the map, as grid_sample's zero padding has it):
//
//   grad_value[b, row_c, m, :] += a w_c g          (valid corners only)
//   grad_aw[b,q,m,l,p]          = sum_d g[d] sum_c w_c v_c[d]
//   grad_loc[b,q,m,l,p,0]       = W_l a sum_d g[d] ((1-fy)(v01-v00) + fy(v11-v10))
//   grad_loc[b,q,m,l,p,1]       = H_l a sum_d g[d] ((1-fx)(v10-v00) + fx(v11-v01))
//
// floor() has zero derivative.  A sample with every corner outside the map
// (or a NaN location) gets zero gradients, as in the forward.
//
// Thread mapping, as in the forward: a group of TPG threads owns one
// (b, q, m) and each thread handles 16-byte chunks of the D channels (VEC
// channels a chunk: 8 bf16 or 4 float32), so a thread reads a corner row's
// chunk with one load.  TPG is a power of two (at most 8) that divides the
// chunk count; a thread walks D / VEC / TPG chunks.  Each thread computes
// its samples' corners and weights itself.  The partial sums of grad_aw and
// grad_loc over the group's channels meet by shuffles; the group's first
// thread stores them.  With SPLIT > 1 (too few (b, q, m) to fill the card:
// the decoder) the L*P samples are dealt over SPLIT sub-groups of one warp,
// each owning its samples outright.
//
// grad_value is a scatter: every valid corner adds a w_c g to a value row
// that other samples also hit, so it goes by float32 atomics into a float32
// (B, S, M, D) buffer the caller zeroes (and casts to the value dtype
// afterwards): bf16 atomics would round every partial sum.  The sum order
// depends on the run.  Each thread adds its VEC channels of a corner with
// sm_90's vector `atomicAdd(float4*, float4)`, four channels an
// instruction.
//
// What bounds it.  At the encoder shape of the training canvas (B=1, Lq =
// S = 28,560, M=8, L=4, P=4, D=32, bf16) the bytes a call must move are
// ~130 MB (0.04 ms at 3.35 TB/s) and its float32 arithmetic ~3.7 GFLOP
// (0.056 ms at 67 TFLOP/s), but it scatters up to 468 M float32 adds
// (117 M float4 atomics) into a 29 MB buffer that stays in the 50 MB L2:
// the L2's atomic units are the limit.  Vector atomics cut their
// instructions fourfold (3.4x faster than one float a thread on the H100,
// PERF.md); fewer of them (summing neighbouring samples' shared corners
// first, or sorting samples by row) is later work.
//
// Interface: plain C, loaded with ctypes; the caller allocates every output
// and owns the stream.  Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// VEC channels of a row, as float32.
template <typename T, int VEC> struct Row;

template <> struct Row<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};

template <> struct Row<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <> struct Row<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[4]) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
msda_bwd_kernel(const T* __restrict__ value, const int* __restrict__ shapes,
                const float* __restrict__ loc, const float* __restrict__ aw,
                const T* __restrict__ grad_out, float* __restrict__ grad_value,
                float* __restrict__ grad_loc, float* __restrict__ grad_aw,
                int S, int Lq, int M, int D, int L, int P, int tpg, int split,
                long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // Every lane of a warp takes part in the shuffles, so threads past the
  // end run on a clamped index and only skip their atomics and stores.
  const bool active = t < total;
  const long long tt = active ? t : 0;
  const int c = (int)(tt % tpg);                 // this thread's chunks
  const long long u = tt / tpg;
  const int sub = (int)(u % split);              // this thread's samples
  const long long bqm = u / split;               // (b, q, m), heads fastest
  const int m = (int)(bqm % M);
  const long long b = bqm / ((long long)Lq * M);
  const int LP = L * P;
  const int nch = D / VEC / tpg;

  const float* loc_q = loc + bqm * LP * 2;
  const float* aw_q = aw + bqm * LP;
  const T* g_q = grad_out + bqm * D;
  const long long row_stride = (long long)M * D;
  const long long base = b * (long long)S * row_stride + (long long)m * D;
  const T* val = value + base;
  float* gval = grad_value + base;

  // the same trip count in every lane of the warp (the shuffles below)
  for (int s0 = 0; s0 < LP; s0 += split) {
    const int s = s0 + sub;
    const bool has = s < LP;
    const int sc = has ? s : 0;
    const int l = sc / P;
    const int h = __ldg(shapes + 3 * l), w = __ldg(shapes + 3 * l + 1);
    const int start = __ldg(shapes + 3 * l + 2);
    const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_q + 2 * sc));
    const float a = __ldg(aw_q + sc);
    const float px = xy.x * (float)w - 0.5f;
    const float py = xy.y * (float)h - 0.5f;
    float p_aw = 0.f, p_x = 0.f, p_y = 0.f;
    // outside (-1, size) every corner is out of bounds (and NaN fails too)
    if (has && px > -1.f && py > -1.f && px < (float)w && py < (float)h) {
      const float x0f = floorf(px), y0f = floorf(py);
      const float fx = px - x0f, fy = py - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      const bool xin0 = x0 >= 0, xin1 = x0 + 1 < w;
      const bool yin0 = y0 >= 0, yin1 = y0 + 1 < h;
      const float wt[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy),
                           (1.f - fx) * fy, fx * fy};
      const bool in[4] = {xin0 && yin0, xin1 && yin0, xin0 && yin1,
                          xin1 && yin1};
      const long long r0 = start + (long long)y0 * w + x0;
      const long long rows[4] = {r0, r0 + 1, r0 + w, r0 + w + 1};
      for (int k = 0; k < nch; ++k) {
        const int ch = (k * tpg + c) * VEC;
        float g[VEC];
        Row<T, VEC>::load(g_q + ch, g);
        float v[4][VEC];
#pragma unroll
        for (int q = 0; q < 4; ++q) {          // the four loads in flight
          if (in[q]) {
            Row<T, VEC>::load(val + rows[q] * row_stride + ch, v[q]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[q][i] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float samp = wt[0] * v[0][i] + wt[1] * v[1][i] +
                             wt[2] * v[2][i] + wt[3] * v[3][i];
          p_aw = fmaf(g[i], samp, p_aw);
          p_x = fmaf(g[i], (1.f - fy) * (v[1][i] - v[0][i]) +
                               fy * (v[3][i] - v[2][i]), p_x);
          p_y = fmaf(g[i], (1.f - fx) * (v[2][i] - v[0][i]) +
                               fx * (v[3][i] - v[1][i]), p_y);
        }
        if (active) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (!in[q]) continue;
            const float aq = a * wt[q];
            float* dst = gval + rows[q] * row_stride + ch;
            // sm_90's vector atomic: four channels in one instruction
#pragma unroll
            for (int i = 0; i < VEC; i += 4)
              atomicAdd(reinterpret_cast<float4*>(dst + i),
                        make_float4(aq * g[i], aq * g[i + 1], aq * g[i + 2],
                                    aq * g[i + 3]));
          }
        }
      }
    }
    // the group's lanes are tpg-aligned and contiguous
    for (int off = 1; off < tpg; off <<= 1) {
      p_aw += __shfl_xor_sync(0xffffffffu, p_aw, off);
      p_x += __shfl_xor_sync(0xffffffffu, p_x, off);
      p_y += __shfl_xor_sync(0xffffffffu, p_y, off);
    }
    if (active && has && c == 0) {
      const long long o = bqm * LP + s;
      grad_aw[o] = p_aw;
      *reinterpret_cast<float2*>(grad_loc + 2 * o) =
          make_float2(p_x * a * (float)w, p_y * a * (float)h);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename T, int VEC>
cudaError_t launch(const void* value, const void* shapes, const void* loc,
                   const void* aw, const void* grad_out, void* grad_value,
                   void* grad_loc, void* grad_aw, int B, int S, int Lq, int M,
                   int D, int L, int P, cudaStream_t stream) {
  const long long pairs = (long long)B * Lq * M;
  if (pairs == 0) return cudaSuccess;
  // the largest power of two (at most 8) that divides the chunk count
  const int chunks = D / VEC;
  int tpg = 1;
  while (tpg < 8 && chunks % (tpg * 2) == 0) tpg *= 2;
  // Split the samples when the pairs alone would fill less than half the
  // card's resident threads (2048 an SM), as the forward does.
  int split = 1;
  const long long half_card = (long long)sm_count() * 1024;
  while (split * 2 <= 32 / tpg && split * 2 <= L * P &&
         pairs * tpg * split * 2 <= half_card)
    split *= 2;
  const long long total = pairs * tpg * split;
  const long long blocks = (total + THREADS - 1) / THREADS;
  msda_bwd_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(shapes),
      static_cast<const float*>(loc), static_cast<const float*>(aw),
      static_cast<const T*>(grad_out), static_cast<float*>(grad_value),
      static_cast<float*>(grad_loc), static_cast<float*>(grad_aw), S, Lq, M,
      D, L, P, tpg, split, total);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (value and grad_out).  grad_value is
// float32 (B, S, M, D), zeroed by the caller; grad_loc (B, Lq, M, L, P, 2)
// and grad_aw (B, Lq, M, L, P) float32, every element written.  D must be
// 4, 8, 16 or a multiple of 32 (the Python wrapper checks every shape).
extern "C" int msda_bwd(const void* value, const void* shapes, const void* loc,
                        const void* aw, const void* grad_out, void* grad_value,
                        void* grad_loc, void* grad_aw, int dtype, int B, int S,
                        int Lq, int M, int D, int L, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, 4>(value, shapes, loc, aw, grad_out, grad_value,
                                 grad_loc, grad_aw, B, S, Lq, M, D, L, P, s);
  if (dtype == 1) {
    if (D == 4)
      return (int)launch<__nv_bfloat16, 4>(value, shapes, loc, aw, grad_out,
                                           grad_value, grad_loc, grad_aw, B,
                                           S, Lq, M, D, L, P, s);
    return (int)launch<__nv_bfloat16, 8>(value, shapes, loc, aw, grad_out,
                                         grad_value, grad_loc, grad_aw, B, S,
                                         Lq, M, D, L, P, s);
  }
  return (int)cudaErrorInvalidValue;
}
