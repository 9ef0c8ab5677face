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
// Corners outside the map contribute zero (grid_sample padding "zeros"),
// and a NaN location falls outside.
//
// What bounds it.  At the encoder shape of the main path (B=1, Lq = sum HW =
// 25,512, M=8, L=4, P=4, D=32, bf16) the bytes a call must move from and to
// device memory are value 13 MB + loc 26 MB + aw 13 MB + out 13 MB = 65 MB:
// 0.0195 ms at 3.35 TB/s (the HBM bound chip_smoke.py reports).  But the
// call gathers 25,512*8*16*4 corner rows of 64 B = 836 MB, from a value
// table that sits in the 50 MB L2.  So the real limit is the L2: its
// bandwidth (roughly 5.5-7 TB/s on an H100, so 0.12-0.15 ms for 836 MB) and
// the number of load instructions and 32-byte sectors the gathers take.
// The arithmetic (~2 FLOP per gathered element) is far from any limit.
//
// Design.  A corner row of one head is D contiguous elements (64 B in bf16
// at D=32).  A group of TPG = D / VEC threads owns one (b, q, m), and each
// thread loads VEC channels of a corner with one 16-byte load (8 bf16 or 4
// float32; 8 bytes for bf16 at D=4): 4 threads a (b, q, m) in bf16 at D=32,
// 8x fewer load instructions than one channel a lane.  Every thread computes
// its samples' corner rows and weights itself from float2 / float4 reads of
// loc and aw (the group's threads read the same addresses, one broadcast),
// so no sample metadata crosses lanes.  Neighbouring groups take the heads
// of one query: their loc and aw rows and their output row are contiguous.
// Tried on the H100 against neighbouring queries of one head (whose samples
// share L1 lines), this order was a little faster at the encoder shape,
// where the time is, and a little slower at the decoder's.  Each thread
// accumulates its VEC channels in f32 and rounds once.  When B*Lq*M is too small to fill the card (the decoder: 364
// queries), the launcher splits each (b, q, m)'s L*P samples over SPLIT
// sub-groups in the same warp and sums them with shuffles.  Level shapes
// and start rows come in a small int32 device table (L, 3) = [H, W, start].
//
// Interface: plain C, loaded with ctypes; the caller allocates `out` and owns
// the stream.  Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// VEC channels of a value row, as float32.
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

template <typename T, int VEC> struct Store;

template <int VEC> struct Store<float, VEC> {
  __device__ __forceinline__ static void store(float* p, const float (&v)[VEC]) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
};

template <int VEC> struct Store<__nv_bfloat16, VEC> {
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[VEC]) {
    __nv_bfloat162 h[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    if (VEC == 8)
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
    else
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  }
};

// Adds sample (x, y) in [0, 1] of level (h, w, start), attention weight a,
// to acc: its four bilinear corners' VEC channels at val (this thread's
// head and channels of row 0), rows row_stride apart.
template <typename T, int VEC>
__device__ __forceinline__ void add_sample(float (&acc)[VEC], const T* val,
                                           long long row_stride, float lx,
                                           float ly, float a, int h, int w,
                                           int start) {
  const float px = lx * (float)w - 0.5f;
  const float py = ly * (float)h - 0.5f;
  // outside (-1, size) every corner is out of bounds (and NaN fails too)
  if (!(px > -1.f && py > -1.f && px < (float)w && py < (float)h)) return;
  const float x0f = floorf(px), y0f = floorf(py);
  const float fx = px - x0f, fy = py - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const bool xin0 = x0 >= 0, xin1 = x0 + 1 < w;
  const bool yin0 = y0 >= 0, yin1 = y0 + 1 < h;
  const float wt[4] = {(1.f - fx) * (1.f - fy) * a, fx * (1.f - fy) * a,
                       (1.f - fx) * fy * a, fx * fy * a};
  const bool in[4] = {xin0 && yin0, xin1 && yin0, xin0 && yin1, xin1 && yin1};
  const long long r0 = start + (long long)y0 * w + x0;
  const long long rows[4] = {r0, r0 + 1, r0 + w, r0 + w + 1};
  float v[4][VEC];
#pragma unroll
  for (int c = 0; c < 4; ++c) {           // the four loads in flight together
    if (in[c]) Row<T, VEC>::load(val + rows[c] * row_stride, v[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!in[c]) continue;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wt[c], v[c][i], acc[i]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
msda_fwd_kernel(const T* __restrict__ value, const int* __restrict__ shapes,
                const float* __restrict__ loc, const float* __restrict__ aw,
                T* __restrict__ out, int S, int Lq, int M, int D, int L, int P,
                int split, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // With split > 1 every lane of a warp takes part in the shuffles, so
  // threads past the end run on a clamped index and only skip their store.
  const bool active = t < total;
  const long long tt = active ? t : 0;
  const int tpg = D / VEC;
  const int c = (int)(tt % tpg);                 // this thread's channels
  const long long u = tt / tpg;
  const int sub = (int)(u % split);              // this thread's samples
  const long long bqm = u / split;               // (b, q, m), heads fastest
  const int m = (int)(bqm % M);
  const long long b = bqm / ((long long)Lq * M);
  const int LP = L * P;

  const float* loc_q = loc + bqm * LP * 2;
  const float* aw_q = aw + bqm * LP;
  const long long row_stride = (long long)M * D;
  const T* val = value + b * (long long)S * row_stride + (long long)m * D + c * VEC;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (split == 1 && (LP & 3) == 0) {
    // four samples at a time: loc as two float4, aw as one
    for (int s = 0; s < LP; s += 4) {
      const float4 l01 = __ldg(reinterpret_cast<const float4*>(loc_q + 2 * s));
      const float4 l23 = __ldg(reinterpret_cast<const float4*>(loc_q + 2 * s + 4));
      const float4 a4 = __ldg(reinterpret_cast<const float4*>(aw_q + s));
      const float lx[4] = {l01.x, l01.z, l23.x, l23.z};
      const float ly[4] = {l01.y, l01.w, l23.y, l23.w};
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = (s + k) / P;
        add_sample<T, VEC>(acc, val, row_stride, lx[k], ly[k], av[k],
                           __ldg(shapes + 3 * l), __ldg(shapes + 3 * l + 1),
                           __ldg(shapes + 3 * l + 2));
      }
    }
  } else {
    for (int s = sub; s < LP; s += split) {
      const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_q + 2 * s));
      const int l = s / P;
      add_sample<T, VEC>(acc, val, row_stride, xy.x, xy.y, __ldg(aw_q + s),
                         __ldg(shapes + 3 * l), __ldg(shapes + 3 * l + 1),
                         __ldg(shapes + 3 * l + 2));
    }
    // the sub-groups of a (b, q, m) are lanes tpg, 2 tpg, ... apart
    for (int off = tpg; off < tpg * split; off *= 2)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (active && sub == 0) Store<T, VEC>::store(out + bqm * D + c * VEC, acc);
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
                   const void* aw, void* out, int B, int S, int Lq, int M,
                   int D, int L, int P, cudaStream_t stream) {
  const long long pairs = (long long)B * Lq * M;
  if (pairs == 0) return cudaSuccess;
  const int tpg = D / VEC;
  // Split the samples when the pairs alone would fill less than half the
  // card's resident threads (2048 an SM); the sub-groups of a pair must sit
  // in one warp, so only for power-of-two groups.
  int split = 1;
  const int max_split = (tpg & (tpg - 1)) == 0 ? 32 / tpg : 1;
  const long long half_card = (long long)sm_count() * 1024;
  while (split * 2 <= max_split && split * 2 <= L * P &&
         pairs * tpg * split * 2 <= half_card)
    split *= 2;
  const long long total = pairs * tpg * split;
  const long long blocks = (total + THREADS - 1) / THREADS;
  msda_fwd_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(shapes),
      static_cast<const float*>(loc), static_cast<const float*>(aw),
      static_cast<T*>(out), S, Lq, M, D, L, P, split, total);
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
    return (int)launch<float, 4>(value, shapes, loc, aw, out, B, S, Lq, M, D,
                                 L, P, s);
  if (dtype == 1) {
    if (D == 4)
      return (int)launch<__nv_bfloat16, 4>(value, shapes, loc, aw, out, B, S,
                                           Lq, M, D, L, P, s);
    return (int)launch<__nv_bfloat16, 8>(value, shapes, loc, aw, out, B, S,
                                         Lq, M, D, L, P, s);
  }
  return (int)cudaErrorInvalidValue;
}
