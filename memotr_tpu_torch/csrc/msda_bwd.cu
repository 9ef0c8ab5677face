// Multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// The gradient of msda_fwd.cu's function.  In the JAX package it is the
// custom VJP of `ms_deform_attn_pallas` (memotr_tpu/ops/msda_pallas.py,
// `_bwd` at :237): `jax.vjp` of `ms_deform_attn_xla`, which XLA compiles
// into gathers and scatter-adds.
//
// With g = grad_out[b,q,m,:], a = aw[b,q,m,l,p], the sample at pixel
// (px, py) = (x W_l - 0.5, y H_l - 0.5), (x0, y0) = floor, fx = px - x0, fy
// likewise, corner weights w00 = (1-fx)(1-fy), w01 = fx(1-fy), w10 =
// (1-fx)fy, w11 = fx fy, and v_c the corner's value row (zero where the
// corner lies outside the map, as grid_sample's zero padding has it):
//
//   grad_value[b, row, m, :]  = sum over the valid corners c of every
//                               sample that lands on row: a w_c g
//   grad_aw[b,q,m,l,p]        = sum_d g[d] sum_c w_c v_c[d]
//   grad_loc[b,q,m,l,p,0]     = W_l a sum_d g[d] ((1-fy)(v01-v00) + fy(v11-v10))
//   grad_loc[b,q,m,l,p,1]     = H_l a sum_d g[d] ((1-fx)(v10-v00) + fx(v11-v01))
//
// floor() has zero derivative.  A sample with every corner outside the map
// (or a NaN location) gets zero gradients, as in the forward.
//
// What bounds it.  At the encoder shape of the 896x1536 training canvas
// (B=1, Lq = S = 28,560, M=8, L=4, P=4, D=32, bf16) the bytes a call must
// move are ~130 MB (0.04 ms at 3.35 TB/s) and its float32 arithmetic ~3.7
// GFLOP (0.056 ms at 67 TFLOP/s).  What it really moves is gathers from L2:
// the four corner rows of every sample (836 MB, as the forward) and, for
// grad_value, grad_out's 64-byte head row once for every valid corner
// (~935 MB).  A scatter of grad_value by float32 atomics (the first design:
// one sm_90 `atomicAdd(float4*)` per corner and 4-channel chunk, 117 M of
// them into a zeroed float32 buffer, then a cast) was bound by the L2's
// atomic units: 0.91 ms, 6% of the bound.
//
// Design: grad_value without float atomics, through bilinear cells.  A
// sample's four corners are the corners of one cell of its level's grid:
// (x0, y0) .. (x0 + 1, y0 + 1), x0 in [-1, W-1], y0 in [-1, H-1].  So a
// sample is filed once, under its (cell, head) bucket; a bucket sums its
// samples' a w_c g for each of its four corners; and a value row (x, y)
// adds the corner sums of the four cells that have it as a corner: (x, y)
// as corner 00, (x-1, y) as 01, (x, y-1) as 10, (x-1, y-1) as 11.  One
// call, eight kernels:
//
//   1. msda_bwd_sample_kernel: a group of TPG threads owns one (b, q, m)
//      as in the forward, each thread 16-byte chunks of the D channels; it
//      gathers the four corner rows of every sample for grad_aw and
//      grad_loc (partial sums meet by shuffles; with SPLIT > 1, for too few
//      (b, q, m) to fill the card, the samples are dealt over SPLIT
//      sub-groups of a warp);
//   2. count (a thread a sample): an int32 atomicAdd on the bucket's count
//      gives the sample its slot (3.7 M integer atomics at the encoder
//      shape, where the first design made 117 M float4 ones);
//   3-4. an exclusive scan of the counts (B x cells x M, ~233 K a batch):
//      tiles of SCAN_TILE, then their totals;
//   5. fill (a thread a sample): the 16-byte entry ((b, q, m), fx, fy, a)
//      at its bucket's offset + slot;
//   6. cell: a group of TPG threads owns one bucket, reads its entries
//      UNROLL at a time (grad_out rows in flight together) and sums the
//      four corners' a w_c g in float32 registers: each sample's g is read
//      once (234 MB at the encoder shape, not once a corner: 935 MB);
//      four float32 rows out, none for an empty bucket;
//   7. row: a group of TPG threads owns one (b, value row, m) and adds its
//      four cells' corner sums in a fixed order; every row is written once
//      in the value dtype, so no buffer is zeroed and nothing is cast.
//
// No float atomic remains.  A bucket's entries lie in the order their
// count atomics arrived, so a cell's float32 sums may differ in the last
// bit from run to run; grad_loc and grad_aw are deterministic.
//
// Interface: plain C, loaded with ctypes; the caller allocates every output
// and one int32 workspace (8 a sample, 3 a bucket and 1 a tile of
// SCAN_TILE buckets: `msda_bwd_workspace` in ops/msda_cuda.py) and owns the
// stream.  Returns the first CUDA error of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

// VEC channels of a row, as float32, and back.
template <typename T, int VEC> struct Row;

template <> struct Row<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
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
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[4]) {
    uint2 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = r;
  }
};

// The first cell of level l: the cells of the levels before it, (H+1)(W+1)
// a level.
__device__ __forceinline__ int cell_start(const int* __restrict__ shapes,
                                          int l) {
  int n = 0;
  for (int k = 0; k < l; ++k)
    n += (__ldg(shapes + 3 * k) + 1) * (__ldg(shapes + 3 * k + 1) + 1);
  return n;
}

// The offset of bucket i's first entry: its tile's exclusive prefix plus
// the tile's start.
__device__ __forceinline__ int bucket_offset(const int* __restrict__ offsets,
                                             const int* __restrict__ tiles,
                                             int i) {
  return __ldg(offsets + i) + __ldg(tiles + i / SCAN_TILE);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
msda_bwd_sample_kernel(const T* __restrict__ value,
                       const int* __restrict__ shapes,
                       const float* __restrict__ loc,
                       const float* __restrict__ aw,
                       const T* __restrict__ grad_out,
                       float* __restrict__ grad_loc,
                       float* __restrict__ grad_aw, int S, int Lq, int M,
                       int D, int L, int P, int tpg, int split,
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
  const T* val = value + b * (long long)S * row_stride + (long long)m * D;

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

// Exclusive scan of n counts, tile by tile: offsets[i] = the sum of the
// counts before i in its tile of SCAN_TILE; tiles[t] = tile t's total.
__global__ void __launch_bounds__(SCAN_THREADS)
msda_bwd_scan_tiles_kernel(const int* __restrict__ counts, int* __restrict__ offsets,
                  int* __restrict__ tiles, int n) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i0 = blockIdx.x * SCAN_TILE + tid * SCAN_ITEMS;
  int v[SCAN_ITEMS], sum = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    v[k] = i0 + k < n ? counts[i0 + k] : 0;
    sum += v[k];
  }
  int incl = sum;                      // inclusive scan of the thread sums
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int ws = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, ws, off);
      if (lane >= off) ws += o;
    }
    warp_sums[lane] = ws;              // inclusive over the warps
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (i0 + k < n) offsets[i0 + k] = run;
    run += v[k];
  }
  if (tid == SCAN_THREADS - 1) tiles[blockIdx.x] = run;
}

// Exclusive scan, in place, of the n tile totals: one block.
__global__ void __launch_bounds__(SCAN_THREADS)
msda_bwd_scan_totals_kernel(int* __restrict__ tiles, int n) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int carry = 0;
  for (int base = 0; base < n; base += SCAN_THREADS) {
    const int i = base + tid;
    const int v = i < n ? tiles[i] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int ws = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, ws, off);
        if (lane >= off) ws += o;
      }
      warp_sums[lane] = ws;
    }
    __syncthreads();
    const int excl = carry + incl - v + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < n) tiles[i] = excl;
    carry += warp_sums[SCAN_THREADS / 32 - 1];
    __syncthreads();                   // before warp_sums is written again
  }
}

// The sample's fractions, weight and (when it has a corner in the map) its
// bucket, computed as msda_bwd_sample_kernel computes them.
struct Sample {
  float fx, fy, a;
  int bucket;                          // -1: every corner outside the map
};

__device__ __forceinline__ Sample locate(const int* __restrict__ shapes,
                                         const float* __restrict__ loc,
                                         const float* __restrict__ aw,
                                         long long i, int Lq, int M, int L,
                                         int P, int NC) {
  const int LP = L * P;
  const long long bqm = i / LP;
  const int l = (int)(i - bqm * LP) / P;
  const int m = (int)(bqm % M);
  const long long b = bqm / ((long long)Lq * M);
  const int h = __ldg(shapes + 3 * l), w = __ldg(shapes + 3 * l + 1);
  const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + i);
  const float px = xy.x * (float)w - 0.5f;
  const float py = xy.y * (float)h - 0.5f;
  Sample smp{0.f, 0.f, __ldg(aw + i), -1};
  if (px > -1.f && py > -1.f && px < (float)w && py < (float)h) {
    const float x0f = floorf(px), y0f = floorf(py);
    smp.fx = px - x0f;
    smp.fy = py - y0f;
    const int cell = cell_start(shapes, l) + ((int)y0f + 1) * (w + 1) +
                     (int)x0f + 1;
    smp.bucket = (int)((b * NC + cell) * M + m);
  }
  return smp;
}

// Every sample with a corner in the map takes a slot in its (cell, head)
// bucket: one integer atomic a sample, a thread a sample.
__global__ void __launch_bounds__(THREADS)
msda_bwd_count_kernel(const int* __restrict__ shapes, const float* __restrict__ loc,
             const float* __restrict__ aw, int* __restrict__ counts,
             int* __restrict__ slots, int Lq, int M, int L, int P, int NC,
             long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Sample smp = locate(shapes, loc, aw, i, Lq, M, L, P, NC);
  slots[i] = smp.bucket < 0 ? -1 : atomicAdd(counts + smp.bucket, 1);
}

// Every filed sample writes its entry at its bucket's offset + its slot:
// ((b, q, m), fx, fy, a).
__global__ void __launch_bounds__(THREADS)
msda_bwd_fill_kernel(const int* __restrict__ shapes, const float* __restrict__ loc,
            const float* __restrict__ aw, const int* __restrict__ slots,
            const int* __restrict__ offsets, const int* __restrict__ tiles,
            int4* __restrict__ entries, int Lq, int M, int L, int P, int NC,
            long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int slot = slots[i];
  if (slot < 0) return;
  const Sample smp = locate(shapes, loc, aw, i, Lq, M, L, P, NC);
  entries[bucket_offset(offsets, tiles, smp.bucket) + slot] =
      make_int4((int)(i / (L * P)), __float_as_int(smp.fx),
                __float_as_int(smp.fy), __float_as_int(smp.a));
}

// A group of tpg threads owns one (b, cell, m) bucket and sums, for each of
// the cell's four corners, a w_c g over the bucket's entries (UNROLL at a
// time, so that their grad_out rows are in flight together; the group's
// threads read the same 16-byte entry, one broadcast).  The four float32
// sums go to part[bucket][corner]; an empty bucket writes nothing.  Three
// blocks an SM (at most 85 registers a thread): 0.155 ms at the encoder
// shape on the H100, against 0.26 at the compiler's own choice (2).
constexpr int UNROLL = 4;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 3)
msda_bwd_cell_kernel(const T* __restrict__ grad_out, const int* __restrict__ counts,
            const int* __restrict__ offsets, const int* __restrict__ tiles,
            const int4* __restrict__ entries, float* __restrict__ part, int D,
            int tpg, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = (int)(t % tpg);
  const int bucket = (int)(t / tpg);
  const int count = __ldg(counts + bucket);
  if (count == 0) return;
  const int4* ent = entries + bucket_offset(offsets, tiles, bucket);
  const int nch = D / VEC / tpg;
  for (int k = 0; k < nch; ++k) {
    const int ch = (k * tpg + c) * VEC;
    float acc[4][VEC];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
    for (int e0 = 0; e0 < count; e0 += UNROLL) {
      int4 en[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        en[j] = e0 + j < count ? __ldg(ent + e0 + j)
                               : make_int4(0, 0, 0, 0);   // a = 0
      float g[UNROLL][VEC];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        Row<T, VEC>::load(grad_out + (long long)en[j].x * D + ch, g[j]);
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const float fx = __int_as_float(en[j].y);
        const float fy = __int_as_float(en[j].z);
        const float a = __int_as_float(en[j].w);
        const float wt[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy),
                             (1.f - fx) * fy, fx * fy};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float aq = a * wt[q];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[q][i] = fmaf(aq, g[j][i], acc[q][i]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(part + ((long long)bucket * 4 + q) * D +
                                   ch + i) =
            make_float4(acc[q][i], acc[q][i + 1], acc[q][i + 2], acc[q][i + 3]);
  }
}

// A group of tpg threads owns one (b, value row, m), heads fastest, and
// adds the sums of the four cells that have the row as a corner, in a
// fixed order; it writes the row once, in the value dtype.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
msda_bwd_row_kernel(const int* __restrict__ shapes, const int* __restrict__ counts,
           const float* __restrict__ part, T* __restrict__ grad_value, int S,
           int M, int D, int L, int NC, int tpg, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = (int)(t % tpg);
  const long long u = t / tpg;                   // (b, row, m), heads fastest
  const int m = (int)(u % M);
  const long long br = u / M;
  const int row = (int)(br % S);
  const long long b = br / S;
  const int nch = D / VEC / tpg;

  int l = 0, start = 0, w = 0;
  for (; l < L; ++l) {
    w = __ldg(shapes + 3 * l + 1);
    start = __ldg(shapes + 3 * l + 2);
    if (row < start + __ldg(shapes + 3 * l) * w) break;
  }
  const int y = (row - start) / w, x = (row - start) - y * w;
  const long long cell0 = b * NC + cell_start(shapes, l);
  // the cells (x0 + 1, y0 + 1) whose corner q is this row
  const int cy[4] = {y + 1, y + 1, y, y};
  const int cx[4] = {x + 1, x, x + 1, x};
  long long src[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long bucket = (cell0 + cy[q] * (w + 1) + cx[q]) * M + m;
    src[q] = __ldg(counts + bucket) > 0 ? (bucket * 4 + q) * D : -1;
  }
  for (int k = 0; k < nch; ++k) {
    const int ch = (k * tpg + c) * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (src[q] < 0) continue;
#pragma unroll
      for (int i = 0; i < VEC; i += 4) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(part + src[q] + ch + i));
        acc[i] += v.x;
        acc[i + 1] += v.y;
        acc[i + 2] += v.z;
        acc[i + 3] += v.w;
      }
    }
    Row<T, VEC>::store(grad_value + u * D + ch, acc);
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

// The int32 workspace, in order: entries (4 a sample), the cells' corner
// sums (4 D float32 a bucket), slots (1 a sample), counts and offsets (1 a
// bucket each), tile totals.
long long workspace_ints(long long samples, long long buckets, int D) {
  return 5 * samples + (4LL * D + 2) * buckets +
         (buckets + SCAN_TILE - 1) / SCAN_TILE;
}

template <typename T, int VEC>
cudaError_t launch(const void* value, const void* shapes, const void* loc,
                   const void* aw, const void* grad_out, void* grad_value,
                   void* grad_loc, void* grad_aw, int* ws, int B, int S,
                   int Lq, int M, int D, int L, int P, int NC,
                   cudaStream_t stream) {
  const long long pairs = (long long)B * Lq * M;
  const long long samples = pairs * L * P;
  const long long buckets = (long long)B * NC * M;
  int4* entries = reinterpret_cast<int4*>(ws);
  float* part = reinterpret_cast<float*>(ws + 4 * samples);
  int* slots = ws + 4 * samples + 4LL * D * buckets;
  int* counts = slots + samples;
  int* offsets = counts + buckets;
  int* tiles = offsets + buckets;
  const int n_tiles = (int)((buckets + SCAN_TILE - 1) / SCAN_TILE);
  const int* sh = static_cast<const int*>(shapes);
  const float* lc = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  const T* g = static_cast<const T*>(grad_out);
  const unsigned sample_blocks = (unsigned)((samples + THREADS - 1) / THREADS);
  cudaError_t err;
  if ((err = cudaMemsetAsync(counts, 0, buckets * sizeof(int), stream)) !=
      cudaSuccess)
    return err;
  // the largest power of two (at most 8) that divides the chunk count
  const int chunks = D / VEC;
  int tpg = 1;
  while (tpg < 8 && chunks % (tpg * 2) == 0) tpg *= 2;
  if (samples > 0) {
    // Split the samples when the pairs alone would fill less than half the
    // card's resident threads (2048 an SM), as the forward does.
    int split = 1;
    const long long half_card = (long long)sm_count() * 1024;
    while (split * 2 <= 32 / tpg && split * 2 <= L * P &&
           pairs * tpg * split * 2 <= half_card)
      split *= 2;
    const long long total = pairs * tpg * split;
    msda_bwd_sample_kernel<T, VEC>
        <<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
            static_cast<const T*>(value), sh, lc, a, g,
            static_cast<float*>(grad_loc), static_cast<float*>(grad_aw), S,
            Lq, M, D, L, P, tpg, split, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    msda_bwd_count_kernel<<<sample_blocks, THREADS, 0, stream>>>(
        sh, lc, a, counts, slots, Lq, M, L, P, NC, samples);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  msda_bwd_scan_tiles_kernel<<<n_tiles, SCAN_THREADS, 0, stream>>>(counts, offsets,
                                                          tiles, (int)buckets);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  msda_bwd_scan_totals_kernel<<<1, SCAN_THREADS, 0, stream>>>(tiles, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (samples > 0) {
    msda_bwd_fill_kernel<<<sample_blocks, THREADS, 0, stream>>>(
        sh, lc, a, slots, offsets, tiles, entries, Lq, M, L, P, NC, samples);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long cells = buckets * tpg;
    msda_bwd_cell_kernel<T, VEC>
        <<<(unsigned)((cells + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
            g, counts, offsets, tiles, entries, part, D, tpg, cells);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long total = (long long)B * S * M * tpg;
  msda_bwd_row_kernel<T, VEC>
      <<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
          sh, counts, part, static_cast<T*>(grad_value), S, M, D, L, NC, tpg,
          total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (value, grad_out and grad_value).
// grad_value (B, S, M, D), grad_loc (B, Lq, M, L, P, 2) and grad_aw
// (B, Lq, M, L, P) float32: every element written.  NC: the cells of the
// levels, sum (H+1)(W+1); ws: ws_ints int32 of workspace.  D must be 4, 8,
// 16 or a multiple of 32 (the Python wrapper checks every shape).
int msda_bwd(const void* value, const void* shapes, const void* loc,
             const void* aw, const void* grad_out, void* grad_value,
             void* grad_loc, void* grad_aw, void* ws, long long ws_ints,
             int dtype, int B, int S, int Lq, int M, int D, int L, int P,
             int NC, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long samples = (long long)B * Lq * M * L * P;
  const long long buckets = (long long)B * NC * M;
  if (ws_ints < workspace_ints(samples, buckets, D) || samples >= (1LL << 31) ||
      buckets >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (buckets == 0 || (long long)S * D == 0) return 0;   // nothing to write
  int* w = static_cast<int*>(ws);
  if (dtype == 0)
    return (int)launch<float, 4>(value, shapes, loc, aw, grad_out, grad_value,
                                 grad_loc, grad_aw, w, B, S, Lq, M, D, L, P,
                                 NC, s);
  if (dtype == 1) {
    if (D == 4)
      return (int)launch<__nv_bfloat16, 4>(value, shapes, loc, aw, grad_out,
                                           grad_value, grad_loc, grad_aw, w,
                                           B, S, Lq, M, D, L, P, NC, s);
    return (int)launch<__nv_bfloat16, 8>(value, shapes, loc, aw, grad_out,
                                         grad_value, grad_loc, grad_aw, w, B,
                                         S, Lq, M, D, L, P, NC, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
