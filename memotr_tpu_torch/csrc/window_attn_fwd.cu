// Fused window attention (K2), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `window_attention_pallas`
// (memotr_tpu/ops/window_attn.py: `_kernel` :112, `_forward` :184, the
// pallas_call at :214).  One block of windowed multi-head self-attention on
// a padded (B, Hp, Wp, C) map:
//
//   q = k = x + pos, v = x; partition into wh x ww windows of L tokens;
//   Q, K, V = projections (torch MHA layout, weights (3C, C) + bias (3C));
//   P = softmax_f32(Q K^T / sqrt(dh) + bias[h] , keys masked where padded,
//                   a window whose keys are all padding opened);
//   y = (P V) Wo^T + bo, merged back to (B, Hp, Wp, C).
//
// Grid (MaxViT) attention is the same block on a block-transposed map, so
// L is 64 for the 8x8 windows and up to 312 (13 x 24) for the grid groups
// of the 800x1536 main path.
//
// What bounds it.  At level 0 of the main path (B=1, 104x192 padded, C=256,
// 8 heads, bf16) one call does 8*C^2*tokens = 10.5 GFLOP of projections and
// 4*L*C*tokens = 1.3 GFLOP (window, L=64) or 6.4 GFLOP (grid, L=312) of
// attention: 0.012-0.017 ms at the 989 TFLOP/s bf16 tensor-core peak.  The
// bytes it must move (x, pos, mask, out, weights, bias: ~32 MB) take
// ~0.0095 ms at 3.35 TB/s.  So it is bound by operations, and only tensor
// cores reach that bound.
//
// Design (a simple first version: right before fast).  Three kernels on the
// caller's stream, f32 accumulation throughout, intermediates in the
// activation type T (float or bf16), as the JAX version rounds them:
//   (a) the QKV projection.  Its A rows are gathered through the window
//       partition addressing (x + pos for Q and K, x for V), so no
//       partitioned copy of the map is ever written; Q, K, V go to scratch
//       as (3, windows, heads, L, dh).
//   (b) the attention: one block per (window, head, 32-query tile) holds
//       that head's K and V in shared memory (dynamic, above 48 KB for
//       L = 312), writes the 32 x L logits + bias + key mask to shared
//       memory, takes an exact two-pass f32 softmax per row (one warp a
//       row, coalesced bias rows) and mixes V; the result goes to scratch
//       as (tokens, C).
//   (c) the output projection, stored through the merge addressing straight
//       into (B, Hp, Wp, C).
// In bfloat16 the products of (a), (b) and (c) run on the tensor cores
// through WMMA (mma.sync, 16x16x16 bf16 fragments): proj_kernel_tc (C a
// multiple of 32) loads its gathered A rows 16 bytes at a time; attn_kernel_tc
// (head dims that are multiples of 16) computes Q K^T and P V by fragments
// around the same f32 softmax.  In float32, and for other
// head dims, the CUDA-core kernels proj_kernel and attn_kernel do the same
// work with f32 FMAs.  Neither reaches the bound: WMMA from shared memory
// without TMA or pipelining, three passes through global scratch, and a
// softmax between two small products leave wgmma, TMA and one fused pass
// for later work.
//
// Interface: plain C, loaded with ctypes; the caller allocates `out` and the
// two scratch buffers and owns the stream.  Returns cudaGetLastError() after
// the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

// A float32 value rounded to T: the JAX version casts weights, biases and
// x + pos to the activation dtype before using them.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// Window partition addressing of a padded (B, Hp, Wp, C) map: token
// t = window * L + l, windows in (b, window row, window column) order,
// members row-major inside a window.
struct Geom {
  int Hp, Wp, wh, ww, nwh, nww, L;

  __device__ __forceinline__ long long pixel(long long t) const {
    const long long w = t / L;
    const int l = (int)(t - w * L);
    const int per_b = nwh * nww;
    const long long b = w / per_b;
    const int r = (int)(w - b * per_b);
    const int y = (r / nww) * wh + l / ww;
    const int x = (r % nww) * ww + l % ww;
    return (b * Hp + y) * (long long)Wp + x;
  }
};

constexpr int BM = 64, BN = 64, BK = 16, PROJ_THREADS = 256;

// One element of the projection's A operand: x + pos (rounded to T, as the
// JAX version adds in T) for Q and K, x for V and for the output projection.
template <typename T>
__device__ __forceinline__ float a_elem(const T* __restrict__ a,
                                        const T* __restrict__ pos,
                                        long long i, bool add_pos) {
  const float v = to_f32(a[i]);
  return add_pos ? round_to<T>(v + to_f32(pos[i])) : v;
}

// Stores out[z] element (token t, feature n) = acc + bias: Q/K/V as
// (3, windows, heads, L, dh) when QKV, else through the merge addressing
// into (B, Hp, Wp, C).  The JAX version rounds the product to T, then adds
// the bias in T; here the product stays f32 and is rounded once.
template <typename T, bool QKV>
__device__ __forceinline__ void store_proj(T* __restrict__ out, const Geom& g,
                                           long long M, int C, int heads,
                                           int z, long long t, int n,
                                           float acc,
                                           const float* __restrict__ bias) {
  const T v = from_f32<T>(acc + round_to<T>(bias[z * C + n]));
  if (QKV) {
    const int dh = C / heads;
    const long long win = t / g.L;
    const int l = (int)(t - win * g.L);
    const int h = n / dh, d = n - h * dh;
    out[(long long)z * M * C + ((win * heads + h) * g.L + l) * dh + d] = v;
  } else {
    out[g.pixel(t) * C + n] = v;
  }
}

// QKV = true: out[z] = A_z W_z^T + b_z for z = blockIdx.z in {q, k, v}, A_q
// = A_k = x + pos and A_v = x gathered through the partition addressing.
// QKV = false: out = O Wo^T + bo with O (tokens, C) in window order.  The
// float32 version: CUDA-core FMAs, each thread a 4x4 block of the 64x64
// tile.
template <typename T, bool QKV>
__global__ void __launch_bounds__(PROJ_THREADS)
proj_kernel(const T* __restrict__ a, const T* __restrict__ pos,
            const float* __restrict__ w, const float* __restrict__ bias,
            T* __restrict__ out, Geom g, long long M, int C, int heads) {
  __shared__ __align__(16) float As[BK][BM + 4];    // A tile, transposed
  __shared__ __align__(16) float Bs[BK][BN + 4];    // W tile, transposed
  __shared__ long long a_off[BM];

  const int z = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const bool add_pos = QKV && z < 2;
  const float* wz = w + (long long)z * C * C;

  if (tid < BM) {
    const long long t = m0 + tid;
    a_off[tid] = t < M ? (QKV ? g.pixel(t) : t) * C : -1;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int tx = tid % 16, ty = tid / 16;

  for (int k0 = 0; k0 < C; k0 += BK) {
    for (int e = tid; e < BM * BK; e += PROJ_THREADS) {
      const int r = e / BK, kk = e % BK;
      const long long off = a_off[r];
      As[kk][r] = off >= 0 && k0 + kk < C
                      ? a_elem(a, pos, off + k0 + kk, add_pos) : 0.f;
    }
    for (int e = tid; e < BN * BK; e += PROJ_THREADS) {
      const int n = e / BK, kk = e % BK;
      Bs[kk][n] = n0 + n < C && k0 + kk < C
                      ? round_to<T>(wz[(long long)(n0 + n) * C + k0 + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long t = m0 + ty * 4 + i;
    if (t >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < C) store_proj<T, QKV>(out, g, M, C, heads, z, t, n, acc[i][j], bias);
    }
  }
}

// The bfloat16 version of proj_kernel on the tensor cores (WMMA 16x16x16
// bf16 fragments, f32 accumulation), for C a multiple of 32: the same
// 64x64 tile of one z, 8 warps of 16x32, k in steps of 32.  Each thread
// loads one 16-byte chunk (8 channels) of a gathered A row and two float4
// of the weight tile per step, rounded as in proj_kernel; the accumulators
// pass through shared memory to the same epilogue.
constexpr int TBK = 32, TLD = TBK + 8;              // bf16 tile row pitch

template <bool QKV>
__global__ void __launch_bounds__(PROJ_THREADS)
proj_kernel_tc(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ pos,
               const float* __restrict__ w, const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, Geom g, long long M, int C,
               int heads) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  __shared__ __align__(32) bf16 As[BM][TLD];        // tokens x k
  __shared__ __align__(32) bf16 Bs[BN][TLD];        // features x k
  __shared__ __align__(32) float Cs[BM][BN + 4];
  __shared__ long long a_off[BM];

  const int z = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const bool add_pos = QKV && z < 2;
  const float* wz = w + (long long)z * C * C;
  const int warp = tid / 32, wm = warp % 4, wn = warp / 4;
  const int ar = tid / 4, ac = (tid % 4) * 8;       // this thread's A chunk

  if (tid < BM) {
    const long long t = m0 + tid;
    a_off[tid] = t < M ? (QKV ? g.pixel(t) : t) * C : -1;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k0 = 0; k0 < C; k0 += TBK) {
    const long long off = a_off[ar];
    uint4 av = make_uint4(0, 0, 0, 0);
    if (off >= 0) {
      av = *reinterpret_cast<const uint4*>(a + off + k0 + ac);
      if (add_pos) {
        const uint4 pv = *reinterpret_cast<const uint4*>(pos + off + k0 + ac);
        __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&av);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&pv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 xf = __bfloat1622float2(x2[i]);
          const float2 pf = __bfloat1622float2(p2[i]);
          x2[i] = __floats2bfloat162_rn(xf.x + pf.x, xf.y + pf.y);
        }
      }
    }
    *reinterpret_cast<uint4*>(&As[ar][ac]) = av;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * PROJ_THREADS;
      const int br = e / 8, bc = (e % 8) * 4;
      float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n0 + br < C)
        wv = *reinterpret_cast<const float4*>(wz + (long long)(n0 + br) * C +
                                              k0 + bc);
      __nv_bfloat162* b2 = reinterpret_cast<__nv_bfloat162*>(&Bs[br][bc]);
      b2[0] = __floats2bfloat162_rn(wv.x, wv.y);
      b2[1] = __floats2bfloat162_rn(wv.z, wv.w);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, &As[wm * 16][kk], TLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, &Bs[wn * 32 + j * 16][kk], TLD);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&Cs[wm * 16][wn * 32 + j * 16], acc[j], BN + 4,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += PROJ_THREADS) {
    const int r = e / BN, n = n0 + e % BN;
    const long long t = m0 + r;
    if (t < M && n < C)
      store_proj<bf16, QKV>(out, g, M, C, heads, z, t, n, Cs[r][e % BN], bias);
  }
}

constexpr int TQ = 32, ATTN_THREADS = 256;

inline size_t attn_smem_floats(int L, int dh) {
  // K (L x (dh+1)), V (L x dh), Q tile (TQ x dh), logits (TQ x L), key flags (L)
  return (size_t)L * (dh + 1) + (size_t)L * dh + (size_t)TQ * dh +
         (size_t)TQ * L + L;
}

template <typename T>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
            const float* __restrict__ bias, T* __restrict__ o, Geom g,
            long long M, int C, int heads) {
  extern __shared__ __align__(16) float smem[];
  const int L = g.L;
  const int dh = C / heads;
  const int dp = dh + 1;                 // padded K rows: conflict-free reads
  float* Ks = smem;
  float* Vs = Ks + (size_t)L * dp;
  float* Qs = Vs + (size_t)L * dh;
  float* S = Qs + TQ * dh;
  float* key_pad = S + (size_t)TQ * L;

  const long long wh_idx = blockIdx.x;   // window * heads + head
  const long long win = wh_idx / heads;
  const int h = (int)(wh_idx - win * heads);
  const int q0 = blockIdx.y * TQ;
  const int nq = min(TQ, L - q0);
  const T* Qg = qkv + wh_idx * L * dh;
  const T* Kg = Qg + M * C;
  const T* Vg = Kg + M * C;
  const int tid = threadIdx.x;

  for (int e = tid; e < L * dh; e += ATTN_THREADS) {
    const int j = e / dh, d = e - j * dh;
    Ks[j * dp + d] = to_f32(Kg[e]);
    Vs[e] = to_f32(Vg[e]);
  }
  for (int e = tid; e < nq * dh; e += ATTN_THREADS)
    Qs[e] = to_f32(Qg[(long long)q0 * dh + e]);
  int any_valid = 0;
  for (int j = tid; j < L; j += ATTN_THREADS) {
    const bool pad = mask[g.pixel(win * L + j)] != 0;
    key_pad[j] = pad ? 1.f : 0.f;
    any_valid |= !pad;
  }
  // a window whose keys are all padding is opened (barrier as well)
  const bool open = !__syncthreads_or(any_valid);

  const float scale = round_to<T>(sqrtf((float)dh));
  const float* bias_h = bias ? bias + ((long long)h * L + q0) * L : nullptr;
  for (int e = tid; e < nq * L; e += ATTN_THREADS) {
    const int qi = e / L, j = e - qi * L;
    const float* qr = Qs + qi * dh;
    const float* kr = Ks + j * dp;
    float s = 0.f;
    for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
    s = s / scale;
    if (bias_h) s += round_to<T>(bias_h[(long long)qi * L + j]);
    if (!open && key_pad[j] != 0.f) s = -FLT_MAX;
    S[qi * L + j] = s;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int qi = warp; qi < nq; qi += ATTN_THREADS / 32) {
    float* row = S + qi * L;
    float mx = -FLT_MAX;
    for (int j = lane; j < L; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, k));
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(row[j] - mx);
      row[j] = p;
      sum += p;
    }
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, k);
    const float inv = 1.f / sum;
    for (int j = lane; j < L; j += 32) row[j] = row[j] * inv;
  }
  __syncthreads();

  for (int e = tid; e < nq * dh; e += ATTN_THREADS) {
    const int qi = e / dh, d = e - qi * dh;
    const float* pr = S + qi * L;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(pr[j], Vs[j * dh + d], acc);
    o[(win * L + q0 + qi) * C + h * dh + d] = from_f32<T>(acc);
  }
}

// The bfloat16 version of attn_kernel on the tensor cores, for head dims
// that are multiples of 16 up to 128: the same block (window, head,
// 32-query tile), K, V and the Q tile kept in bf16 with keys padded to a
// multiple of 16; S = Q K^T by WMMA into f32 shared memory; scale, bias, key
// mask and the f32 softmax per row (one warp a row) as in attn_kernel; P
// rounded to bf16 (as the JAX version rounds the softmax to the activation
// dtype) in place over its S row, so that two blocks fit on an SM at
// L = 312; O = P V by WMMA.  Dynamic shared memory: tc_attn_smem().
constexpr int TQP = 8;                               // bf16 row padding

// logits pitch in floats: a row holds S (lp keys), then P in bf16 over
// its first half, then O (dh values)
__host__ __device__ inline int tc_attn_sp(int lp, int dh) {
  return (lp > dh ? lp : dh) + 4;
}

inline size_t tc_attn_smem(int L, int dh) {
  const size_t lp = (L + 15) / 16 * 16, dp = dh + TQP;
  return 2 * lp * dp * 2 + TQ * dp * 2 + TQ * tc_attn_sp((int)lp, dh) * 4 +
         lp * 4;
}

__global__ void __launch_bounds__(ATTN_THREADS)
attn_kernel_tc(const __nv_bfloat16* __restrict__ qkv,
               const uint8_t* __restrict__ mask,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
               Geom g, long long M, int C, int heads) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = g.L, dh = C / heads;
  const int lp = (L + 15) / 16 * 16, dp = dh + TQP;
  const int sp = tc_attn_sp(lp, dh), pp = 2 * sp;   // P pitch in bf16
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // lp x dp
  bf16* Vs = Ks + lp * dp;                        // lp x dp
  bf16* Qs = Vs + lp * dp;                        // TQ x dp
  float* S = reinterpret_cast<float*>(Qs + TQ * dp);   // TQ x sp: S, P, O
  bf16* P = reinterpret_cast<bf16*>(S);                // TQ x pp, over S
  float* key_pad = S + TQ * sp;                        // lp

  const long long wh_idx = blockIdx.x;   // window * heads + head
  const long long win = wh_idx / heads;
  const int h = (int)(wh_idx - win * heads);
  const int q0 = blockIdx.y * TQ;
  const int nq = min(TQ, L - q0);
  const bf16* Qg = qkv + wh_idx * L * dh;
  const bf16* Kg = Qg + M * C;
  const bf16* Vg = Kg + M * C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16 zero = __float2bfloat16(0.f);

  for (int e = tid; e < lp * dh; e += ATTN_THREADS) {
    const int j = e / dh, d = e - j * dh;
    Ks[j * dp + d] = j < L ? Kg[e] : zero;
    Vs[j * dp + d] = j < L ? Vg[e] : zero;
  }
  for (int e = tid; e < TQ * dh; e += ATTN_THREADS) {
    const int qi = e / dh, d = e - qi * dh;
    Qs[qi * dp + d] = qi < nq ? Qg[(long long)(q0 + qi) * dh + d] : zero;
  }
  int any_valid = 0;
  for (int j = tid; j < L; j += ATTN_THREADS) {
    const bool pad = mask[g.pixel(win * L + j)] != 0;
    key_pad[j] = pad ? 1.f : 0.f;
    any_valid |= !pad;
  }
  const bool open = !__syncthreads_or(any_valid);

  for (int tile = warp; tile < (TQ / 16) * (lp / 16); tile += ATTN_THREADS / 32) {
    const int mi = tile % (TQ / 16), nj = tile / (TQ / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < dh; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
      wmma::load_matrix_sync(af, Qs + mi * 16 * dp + kk, dp);
      wmma::load_matrix_sync(bf, Ks + nj * 16 * dp + kk, dp);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(S + mi * 16 * sp + nj * 16, acc, sp,
                            wmma::mem_row_major);
  }
  __syncthreads();

  const float scale = round_to<bf16>(sqrtf((float)dh));
  for (int qi = warp; qi < TQ; qi += ATTN_THREADS / 32) {
    float* row = S + qi * sp;
    bf16* prow = P + qi * pp;
    if (qi >= nq) {                      // rows past the tile: zeros
      for (int j = lane; j < lp; j += 32) prow[j] = zero;
      continue;
    }
    const float* brow = bias ? bias + ((long long)h * L + q0 + qi) * L
                             : nullptr;
    float mx = -FLT_MAX;
    for (int j = lane; j < L; j += 32) {
      float v = row[j] / scale;
      if (brow) v += round_to<bf16>(brow[j]);
      if (!open && key_pad[j] != 0.f) v = -FLT_MAX;
      row[j] = v;
      mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, k));
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(row[j] - mx);
      row[j] = p;
      sum += p;
    }
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, k);
    const float inv = 1.f / sum;
    // P over its own S row: chunk c reads floats [64c, 64c + 64) and writes
    // bf16 [64c, 64c + 64), i.e. floats [32c, 32c + 32), all read by then
    for (int j0 = 0; j0 < lp; j0 += 64) {
      const int j = j0 + 2 * lane;
      const float p0 = j < L ? row[j] * inv : 0.f;
      const float p1 = j + 1 < L ? row[j + 1] * inv : 0.f;
      __syncwarp();
      if (j < lp)
        *reinterpret_cast<__nv_bfloat162*>(prow + j) =
            __floats2bfloat162_rn(p0, p1);
    }
  }
  __syncthreads();

  // O = P V: at most 16 output tiles (dh <= 128), two per warp, stored
  // over S once every warp is done reading P
  constexpr int WARPS = ATTN_THREADS / 32;
  const int n_tiles = (TQ / 16) * (dh / 16);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  for (int i = 0; i < 2; ++i) {
    const int tile = warp + i * WARPS;
    if (tile >= n_tiles) break;
    const int mi = tile % (TQ / 16), nj = tile / (TQ / 16);
    wmma::fill_fragment(acc[i], 0.f);
    for (int kk = 0; kk < lp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
      wmma::load_matrix_sync(af, P + mi * 16 * pp + kk, pp);
      wmma::load_matrix_sync(bf, Vs + kk * dp + nj * 16, dp);
      wmma::mma_sync(acc[i], af, bf, acc[i]);
    }
  }
  __syncthreads();
  float* O = S;                          // TQ x sp
  for (int i = 0; i < 2; ++i) {
    const int tile = warp + i * WARPS;
    if (tile >= n_tiles) break;
    const int mi = tile % (TQ / 16), nj = tile / (TQ / 16);
    wmma::store_matrix_sync(O + mi * 16 * sp + nj * 16, acc[i], sp,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < nq * dh; e += ATTN_THREADS) {
    const int qi = e / dh, d = e - qi * dh;
    o[(win * L + q0 + qi) * C + h * dh + d] =
        __float2bfloat16(O[qi * sp + d]);
  }
}

// Sets a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// float32 runs every stage on the CUDA cores; bfloat16 runs the products on
// the tensor cores where the shapes allow (projections: C a multiple of 32;
// attention: head dim a multiple of 16, at most 128).
template <typename T>
int launch(const void* x, const void* pos, const void* mask, const void* w_in,
           const void* b_in, const void* w_out, const void* b_out,
           const void* bias, void* qkv, void* o, void* out, int B, int Hp,
           int Wp, int C, int heads, int wh, int ww, cudaStream_t stream) {
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  Geom g{Hp, Wp, wh, ww, Hp / wh, Wp / ww, wh * ww};
  const long long n_win = (long long)B * g.nwh * g.nww;
  const long long M = n_win * g.L;
  const int dh = C / heads;
  const unsigned m_blocks = (unsigned)((M + BM - 1) / BM);
  const T* xt = static_cast<const T*>(x);
  const T* ot = static_cast<const T*>(o);
  const float* fw_in = static_cast<const float*>(w_in);
  const float* fb_in = static_cast<const float*>(b_in);
  const float* fw_out = static_cast<const float*>(w_out);
  const float* fb_out = static_cast<const float*>(b_out);
  const float* fbias = static_cast<const float*>(bias);
  const uint8_t* m8 = static_cast<const uint8_t*>(mask);
  cudaError_t err;

  const bool tc_proj = bf && C % TBK == 0;
  const dim3 qkv_blocks(m_blocks, (C + BN - 1) / BN, 3);
  if constexpr (bf) {
    if (tc_proj)
      proj_kernel_tc<true><<<qkv_blocks, PROJ_THREADS, 0, stream>>>(
          xt, static_cast<const T*>(pos), fw_in, fb_in, static_cast<T*>(qkv),
          g, M, C, heads);
  }
  if (!tc_proj)
    proj_kernel<T, true><<<qkv_blocks, PROJ_THREADS, 0, stream>>>(
        xt, static_cast<const T*>(pos), fw_in, fb_in, static_cast<T*>(qkv), g,
        M, C, heads);

  const dim3 attn_blocks((unsigned)(n_win * heads), (g.L + TQ - 1) / TQ);
  if (bf && dh % 16 == 0 && dh <= 128) {
    const size_t smem = tc_attn_smem(g.L, dh);
    if ((err = allow_smem(attn_kernel_tc, smem)) != cudaSuccess) return (int)err;
    attn_kernel_tc<<<attn_blocks, ATTN_THREADS, smem, stream>>>(
        reinterpret_cast<const __nv_bfloat16*>(qkv), m8, fbias,
        reinterpret_cast<__nv_bfloat16*>(o), g, M, C, heads);
  } else {
    const size_t smem = attn_smem_floats(g.L, dh) * sizeof(float);
    if ((err = allow_smem(attn_kernel<T>, smem)) != cudaSuccess) return (int)err;
    attn_kernel<T><<<attn_blocks, ATTN_THREADS, smem, stream>>>(
        static_cast<const T*>(qkv), m8, fbias, static_cast<T*>(o), g, M, C,
        heads);
  }

  const dim3 out_blocks(m_blocks, (C + BN - 1) / BN, 1);
  if constexpr (bf) {
    if (tc_proj)
      proj_kernel_tc<false><<<out_blocks, PROJ_THREADS, 0, stream>>>(
          ot, nullptr, fw_out, fb_out, static_cast<T*>(out), g, M, C, heads);
  }
  if (!tc_proj)
    proj_kernel<T, false><<<out_blocks, PROJ_THREADS, 0, stream>>>(
        ot, nullptr, fw_out, fb_out, static_cast<T*>(out), g, M, C, heads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, pos, qkv, o, out).  Weights and
// biases are float32; mask is (B, Hp, Wp) bool (one byte each); bias is
// (heads, L, L) float32 or NULL.  qkv: 3 * B*Hp*Wp*C and o: B*Hp*Wp*C
// elements of scratch.
int window_attn_fwd(const void* x, const void* pos, const void* mask,
                    const void* w_in, const void* b_in, const void* w_out,
                    const void* b_out, const void* bias, void* qkv, void* o,
                    void* out, int dtype, int B, int Hp, int Wp, int C,
                    int heads, int wh, int ww, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, pos, mask, w_in, b_in, w_out, b_out, bias, qkv, o,
                         out, B, Hp, Wp, C, heads, wh, ww, s);
  return launch<__nv_bfloat16>(x, pos, mask, w_in, b_in, w_out, b_out, bias,
                               qkv, o, out, B, Hp, Wp, C, heads, wh, ww, s);
}

}  // extern "C"
