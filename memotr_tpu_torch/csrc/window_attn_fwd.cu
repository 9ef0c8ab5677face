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
// of the 800x1536 main path.  A "group" below is one window or grid group.
//
// What bounds it.  At level 0 of the main path (B=1, 104x192 padded, C=256,
// 8 heads, bf16) one call does 8*C^2*tokens = 10.5 GFLOP of projections and
// 4*L*C*tokens = 1.3 GFLOP (window, L=64) or 6.4 GFLOP (grid, L=312) of
// attention: 0.012-0.017 ms at the 989 TFLOP/s bf16 tensor-core peak.  The
// bytes it must move (x, pos, mask, out, weights, bias: ~32 MB) take
// ~0.0095 ms at 3.35 TB/s.  So it is bound by operations, and only tensor
// cores come near that bound.  What a simple design loses on the way is
// round trips: Q, K, V and the head outputs through device memory, the
// float32 weights re-read and re-rounded by every tile, and products fed
// from shared memory with a barrier on each side.
//
// Design of the bfloat16 route (C a multiple of 64, head dim 16, 32 or 64,
// and the block's shared memory within the card's 227 KB): two launches.
//   (a) fused_attn_kernel: a block owns one head and walks a strided list
//       of groups.  Its head's Wq/Wk/Wv rows (3 dh x C) are rounded to bf16
//       once per block and stay in shared memory for every group it walks;
//       so does the head's (L, L) bias table where it fits (L <= 64, in
//       bf16), else each logit fragment reads its bias from L2.  For each
//       group the block streams the group's x and pos rows (gathered through
//       the partition addressing, 64 rows x 64 channels a stage) through a
//       cp.async ring, forms x + pos in bf16 on arrival, and projects Q, K,
//       V (bias added in f32, rounded once) into shared memory: no Q, K or
//       V ever goes to device memory.  Groups of up to 64 keys use a
//       two-stage ring and 8 warps, so that two blocks fit an SM; larger
//       groups a four-stage ring and 12 warps, one block an SM.  Each warp
//       then takes 16-query tiles: S = Q K^T fragment by fragment, scale,
//       bias, key mask and dead-window opening in registers, an online
//       (flash) softmax in f32 over key tiles of 64 (keys padded to the MMA
//       tile get -inf), P rounded to bf16 straight from the S registers
//       into the A operand of P V, and O / l rounded to bf16 into the
//       head-output map (tokens x C in window order: one map of scratch).
//   (b) out_proj_kernel: O Wo^T + bo, a block per 64 output columns whose
//       Wo rows stay in shared memory as bf16 while the block walks row
//       tiles of 128 tokens through a three-stage cp.async ring; stored through
//       the merge addressing straight into (B, Hp, Wp, C).
// All five products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
// f32 accumulate) fed by ldmatrix.  Why mma.sync and not wgmma: the
// attention's tiles are 16 query rows per warp and the softmax lives in
// the accumulator registers between two products, which is the mma.sync
// (FlashAttention-2) register layout; wgmma's 64-row warpgroup tiles and
// swizzled descriptors are left for later work together with TMA.  Both
// kernels are persistent (one wave: blocks = resident blocks per SM x SMs),
// so the weights are read once per block, not once per tile.
//
// Left for later: the output projection inside (a), reduced over heads
// through a thread block cluster's distributed shared memory (one launch,
// no head-output map); wgmma and TMA; more than one head per block, which
// would read the x and pos rows once per group instead of once per head.
//
// Float32, and shapes the fused route does not take (head dim 8, C not a
// multiple of 64), run three CUDA-core kernels with f32 FMAs: proj_kernel
// (QKV projection through the partition addressing into a Q/K/V scratch),
// attn_kernel (per (group, head, 32-query tile) exact two-pass softmax) and
// proj_kernel again for the output projection.
//
// Interface: plain C, loaded with ctypes; the caller allocates `out` and the
// scratch (`o` always, `qkv` only for the CUDA-core route:
// window_attn_fused() says which) and owns the stream.  Returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
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

  // 32-bit arithmetic: the wrapper's maps hold fewer than 2^31 tokens
  __device__ __forceinline__ long long pixel(long long t) const {
    const int ti = (int)t;
    const int w = ti / L;
    const int l = ti - w * L;
    const int per_b = nwh * nww;
    const int b = w / per_b;
    const int r = w - b * per_b;
    const int y = (r / nww) * wh + l / ww;
    const int x = (r % nww) * ww + l % ww;
    return ((long long)b * Hp + y) * Wp + x;
  }
};

// ------------------------------------------------ CUDA-core route (f32)

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
// QKV = false: out = O Wo^T + bo with O (tokens, C) in window order.
// CUDA-core FMAs, each thread a 4x4 block of the 64x64 tile.
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

// Sets a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------- tensor-core route (bfloat16)

using bf16 = __nv_bfloat16;

constexpr int FT = 256;            // threads that copy (a)'s stages; (b)'s block
// Warps of (a): 8 for small groups (two blocks an SM), 12 for larger ones,
// whose attention has more 16-query tiles to share out.
__host__ __device__ constexpr int fused_warps(bool small) { return small ? 8 : 12; }
constexpr int KC = 64;             // channels per cp.async stage
constexpr int KP = KC + 8;         // stage row pitch in bf16 (144 B)
constexpr int PROJ_ROWS = 64;      // rows of a projection tile in (a)
constexpr int OUT_ROWS = 128;      // rows of a tile in (b)
constexpr int OUT_COLS = 64;       // output columns of a block in (b)
constexpr int KEY_TILE = 64;       // keys per online-softmax step
constexpr int OUT_NS = 3;          // ring stages of (b)
// Groups of L <= 64 ("small") keep the head's bias table in shared memory
// and run a two-stage ring, so that two blocks fit an SM; larger groups
// read the bias from L2 and run a four-stage ring, one block an SM.
constexpr int SMALL_L = 64;
__host__ __device__ constexpr int ring_stages(bool small) { return small ? 2 : 4; }
// Bias table row pitch in bf16: 8 elements of padding spread the 8 rows a
// warp's logit fragment reads over the banks.
__host__ __device__ inline int bias_pitch(int L) { return L + 8; }

// Row pitches (in bf16) of the resident weight rows and of Q/K/V: 8
// elements of padding make the 8 rows an ldmatrix reads hit 8 different
// 16-byte bank groups.
__host__ __device__ inline int w_pitch(int C) { return C + 8; }
__host__ __device__ inline int group_rows(int L) {
  return (L + PROJ_ROWS - 1) / PROJ_ROWS * PROJ_ROWS;
}
__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// Dynamic shared memory of fused_attn_kernel: the head's weight rows, the
// x / x+pos ring, Q/K/V of one group, the bias table where it fits, one key
// flag per row.
inline size_t fused_smem(int C, int dh, int L, bool bias) {
  const size_t lr = group_rows(L);
  const bool small = L <= SMALL_L;
  return (size_t)3 * dh * w_pitch(C) * 2 +
         (size_t)ring_stages(small) * 2 * PROJ_ROWS * KP * 2 +
         3 * lr * (dh + 8) * 2 +
         (bias && small ? round16((size_t)L * bias_pitch(L) * 2) : 0) +
         round16(lr);
}

inline size_t out_proj_smem(int C) {
  return (size_t)OUT_COLS * w_pitch(C) * 2 + (size_t)OUT_NS * OUT_ROWS * KP * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N of this thread's committed copy groups are pending.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows of a float32 weight matrix rounded to bf16 into shared memory (row
// pitch wp): shared row n is w's row row_of(n).  Eight 16-byte loads of a
// thread are in flight together.
template <int NTHR, typename RowOf>
__device__ __forceinline__ void weights_to_smem(bf16* dst, int wp,
                                                const float* __restrict__ w,
                                                int rows, int C, RowOf row_of) {
  const int c4 = C / 4, total = rows * c4;
  for (int e0 = threadIdx.x; e0 < total; e0 += 8 * NTHR) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * NTHR, n = e / c4;
      if (e < total)
        v[u] = __ldg(reinterpret_cast<const float4*>(
            w + (long long)row_of(n) * C + (e - n * c4) * 4));
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * NTHR, n = e / c4;
      if (e < total) {
        __nv_bfloat162* d2 =
            reinterpret_cast<__nv_bfloat162*>(dst + n * wp + (e - n * c4) * 4);
        d2[0] = __floats2bfloat162_rn(v[u].x, v[u].y);
        d2[1] = __floats2bfloat162_rn(v[u].z, v[u].w);
      }
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One cp.async stage of a warp's products: acc[j] += A (the warp's 16 rows,
// KC channels) x W rows [w_row0 + 8j, +8) at channels [k0, k0 + KC).
// Tiles whose first W row is below `split` take A from a0, the others from
// a1 (the QKV projection: x + pos for Q and K, x for V).
template <int NT>
__device__ __forceinline__ void stage_mma(float (&acc)[NT][4],
                                          const bf16* a0, const bf16* a1,
                                          int split, const bf16* w, int wp,
                                          int w_row0, int k0, int lane) {
  const bool need0 = w_row0 < split, need1 = w_row0 + 8 * NT > split;
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    uint32_t f0[4] = {0, 0, 0, 0}, f1[4] = {0, 0, 0, 0};
    const int off = (lane % 16) * KP + ks * 16 + (lane / 16) * 8;
    if (need0) ldsm_x4(f0, a0 + off);
    if (need1) ldsm_x4(f1, a1 + off);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b[2];
      ldsm_x2(b, w + (w_row0 + 8 * j + lane % 8) * wp + k0 + ks * 16 +
                     ((lane / 8) % 2) * 8);
      const bool first = w_row0 + 8 * j < split;
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = first ? f0[i] : f1[i];
      mma_bf16(acc[j], a, b[0], b[1]);
    }
  }
}

// (a) QKV projection + attention of one head over a strided list of groups
// (blockIdx.y = head, groups blockIdx.x, + gridDim.x, ...).  Writes the
// head's outputs, rounded to bf16, into columns [h*DH, h*DH + DH) of
// o (tokens x C, window order).
template <int DH, bool SMALL>
__global__ void __launch_bounds__(fused_warps(SMALL) * 32, SMALL ? 2 : 1)
fused_attn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ pos,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ w_in,
                  const float* __restrict__ b_in,
                  const float* __restrict__ bias, bf16* __restrict__ o,
                  Geom g, int n_groups, int C) {
  constexpr int WARPS = fused_warps(SMALL), NTHR = WARPS * 32;
  constexpr int QP = DH + 8;             // Q/K/V row pitch
  constexpr int WCOLS = 3 * DH / (WARPS / 4);  // projection columns of a warp
  constexpr int NT = WCOLS / 8;          // its n8 tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = g.L, Lr = group_rows(L), Lp = (L + 15) / 16 * 16;
  const int wp = w_pitch(C);
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int NS = ring_stages(SMALL);
  constexpr bool BIAS_SMEM = SMALL;      // the head's bias table in smem
  const bool bias_smem = BIAS_SMEM && bias != nullptr;
  const int bp = bias_pitch(L);

  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);        // 3DH x wp
  bf16* stage = Ws + 3 * DH * wp;                       // [NS][x, xp][64][KP]
  bf16* Qs = stage + NS * 2 * PROJ_ROWS * KP;           // Lr x QP
  bf16* Ks = Qs + Lr * QP;
  bf16* Vs = Ks + Lr * QP;
  bf16* Bs = Vs + Lr * QP;                              // L x L (bias_smem)
  signed char* kflag = reinterpret_cast<signed char*>(
      reinterpret_cast<unsigned char*>(Bs) +
      (bias_smem ? round16((size_t)L * bp * 2) : 0));

  // the block's work, flattened: (group i, row tile, channel chunk)
  const int n_kc = C / KC, n_rt = Lr / PROJ_ROWS;
  const int per_group = n_rt * n_kc;
  const int my_groups = (n_groups - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int total = my_groups * per_group;
  // the first FT threads copy: row tid / 4, channels (tid % 4) * 16 + [0, 16)
  const bool copier = tid < FT;
  const int cp_row = (tid % FT) / 4, cp_ch = (tid % 4) * 2;

  // starts the copies of step s into ring slot s % NS: its row of x and
  // pos.  A group is committed for every step, empty past the end, so that
  // cp_async_wait<NS - 2> always leaves the current step complete.
  auto fetch = [&](int s) {
    if (s >= total || !copier) {
      cp_async_commit();
      return;
    }
    const int i = s / per_group, rem = s - i * per_group;
    const int rt = rem / n_kc, kc = rem - rt * n_kc;
    const long long grp = blockIdx.x + (long long)i * gridDim.x;
    const int r = rt * PROJ_ROWS + cp_row;
    const bool valid = r < L;
    const long long off =
        valid ? g.pixel(grp * L + r) * C + kc * KC + cp_ch * 8 : 0;
    bf16* xs = stage + ((s % NS) * 2) * PROJ_ROWS * KP + cp_row * KP + cp_ch * 8;
    bf16* ps = xs + PROJ_ROWS * KP;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      cp_async16(xs + c * 8, x + off + c * 8, valid);
      cp_async16(ps + c * 8, pos + off + c * 8, valid);
    }
    cp_async_commit();
  };

  const float inv_scale = 1.f / round_to<bf16>(sqrtf((float)DH));
  const int wm = warp % 4, wn = warp / 4;               // projection warp tile
  int step = 0;
  for (int s = 0; s < NS - 1; ++s) fetch(s);
  // the padding flags of keys tid and tid + NTHR of a group, loaded one group
  // ahead so that their latency hides behind the current group's work
  uint8_t pads[2];
  auto load_pads = [&](long long grp) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = tid + u * NTHR;
      pads[u] = grp < n_groups && j < L ? mask[g.pixel(grp * L + j)] : 0;
    }
  };
  load_pads(blockIdx.x);
  // while the first stages and flags are in flight:
  // the head's Wq, Wk, Wv rows, rounded to bf16 once
  weights_to_smem<NTHR>(Ws, wp, w_in, 3 * DH, C, [&](int n) {
    const int z = n / DH;
    return z * C + h * DH + (n - z * DH);
  });
  const float* bias_h = bias ? bias + (long long)h * L * L : nullptr;
  if (bias_smem)
    for (int e0 = tid; e0 < L * L; e0 += 16 * NTHR) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (e0 + u * NTHR < L * L) v[u] = __ldg(bias_h + e0 + u * NTHR);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int e = e0 + u * NTHR, r = e / L;
        if (e < L * L) Bs[r * bp + e - r * L] = __float2bfloat16(v[u]);
      }
    }

  for (int i = 0; i < my_groups; ++i) {
    const long long grp = blockIdx.x + (long long)i * gridDim.x;
    __syncthreads();                     // the last group's attention is done
    int any_valid = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = tid + u * NTHR;
      if (j < L) {
        kflag[j] = pads[u] ? 1 : 0;
        any_valid |= !pads[u];
      } else if (j < Lr) {
        kflag[j] = 2;
      }
    }
    load_pads(grp + gridDim.x);
    // a group whose keys are all padding is opened; keys past L never are
    const bool open = !__syncthreads_or(any_valid);

    for (int rt = 0; rt < n_rt; ++rt) {
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
      for (int kc = 0; kc < n_kc; ++kc, ++step) {
        cp_async_wait<NS - 2>();
        if (copier) {  // x + pos in bf16 over this thread's pos chunks, 16
                       // bytes at a time (a quarter warp's accesses hit 8 bank groups)
          bf16* xs = stage + ((step % NS) * 2) * PROJ_ROWS * KP + cp_row * KP +
                     cp_ch * 8;
          uint4* p16 = reinterpret_cast<uint4*>(xs + PROJ_ROWS * KP);
          const uint4* x16 = reinterpret_cast<const uint4*>(xs);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint4 xv = x16[c], pv = p16[c];
            __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&xv);
            const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&pv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 xf = __bfloat1622float2(x2[e]);
              const float2 pf = __bfloat1622float2(p2[e]);
              x2[e] = __floats2bfloat162_rn(xf.x + pf.x, xf.y + pf.y);
            }
            p16[c] = xv;
          }
        }
        __syncthreads();
        fetch(step + NS - 1);
        const bf16* xs = stage + ((step % NS) * 2) * PROJ_ROWS * KP + wm * 16 * KP;
        stage_mma<NT>(acc, xs + PROJ_ROWS * KP, xs, 2 * DH, Ws, wp, wn * WCOLS,
                      kc * KC, lane);
      }
      // + bias in f32, rounded once, into Q/K/V
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn * WCOLS + 8 * j + 2 * (lane % 4);
        const int z = n / DH, d = n - z * DH;
        const float b0 = round_to<bf16>(__ldg(b_in + z * C + h * DH + d));
        const float b1 = round_to<bf16>(__ldg(b_in + z * C + h * DH + d + 1));
        bf16* dst = Qs + z * Lr * QP + d;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rt * PROJ_ROWS + wm * 16 + lane / 4 + half * 8;
          *reinterpret_cast<__nv_bfloat162*>(dst + r * QP) =
              __floats2bfloat162_rn(acc[j][2 * half] + b0,
                                    acc[j][2 * half + 1] + b1);
        }
      }
    }
    __syncthreads();                     // Q, K, V and the key flags are in

    for (int qt = warp; qt < Lp / 16; qt += WARPS) {
      uint32_t qa[DH / 16][4];
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        ldsm_x4(qa[ks], Qs + (qt * 16 + lane % 16) * QP + ks * 16 + (lane / 16) * 8);
      float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
      float oacc[DH / 8][4];
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) oacc[j][c] = 0.f;
      const int r0 = qt * 16 + lane / 4;               // rows r0 and r0 + 8

      for (int k0 = 0; k0 < Lr; k0 += KEY_TILE) {
        float s[KEY_TILE / 8][4];
#pragma unroll
        for (int j = 0; j < KEY_TILE / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
        }
        // past 64 keys the tile's bias comes from L2, loaded ahead of the
        // products so that its latency overlaps them
        float bv[KEY_TILE / 8][4];
        if (!BIAS_SMEM && bias_h != nullptr) {
#pragma unroll
          for (int j = 0; j < KEY_TILE / 8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int r = r0 + (c / 2) * 8;
              const int key = k0 + j * 8 + 2 * (lane % 4) + (c % 2);
              bv[j][c] = r < L && key < L
                             ? __ldg(bias_h + (long long)r * L + key) : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < KEY_TILE / 8; j += 2) {
#pragma unroll
          for (int ks = 0; ks < DH / 16; ++ks) {
            uint32_t b[4];
            ldsm_x4(b, Ks + (k0 + j * 8 + lane % 8 + (lane / 16) * 8) * QP +
                           ks * 16 + ((lane / 8) % 2) * 8);
            mma_bf16(s[j], qa[ks], b[0], b[1]);
            mma_bf16(s[j + 1], qa[ks], b[2], b[3]);
          }
        }
        // scale, bias, key mask; the tile's row maxima
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < KEY_TILE / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = r0 + (c / 2) * 8;
            const int key = k0 + j * 8 + 2 * (lane % 4) + (c % 2);
            float v = s[j][c] * inv_scale;
            if (bias_h != nullptr && r < L && key < L)
              v += BIAS_SMEM ? __bfloat162float(Bs[r * bp + key])
                             : round_to<bf16>(bv[j][c]);
            const int f = kflag[key];
            if (f == 2) v = -INFINITY;
            else if (f == 1 && !open) v = -FLT_MAX;
            s[j][c] = v;
            tmax[c / 2] = fmaxf(tmax[c / 2], v);
          }
        }
        float corr[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          tmax[u] = fmaxf(tmax[u], __shfl_xor_sync(0xffffffffu, tmax[u], 1));
          tmax[u] = fmaxf(tmax[u], __shfl_xor_sync(0xffffffffu, tmax[u], 2));
          const float mn = fmaxf(m[u], tmax[u]);
          corr[u] = __expf(m[u] - mn);             // 0 on the first tile
          m[u] = mn;
          lsum[u] *= corr[u];
        }
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          oacc[j][0] *= corr[0];
          oacc[j][1] *= corr[0];
          oacc[j][2] *= corr[1];
          oacc[j][3] *= corr[1];
        }
        // P = exp(S - m) in f32, rounded to bf16 into the A operand of P V
#pragma unroll
        for (int kk = 0; kk < KEY_TILE / 16; ++kk) {
          uint32_t pa[4];
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int j = 2 * kk + t;
            const float p0 = __expf(s[j][0] - m[0]), p1 = __expf(s[j][1] - m[0]);
            const float p2 = __expf(s[j][2] - m[1]), p3 = __expf(s[j][3] - m[1]);
            lsum[0] += p0 + p1;
            lsum[1] += p2 + p3;
            pa[2 * t] = pack_bf16(p0, p1);
            pa[2 * t + 1] = pack_bf16(p2, p3);
          }
#pragma unroll
          for (int dn = 0; dn < DH / 16; ++dn) {
            uint32_t b[4];
            ldsm_x4_t(b, Vs + (k0 + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * QP +
                             dn * 16 + (lane / 16) * 8);
            mma_bf16(oacc[2 * dn], pa, b[0], b[1]);
            mma_bf16(oacc[2 * dn + 1], pa, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        lsum[u] += __shfl_xor_sync(0xffffffffu, lsum[u], 1);
        lsum[u] += __shfl_xor_sync(0xffffffffu, lsum[u], 2);
        lsum[u] = 1.f / lsum[u];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = r0 + u * 8;
        if (r >= L) continue;
        bf16* dst = o + (grp * L + r) * C + h * DH + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
              __floats2bfloat162_rn(oacc[j][2 * u] * lsum[u],
                                    oacc[j][2 * u + 1] * lsum[u]);
      }
    }
  }
}

// (b) out = O Wo^T + bo through the merge addressing: a block owns output
// columns [64 blockIdx.y, + 64), keeps those Wo rows in bf16 and walks row
// tiles of 128 tokens (blockIdx.x, + gridDim.x, ...); warp w takes rows
// [16w, 16w + 16) of a tile.
__global__ void __launch_bounds__(FT, 2)
out_proj_kernel(const bf16* __restrict__ o, const float* __restrict__ w_out,
                const float* __restrict__ b_out, bf16* __restrict__ out,
                Geom g, long long M, int C) {
  constexpr int NT = OUT_COLS / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int wp = w_pitch(C), n0 = blockIdx.y * OUT_COLS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);         // OUT_COLS x wp
  bf16* stage = Ws + OUT_COLS * wp;                      // [OUT_NS][128][KP]


  const int n_kc = C / KC;
  const long long n_tiles = (M + OUT_ROWS - 1) / OUT_ROWS;
  const int my_tiles =
      (int)((n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const int total = my_tiles * n_kc;
  // chunk tid % 8 of rows tid / 8 + 32 u: eight neighbouring threads read
  // one row's 128 bytes, so each 32-byte sector is asked of L2 once
  const int cp_row = tid / 8, cp_ch = tid % 8;
  constexpr int CP_ROWS = FT / 8;

  auto fetch = [&](int s) {              // committed for every step
    if (s >= total) {
      cp_async_commit();
      return;
    }
    const int i = s / n_kc, kc = s - i * n_kc;
    const long long t0 =
        (blockIdx.x + (long long)i * gridDim.x) * OUT_ROWS + cp_row;
    bf16* dst = stage + (s % OUT_NS) * OUT_ROWS * KP + cp_row * KP + cp_ch * 8;
#pragma unroll
    for (int u = 0; u < OUT_ROWS / CP_ROWS; ++u) {
      const long long t = t0 + u * CP_ROWS;
      const bool valid = t < M;
      cp_async16(dst + u * CP_ROWS * KP,
                 o + (valid ? t * C + kc * KC + cp_ch * 8 : 0), valid);
    }
    cp_async_commit();
  };

  float bo[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    bo[j][0] = round_to<bf16>(__ldg(b_out + n));
    bo[j][1] = round_to<bf16>(__ldg(b_out + n + 1));
  }
  int step = 0;
  for (int s = 0; s < OUT_NS - 1; ++s) fetch(s);
  // while the first stages are in flight: the block's Wo rows
  weights_to_smem<FT>(Ws, wp, w_out, OUT_COLS, C, [&](int n) { return n0 + n; });
  for (int i = 0; i < my_tiles; ++i) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
    for (int kc = 0; kc < n_kc; ++kc, ++step) {
      cp_async_wait<OUT_NS - 2>();
      __syncthreads();
      fetch(step + OUT_NS - 1);
      const bf16* a = stage + (step % OUT_NS) * OUT_ROWS * KP + warp * 16 * KP;
      stage_mma<NT>(acc, a, a, 1 << 30, Ws, wp, 0, kc * KC, lane);
    }
    const long long t0 =
        (blockIdx.x + (long long)i * gridDim.x) * OUT_ROWS + warp * 16 + lane / 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long t = t0 + half * 8;
      if (t >= M) continue;
      bf16* dst = out + g.pixel(t) * C + n0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * half] + bo[j][0],
                                  acc[j][2 * half + 1] + bo[j][1]);
    }
  }
}

// The fused route takes bf16, C a multiple of 64, head dim 16, 32 or 64,
// and a block that fits the card's shared memory.
bool fused_ok(int dtype, int C, int heads, int L, bool bias) {
  if (dtype != 1 || C % KC != 0 || C % heads != 0) return false;
  const int dh = C / heads;
  if ((dh != 16 && dh != 32 && dh != 64) || L > 2 * FT) return false;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return fused_smem(C, dh, L, bias) <= (size_t)optin &&
         out_proj_smem(C) <= (size_t)optin;
}

// Blocks of one wave: resident blocks per SM x SMs, at most `work`.
template <typename K>
cudaError_t one_wave(K kernel, int threads, size_t smem, long long work,
                     int per_unit, unsigned* blocks) {
  int dev = 0, n_sm = 0, occ = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  long long n = (long long)occ * n_sm / per_unit;
  n = n < 1 ? 1 : (n > work ? work : n);
  *blocks = (unsigned)n;
  return cudaSuccess;
}

template <int DH, bool SMALL>
cudaError_t launch_fused(const bf16* x, const bf16* pos, const uint8_t* mask,
                         const float* w_in, const float* b_in,
                         const float* w_out, const float* b_out,
                         const float* bias, bf16* o, bf16* out, Geom g,
                         long long n_groups, int C, int heads,
                         cudaStream_t stream) {
  cudaError_t err;
  const size_t smem = fused_smem(C, DH, g.L, bias != nullptr);
  if ((err = allow_smem(fused_attn_kernel<DH, SMALL>, smem)) != cudaSuccess)
    return err;
  unsigned gx = 0;
  constexpr int threads = fused_warps(SMALL) * 32;
  if ((err = one_wave(fused_attn_kernel<DH, SMALL>, threads, smem, n_groups,
                      heads, &gx)) != cudaSuccess)
    return err;
  fused_attn_kernel<DH, SMALL><<<dim3(gx, heads), threads, smem, stream>>>(
      x, pos, mask, w_in, b_in, bias, o, g, (int)n_groups, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long M = n_groups * g.L;
  const size_t smem2 = out_proj_smem(C);
  if ((err = allow_smem(out_proj_kernel, smem2)) != cudaSuccess) return err;
  const int n_slices = C / OUT_COLS;
  if ((err = one_wave(out_proj_kernel, FT, smem2, (M + OUT_ROWS - 1) / OUT_ROWS,
                      n_slices, &gx)) != cudaSuccess)
    return err;
  out_proj_kernel<<<dim3(gx, n_slices), FT, smem2, stream>>>(o, w_out, b_out,
                                                             out, g, M, C);
  return cudaGetLastError();
}

// Float32, or bf16 shapes that the fused route does not take: the three
// CUDA-core kernels through the Q/K/V scratch `qkv`.
template <typename T>
cudaError_t launch_cuda_cores(const void* x, const void* pos,
                              const uint8_t* mask, const float* w_in,
                              const float* b_in, const float* w_out,
                              const float* b_out, const float* bias, void* qkv,
                              void* o, void* out, Geom g, long long n_win,
                              int C, int heads, cudaStream_t stream) {
  if (qkv == nullptr) return cudaErrorInvalidValue;
  const long long M = n_win * g.L;
  const int dh = C / heads;
  const unsigned m_blocks = (unsigned)((M + BM - 1) / BM);
  const T* xt = static_cast<const T*>(x);
  T* qt = static_cast<T*>(qkv);
  T* ot = static_cast<T*>(o);
  cudaError_t err;
  proj_kernel<T, true><<<dim3(m_blocks, (C + BN - 1) / BN, 3), PROJ_THREADS,
                         0, stream>>>(xt, static_cast<const T*>(pos), w_in,
                                      b_in, qt, g, M, C, heads);
  const size_t smem = attn_smem_floats(g.L, dh) * sizeof(float);
  if ((err = allow_smem(attn_kernel<T>, smem)) != cudaSuccess) return err;
  attn_kernel<T><<<dim3((unsigned)(n_win * heads), (g.L + TQ - 1) / TQ),
                   ATTN_THREADS, smem, stream>>>(qt, mask, bias, ot, g, M, C,
                                                 heads);
  proj_kernel<T, false><<<dim3(m_blocks, (C + BN - 1) / BN, 1), PROJ_THREADS,
                          0, stream>>>(ot, nullptr, w_out, b_out,
                                       static_cast<T*>(out), g, M, C, heads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when a call of these shapes takes the fused tensor-core route (and
// needs no `qkv` scratch), else 0.
int window_attn_fused(int dtype, int C, int heads, int L, int has_bias) {
  return fused_ok(dtype, C, heads, L, has_bias != 0) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, pos, qkv, o, out).  Weights and
// biases are float32; mask is (B, Hp, Wp) bool (one byte each); bias is
// (heads, L, L) float32 or NULL.  o: B*Hp*Wp*C elements of scratch; qkv:
// 3 * B*Hp*Wp*C elements, only for the CUDA-core route (else NULL).
int window_attn_fwd(const void* x, const void* pos, const void* mask,
                    const void* w_in, const void* b_in, const void* w_out,
                    const void* b_out, const void* bias, void* qkv, void* o,
                    void* out, int dtype, int B, int Hp, int Wp, int C,
                    int heads, int wh, int ww, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{Hp, Wp, wh, ww, Hp / wh, Wp / ww, wh * ww};
  const long long n_win = (long long)B * g.nwh * g.nww;
  const uint8_t* m8 = static_cast<const uint8_t*>(mask);
  const float* fw_in = static_cast<const float*>(w_in);
  const float* fb_in = static_cast<const float*>(b_in);
  const float* fw_out = static_cast<const float*>(w_out);
  const float* fb_out = static_cast<const float*>(b_out);
  const float* fbias = static_cast<const float*>(bias);
  if (n_win == 0) return 0;
  if (dtype == 0)
    return (int)launch_cuda_cores<float>(x, pos, m8, fw_in, fb_in, fw_out,
                                         fb_out, fbias, qkv, o, out, g, n_win,
                                         C, heads, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!fused_ok(dtype, C, heads, g.L, bias != nullptr))
    return (int)launch_cuda_cores<bf16>(x, pos, m8, fw_in, fb_in, fw_out,
                                        fb_out, fbias, qkv, o, out, g, n_win,
                                        C, heads, s);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* pb = static_cast<const bf16*>(pos);
  bf16* ob = static_cast<bf16*>(o);
  bf16* outb = static_cast<bf16*>(out);
  const bool bs = g.L <= SMALL_L;
#define K2_FUSED(DH, BS)                                                     \
  launch_fused<DH, BS>(xb, pb, m8, fw_in, fb_in, fw_out, fb_out, fbias, ob,  \
                       outb, g, n_win, C, heads, s)
  switch (C / heads) {
    case 16:
      return (int)(bs ? K2_FUSED(16, true) : K2_FUSED(16, false));
    case 32:
      return (int)(bs ? K2_FUSED(32, true) : K2_FUSED(32, false));
    default:
      return (int)(bs ? K2_FUSED(64, true) : K2_FUSED(64, false));
  }
#undef K2_FUSED
}

}  // extern "C"
