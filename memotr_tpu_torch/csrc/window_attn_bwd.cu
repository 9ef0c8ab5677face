// Fused window attention (K2), backward, for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel's custom VJP: `_bwd` of
// `window_attention_pallas` (memotr_tpu/ops/window_attn.py:263), which is
// jax.vjp of `window_attention_xla` (:61).  This file is the attention
// core of that VJP; the wrapper (ops/window_attn_cuda.py,
// `window_attention_bwd`) does the projection products around it with
// torch.matmul, as the JAX package leaves them to XLA.
//
// Per (group, head), with a group one window or grid group of L tokens,
// Q, K, V its projected rows (head dim dh), dO the cotangent of the head
// outputs and scale = sqrt(dh) rounded to the activation dtype:
//
//   S  = Q K^T / scale + bias[h], keys masked where padded (a group whose
//        keys are all padding is opened), P = softmax_f32(S) (recomputed
//        over the group's keys, its row max and sum in float32);
//   dV = P^T dO;  dP = dO V^T;  dS = P o (dP - rowsum(P o dP));
//   dQ = dS K / scale;  dK = dS^T Q / scale;  dBias[h] += dS (over groups).
//
// rowsum(P o dP) is rowsum(dO o O) of FlashAttention's backward, taken
// from P and dP themselves, so that no head-output map (rounded to bf16 by
// the forward) is read.  A padded key has P = 0, so dS and the bias
// gradient are 0 there; an opened group's keys all pass gradients, as in
// JAX's VJP.
//
// What bounds it.  At window level 0 of the 896x1536 training canvas
// (B=1, 112x192 tokens, C=256, 8 heads, dh=32) the five products do
// 10 L C flops a token: 3.5 GFLOP in windows of L=64, 18.5 GFLOP in grid
// groups of L=336, 0.0036 / 0.019 ms at the 989 TFLOP/s bf16 tensor-core
// peak.  The bytes it must move (Q, K, V, dO read, dQ, dK, dV written, in
// bf16: 14 C bytes a token, ~77 MB) take ~0.023 ms at 3.35 TB/s.  So the
// attention core alone is bound by bytes at these widths, the whole call
// (with the wrapper's 16 C^2 flops a token of projection products) by
// operations.  The bias gradient is a reduction across blocks: 336
// windows share one (8, 64, 64) table, 64 grid groups one (8, 336, 336)
// table of 3.6 MB that fits no block's shared memory.
//
// Design.  A block owns one head and walks a strided list of groups,
// gathering each group's rows through the window partition addressing (the
// forward's `Geom`, so no permuted copy of any map exists).  Two routes,
// chosen by what the call's dtype and head dim allow, as the forward's:
//
//   bfloat16 at head dim 16, 32 or 64 (attn_bwd_tc_kernel): Q, K, V and dO
//   of the group in shared memory as bf16, and every product on the tensor
//   cores (mma.sync m16n8k16 fed by ldmatrix, float32 accumulation) over
//   16 x 16 tiles of the (query, key) square, in three passes whose
//   elementwise work stays in the accumulator registers: A, warps over
//   query tiles, S and dP with an online max, sum and sum of P dP -> each
//   row's log-sum-exp and rowsum(P o dP); B, warps over key tiles, S^T and
//   dP^T again, P^T and dS^T rounded to bf16 as the A operands of dV and
//   dK, which stay in registers across the query tiles; C, warps over
//   query tiles, S and dP again, dS as the A operand of dQ, in registers
//   across the key tiles.  S and dP are computed three times (7 products
//   where 5 are needed) so that no warp shares a tile of dQ, dK or dV with
//   another: a first version that added dQ from pass B by float32
//   shared-memory atomics spent 55-58% of its time in them.
//
//   float32, and the other head dims (attn_bwd_kernel): CUDA-core FMAs,
//   K and V as float32 in shared memory, the group's queries in tiles of
//   TQ rows (32, or 16 / 8 where shared memory needs it): S and dP for the
//   tile's full rows, the exact softmax and dS per row by one warp, dQ for
//   the tile written at once, dK / dV accumulated in shared memory.
//
// The bias gradient is summed in shared memory over the block's groups
// where the (L, L) table fits beside the rest (L <= ~100-128), and added
// once per block by float32 atomics into the zeroed table; larger groups
// add each dS element by a float32 atomic.  Atomics add in an order that
// changes from run to run (float32 rounding, ~1e-7 relative of the
// table's sums).  Left for later: the bias table in shared memory as the
// forward keeps it (its reads from L2 are a sixth to a quarter of the
// tensor-core route's time), wgmma, and the projection products fused in.
//
// Interface: plain C, loaded with ctypes; the caller allocates every
// buffer (dbias zeroed) and owns the stream.  Returns cudaGetLastError()
// after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
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

// a float32 value rounded to T, as the forward rounds the bias table
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// Window partition addressing of a padded (B, Hp, Wp, C) map, as in
// window_attn_fwd.cu: token t = group * L + l, groups in (b, window row,
// window column) order, members row-major inside a group.
struct Geom {
  int Hp, Wp, wh, ww, nwh, nww, L;

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

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;

// Shared memory of one block, in floats: K and V (rows padded to dh + 1:
// the S and dP loops read them across keys), the dK / dV accumulators, the
// tile's Q and dO rows, P and dP / dS of the tile's rows, the key flags,
// the rows' rowsum(P o dP), and the bias-gradient table when summed here.
size_t bwd_smem_floats(int L, int dh, int tq, bool bias_acc) {
  return (size_t)2 * L * (dh + 1) + (size_t)2 * L * dh + (size_t)2 * tq * dh +
         (size_t)2 * tq * L + L + tq + (bias_acc ? (size_t)L * L : 0);
}

int smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin;
}

// The query tile (32, 16 or 8 rows) and whether the bias gradient is summed
// in shared memory, for the largest configuration that fits; tile 0 when
// none does.
void bwd_config(int L, int dh, bool has_bias, int* tq, bool* bias_acc) {
  const size_t optin = (size_t)smem_optin();
  *tq = 0;
  *bias_acc = false;
  for (int t = 32; t >= 8; t /= 2) {
    if (bwd_smem_floats(L, dh, t, false) * 4 > optin) continue;
    *tq = t;
    *bias_acc = has_bias && bwd_smem_floats(L, dh, t, true) * 4 <= optin &&
                L <= 128;
    return;
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
attn_bwd_kernel(const T* __restrict__ qk, const T* __restrict__ v,
                const T* __restrict__ d_o, const uint8_t* __restrict__ mask,
                const float* __restrict__ bias, T* __restrict__ dqkv,
                float* __restrict__ dbias, Geom g, int n_groups, int C,
                int heads, int TQ, bool bias_acc) {
  extern __shared__ __align__(16) float smem[];
  const int L = g.L, dh = C / heads, dp = dh + 1;
  float* Ks = smem;
  float* Vs = Ks + (size_t)L * dp;
  float* dKs = Vs + (size_t)L * dp;
  float* dVs = dKs + (size_t)L * dh;
  float* Qs = dVs + (size_t)L * dh;
  float* dOs = Qs + TQ * dh;
  float* P = dOs + TQ * dh;
  float* dS = P + (size_t)TQ * L;      // dP, then dS in place
  float* kpad = dS + (size_t)TQ * L;
  float* delta = kpad + L;
  float* dB = delta + TQ;              // (L, L) when bias_acc

  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale = round_to<T>(sqrtf((float)dh));
  const float* bias_h = bias ? bias + (long long)h * L * L : nullptr;
  float* dbias_h = dbias ? dbias + (long long)h * L * L : nullptr;
  const long long C2 = 2LL * C, C3 = 3LL * C;
  const int hc = h * dh;

  if (bias_acc)
    for (int e = tid; e < L * L; e += BWD_THREADS) dB[e] = 0.f;

  for (long long grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    __syncthreads();                   // the last group's dK / dV are out
    for (int e = tid; e < L * dh; e += BWD_THREADS) {
      const int j = e / dh, d = e - j * dh;
      const long long p = g.pixel(grp * L + j);
      Ks[j * dp + d] = to_f32(qk[p * C2 + C + hc + d]);
      Vs[j * dp + d] = to_f32(v[p * C + hc + d]);
      dKs[e] = 0.f;
      dVs[e] = 0.f;
    }
    int any_valid = 0;
    for (int j = tid; j < L; j += BWD_THREADS) {
      const bool pad = mask[g.pixel(grp * L + j)] != 0;
      kpad[j] = pad ? 1.f : 0.f;
      any_valid |= !pad;
    }
    // a group whose keys are all padding is opened (barrier as well)
    const bool open = !__syncthreads_or(any_valid);

    for (int q0 = 0; q0 < L; q0 += TQ) {
      const int nq = min(TQ, L - q0);
      for (int e = tid; e < nq * dh; e += BWD_THREADS) {
        const int i = e / dh, d = e - i * dh;
        const long long p = g.pixel(grp * L + q0 + i);
        Qs[e] = to_f32(qk[p * C2 + hc + d]);
        dOs[e] = to_f32(d_o[p * C + hc + d]);
      }
      __syncthreads();

      // S (into P) and dP (into dS) for the tile's full rows
      for (int e = tid; e < nq * L; e += BWD_THREADS) {
        const int i = e / L, j = e - i * L;
        const float* qr = Qs + i * dh;
        const float* gr = dOs + i * dh;
        const float* kr = Ks + j * dp;
        const float* vr = Vs + j * dp;
        float s = 0.f, dpv = 0.f;
        for (int d = 0; d < dh; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dpv = fmaf(gr[d], vr[d], dpv);
        }
        s = s / scale;
        if (bias_h) s += round_to<T>(bias_h[(long long)(q0 + i) * L + j]);
        if (!open && kpad[j] != 0.f) s = -FLT_MAX;
        P[e] = s;
        dS[e] = dpv;
      }
      __syncthreads();

      // per row: exact softmax, rowsum(P o dP), dS = P (dP - rowsum), the
      // bias gradient
      for (int i = warp; i < nq; i += BWD_WARPS) {
        float* pr = P + (size_t)i * L;
        float* sr = dS + (size_t)i * L;
        float mx = -FLT_MAX;
        for (int j = lane; j < L; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
        for (int k = 16; k > 0; k >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, k));
        float sum = 0.f;
        for (int j = lane; j < L; j += 32) {
          const float e = expf(pr[j] - mx);
          pr[j] = e;
          sum += e;
        }
#pragma unroll
        for (int k = 16; k > 0; k >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, k);
        const float inv = 1.f / sum;
        float dot = 0.f;
        for (int j = lane; j < L; j += 32) {
          const float pv = pr[j] * inv;
          pr[j] = pv;
          dot = fmaf(pv, sr[j], dot);
        }
#pragma unroll
        for (int k = 16; k > 0; k >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, k);
        const long long row = (long long)(q0 + i) * L;
        for (int j = lane; j < L; j += 32) {
          const float ds = pr[j] * (sr[j] - dot);
          sr[j] = ds;
          if (bias_acc) dB[row + j] += ds;
          else if (dbias_h) atomicAdd(dbias_h + row + j, ds);
        }
      }
      __syncthreads();

      // dQ of the tile's rows (complete), written at once
      for (int e = tid; e < nq * dh; e += BWD_THREADS) {
        const int i = e / dh, d = e - i * dh;
        const float* sr = dS + (size_t)i * L;
        float acc = 0.f;
        for (int j = 0; j < L; ++j) acc = fmaf(sr[j], Ks[j * dp + d], acc);
        const long long p = g.pixel(grp * L + q0 + i);
        dqkv[p * C3 + hc + d] = from_f32<T>(acc / scale);
      }
      // dK += dS^T Q, dV += P^T dO over the tile's rows
      for (int e = tid; e < L * dh; e += BWD_THREADS) {
        const int j = e / dh, d = e - j * dh;
        float ak = dKs[e], av = dVs[e];
        for (int i = 0; i < nq; ++i) {
          ak = fmaf(dS[(size_t)i * L + j], Qs[i * dh + d], ak);
          av = fmaf(P[(size_t)i * L + j], dOs[i * dh + d], av);
        }
        dKs[e] = ak;
        dVs[e] = av;
      }
      __syncthreads();                 // before the next tile overwrites
    }

    for (int e = tid; e < L * dh; e += BWD_THREADS) {
      const int j = e / dh, d = e - j * dh;
      const long long p = g.pixel(grp * L + j);
      dqkv[p * C3 + C + hc + d] = from_f32<T>(dKs[e] / scale);
      dqkv[p * C3 + C2 + hc + d] = from_f32<T>(dVs[e]);
    }
  }

  if (bias_acc && dbias_h) {
    __syncthreads();
    for (int e = tid; e < L * L; e += BWD_THREADS) atomicAdd(dbias_h + e, dB[e]);
  }
}

// Blocks a head of one wave: resident blocks per SM x SMs, shared out over
// the heads, at most the groups.
template <typename K>
cudaError_t blocks_per_head(K kernel, int threads, size_t smem,
                            long long n_groups, int heads, unsigned* out) {
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
  long long n = (long long)occ * n_sm / heads;
  n = n < 1 ? 1 : (n > n_groups ? n_groups : n);
  *out = (unsigned)n;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_bwd(const void* qk, const void* v, const void* d_o,
                       const uint8_t* mask, const float* bias, void* dqkv,
                       float* dbias, Geom g, long long n_groups, int C,
                       int heads, cudaStream_t stream) {
  const int dh = C / heads;
  int tq = 0;
  bool bias_acc = false;
  bwd_config(g.L, dh, bias != nullptr, &tq, &bias_acc);
  if (tq == 0) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem_floats(g.L, dh, tq, bias_acc) * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(attn_bwd_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  unsigned per_head = 0;
  if ((err = blocks_per_head(attn_bwd_kernel<T>, BWD_THREADS, smem, n_groups,
                             heads, &per_head)) != cudaSuccess)
    return err;
  attn_bwd_kernel<T><<<dim3(per_head, heads), BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(v),
      static_cast<const T*>(d_o), mask, bias, static_cast<T*>(dqkv), dbias, g,
      (int)n_groups, C, heads, tq, bias_acc);
  return cudaGetLastError();
}

// ---------------------------------------- tensor-core route (bfloat16)

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 8, TC_THREADS = TC_WARPS * 32;
// the bias-gradient table is summed in shared memory up to this L
constexpr int TC_BIAS_SMEM_L = 128;

__host__ __device__ inline int tc_rows(int L) { return (L + 15) / 16 * 16; }
__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// Shared memory of attn_bwd_tc_kernel: Q, K, V and dO of the group's rows
// (padded to 16, pitch dh + 8 in bf16), each row's log-sum-exp and
// rowsum(P o dP), the key flags, and the bias-gradient table where it is
// summed here.
size_t tc_smem(int L, int dh, bool bias_acc) {
  const size_t lp = tc_rows(L);
  return 4 * lp * (dh + 8) * 2 + 2 * lp * 4 + round16(lp) +
         (bias_acc ? (size_t)L * L * 4 : 0);
}

bool tc_ok(int dtype, int C, int heads, int L) {
  if (dtype != 1 || heads <= 0 || C % heads != 0) return false;
  const int dh = C / heads;
  if (dh != 16 && dh != 32 && dh != 64) return false;
  return tc_smem(L, dh, false) <= (size_t)smem_optin();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// One head (blockIdx.y) over a strided list of groups.  Per group, three
// passes over 16 x 16 tiles of the (query, key) square, every product an
// mma.sync m16n8k16 fed by ldmatrix, every tile's elementwise work in the
// accumulator registers:
//   A, warps over query tiles: S = Q K^T and dP = dO V^T over the keys, an
//      online max / sum / sum of P dP -> each row's log-sum-exp and
//      rowsum(P o dP);
//   B, warps over key tiles: S^T and dP^T again, P^T and dS^T, which are
//      already the A operands of dV += P^T dO and dK += dS^T Q, kept in
//      registers across the query tiles;
//   C, warps over query tiles: S and dP again, dS as the A operand of
//      dQ += dS K, kept in registers across the key tiles; the bias
//      gradient.
// No tile of dQ, dK or dV is shared between warps, so nothing is added
// atomically but the bias gradient across groups.
template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
attn_bwd_tc_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
                   const bf16* __restrict__ d_o,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ bias, bf16* __restrict__ dqkv,
                   float* __restrict__ dbias, Geom g, int n_groups, int C,
                   bool bias_acc) {
  constexpr int QP = DH + 8;           // 8 ldmatrix rows hit 8 bank groups
  constexpr int CH = DH / 8;           // 16-byte chunks of a head's row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = g.L, Lp = tc_rows(L), nt = Lp / 16;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + Lp * QP;
  bf16* Vs = Ks + Lp * QP;
  bf16* Gs = Vs + Lp * QP;                               // dO
  float* lse = reinterpret_cast<float*>(Gs + Lp * QP);
  float* delta = lse + Lp;
  signed char* kflag = reinterpret_cast<signed char*>(delta + Lp);
  float* dB = reinterpret_cast<float*>(kflag + round16(Lp));

  const float inv_scale = 1.f / round_to<bf16>(sqrtf((float)DH));
  const float* bias_h = bias ? bias + (long long)h * L * L : nullptr;
  float* dbias_h = dbias ? dbias + (long long)h * L * L : nullptr;
  const long long C2 = 2LL * C, C3 = 3LL * C;
  const int hc = h * DH;

  if (bias_acc)
    for (int e = tid; e < L * L; e += TC_THREADS) dB[e] = 0.f;

  for (long long grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    __syncthreads();                   // the last group's passes are done
    for (int e = tid; e < Lp * CH; e += TC_THREADS) {
      const int r = e / CH, c = (e - r * CH) * 8;
      uint4 q = make_uint4(0, 0, 0, 0), k = q, vv = q, gg = q;
      if (r < L) {
        const long long p = g.pixel(grp * L + r);
        q = *reinterpret_cast<const uint4*>(qk + p * C2 + hc + c);
        k = *reinterpret_cast<const uint4*>(qk + p * C2 + C + hc + c);
        vv = *reinterpret_cast<const uint4*>(v + p * C + hc + c);
        gg = *reinterpret_cast<const uint4*>(d_o + p * C + hc + c);
      }
      *reinterpret_cast<uint4*>(Qs + r * QP + c) = q;
      *reinterpret_cast<uint4*>(Ks + r * QP + c) = k;
      *reinterpret_cast<uint4*>(Vs + r * QP + c) = vv;
      *reinterpret_cast<uint4*>(Gs + r * QP + c) = gg;
    }
    int any_valid = 0;
    for (int j = tid; j < Lp; j += TC_THREADS) {
      signed char f = 2;               // past L: never a key
      if (j < L) {
        f = mask[g.pixel(grp * L + j)] ? 1 : 0;
        any_valid |= f == 0;
      }
      kflag[j] = f;
    }
    // a group whose keys are all padding is opened (barrier as well)
    const bool open = !__syncthreads_or(any_valid);

    // the bias of (query qi, key kj), rounded as the forward rounds it;
    // loaded ahead of a tile's products so that its latency overlaps them
    auto bias_at = [&](int qi, int kj) -> float {
      return bias_h != nullptr && qi < L && kj < L
                 ? round_to<bf16>(__ldg(bias_h + (long long)qi * L + kj))
                 : 0.f;
    };
    // the logit of key kj from its product and bias, masked as the forward
    auto logit = [&](float acc, float b, int kj) -> float {
      const int f = kflag[kj];
      if (f == 2) return -INFINITY;
      if (f == 1 && !open) return -FLT_MAX;
      return acc * inv_scale + b;
    };
    // s += A1 B1^T and dp += A2 B2^T over the head dim: A1, A2 the A
    // fragments of one 16-row tile, B1, B2 rows [t0, t0 + 16) of two of
    // Q, K, V, dO (S and dP, or S^T and dP^T)
    auto s_dp = [&](const uint32_t (&a1)[DH / 16][4],
                    const uint32_t (&a2)[DH / 16][4], const bf16* b1,
                    const bf16* b2, int t0, float (&s)[2][4],
                    float (&dp)[2][4]) {
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        const int off = (t0 + lane % 8 + (lane / 16) * 8) * QP + ks * 16 +
                        ((lane / 8) % 2) * 8;
        uint32_t b[4];
        ldsm_x4(b, b1 + off);
        mma_bf16(s[0], a1[ks], b[0], b[1]);
        mma_bf16(s[1], a1[ks], b[2], b[3]);
        ldsm_x4(b, b2 + off);
        mma_bf16(dp[0], a2[ks], b[0], b[1]);
        mma_bf16(dp[1], a2[ks], b[2], b[3]);
      }
    };
    auto load_a = [&](const bf16* base, int t, uint32_t (&a)[DH / 16][4]) {
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        ldsm_x4(a[ks], base + (t * 16 + lane % 16) * QP + ks * 16 +
                           (lane / 16) * 8);
    };

    // pass A: per query row, log-sum-exp and rowsum(P o dP)
    for (int qt = warp; qt < nt; qt += TC_WARPS) {
      uint32_t qa[DH / 16][4], ga[DH / 16][4];
      load_a(Qs, qt, qa);
      load_a(Gs, qt, ga);
      const int r0 = qt * 16 + lane / 4;           // rows r0 and r0 + 8
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
      for (int k0 = 0; k0 < Lp; k0 += 16) {
        float bv[2][4], s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bv[j][c] = bias_at(r0 + (c / 2) * 8, k0 + j * 8 + 2 * (lane % 4) + c % 2);
        s_dp(qa, ga, Ks, Vs, k0, s, dp);
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[j][c] = logit(s[j][c], bv[j][c], k0 + j * 8 + 2 * (lane % 4) + c % 2);
            tmax[c / 2] = fmaxf(tmax[c / 2], s[j][c]);
          }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          tmax[u] = fmaxf(tmax[u], __shfl_xor_sync(0xffffffffu, tmax[u], 1));
          tmax[u] = fmaxf(tmax[u], __shfl_xor_sync(0xffffffffu, tmax[u], 2));
          const float mn = fmaxf(m[u], tmax[u]);
          const float corr = __expf(m[u] - mn);    // 0 on the first tile
          m[u] = mn;
          l[u] *= corr;
          dd[u] *= corr;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = __expf(s[j][c] - m[c / 2]);
            l[c / 2] += p;
            dd[c / 2] = fmaf(p, dp[j][c], dd[c / 2]);
          }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
        l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
        dd[u] += __shfl_xor_sync(0xffffffffu, dd[u], 1);
        dd[u] += __shfl_xor_sync(0xffffffffu, dd[u], 2);
        const int r = r0 + u * 8;
        if (lane % 4 == 0) {           // rows past L take no probability
          lse[r] = r < L ? m[u] + __logf(l[u]) : INFINITY;
          delta[r] = r < L ? dd[u] / l[u] : 0.f;
        }
      }
    }
    __syncthreads();

    // pass B: dK and dV, per 16-key tile over every query tile
    for (int kt = warp; kt < nt; kt += TC_WARPS) {
      uint32_t ka[DH / 16][4], va[DH / 16][4];
      load_a(Ks, kt, ka);
      load_a(Vs, kt, va);
      float dk[DH / 8][4] = {}, dv[DH / 8][4] = {};
      const int j0 = kt * 16 + lane / 4;           // keys j0 and j0 + 8
      for (int qt = 0; qt < nt; ++qt) {
        float bv[2][4], st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bv[j][c] = bias_at(qt * 16 + j * 8 + 2 * (lane % 4) + c % 2,
                               j0 + (c / 2) * 8);
        // S^T and dP^T: K and V as A, Q and dO rows as B
        s_dp(ka, va, Qs, Gs, qt * 16, st, dpt);
        uint32_t pa[4], sa[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int q = qt * 16 + j * 8 + 2 * (lane % 4) + (c % 2);
            const float p = __expf(logit(st[j][c], bv[j][c], j0 + (c / 2) * 8) -
                                   lse[q]);
            st[j][c] = p;
            dpt[j][c] = p * (dpt[j][c] - delta[q]);
          }
          pa[2 * j] = pack_bf16(st[j][0], st[j][1]);
          pa[2 * j + 1] = pack_bf16(st[j][2], st[j][3]);
          sa[2 * j] = pack_bf16(dpt[j][0], dpt[j][1]);
          sa[2 * j + 1] = pack_bf16(dpt[j][2], dpt[j][3]);
        }
#pragma unroll
        for (int dn = 0; dn < DH / 16; ++dn) {
          const int off = (qt * 16 + lane % 8 + ((lane / 8) % 2) * 8) * QP +
                          dn * 16 + (lane / 16) * 8;
          uint32_t b[4];
          ldsm_x4_t(b, Gs + off);
          mma_bf16(dv[2 * dn], pa, b[0], b[1]);
          mma_bf16(dv[2 * dn + 1], pa, b[2], b[3]);
          ldsm_x4_t(b, Qs + off);
          mma_bf16(dk[2 * dn], sa, b[0], b[1]);
          mma_bf16(dk[2 * dn + 1], sa, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n8 = 0; n8 < DH / 8; ++n8)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = j0 + u * 8;
          if (key >= L) continue;
          const long long p = g.pixel(grp * L + key);
          bf16* dst = dqkv + p * C3 + hc + n8 * 8 + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(dst + C) = __floats2bfloat162_rn(
              dk[n8][2 * u] * inv_scale, dk[n8][2 * u + 1] * inv_scale);
          *reinterpret_cast<__nv_bfloat162*>(dst + C2) =
              __floats2bfloat162_rn(dv[n8][2 * u], dv[n8][2 * u + 1]);
        }
    }

    // pass C: dQ and the bias gradient, per 16-query tile over every key
    // tile (reads only what pass A wrote)
    for (int qt = warp; qt < nt; qt += TC_WARPS) {
      uint32_t qa[DH / 16][4], ga[DH / 16][4];
      load_a(Qs, qt, qa);
      load_a(Gs, qt, ga);
      const int r0 = qt * 16 + lane / 4;
      const float lr[2] = {lse[r0], lse[r0 + 8]};
      const float dr[2] = {delta[r0], delta[r0 + 8]};
      float dq[DH / 8][4] = {};
      for (int k0 = 0; k0 < Lp; k0 += 16) {
        float bv[2][4], s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bv[j][c] = bias_at(r0 + (c / 2) * 8, k0 + j * 8 + 2 * (lane % 4) + c % 2);
        s_dp(qa, ga, Ks, Vs, k0, s, dp);
        uint32_t sa[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int q = r0 + (c / 2) * 8;
            const int key = k0 + j * 8 + 2 * (lane % 4) + (c % 2);
            const float p = __expf(logit(s[j][c], bv[j][c], key) - lr[c / 2]);
            const float ds = p * (dp[j][c] - dr[c / 2]);
            s[j][c] = ds;
            if (dbias_h != nullptr && q < L && key < L) {
              if (bias_acc) dB[q * L + key] += ds;
              else atomicAdd(dbias_h + (long long)q * L + key, ds);
            }
          }
          sa[2 * j] = pack_bf16(s[j][0], s[j][1]);
          sa[2 * j + 1] = pack_bf16(s[j][2], s[j][3]);
        }
#pragma unroll
        for (int dn = 0; dn < DH / 16; ++dn) {
          uint32_t b[4];
          ldsm_x4_t(b, Ks + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * QP +
                           dn * 16 + (lane / 16) * 8);
          mma_bf16(dq[2 * dn], sa, b[0], b[1]);
          mma_bf16(dq[2 * dn + 1], sa, b[2], b[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = r0 + u * 8;
        if (r >= L) continue;
        const long long p = g.pixel(grp * L + r);
        bf16* dst = dqkv + p * C3 + hc + 2 * (lane % 4);
#pragma unroll
        for (int n8 = 0; n8 < DH / 8; ++n8)
          *reinterpret_cast<__nv_bfloat162*>(dst + n8 * 8) =
              __floats2bfloat162_rn(dq[n8][2 * u] * inv_scale,
                                    dq[n8][2 * u + 1] * inv_scale);
      }
    }
  }

  if (bias_acc && dbias_h) {
    __syncthreads();
    for (int e = tid; e < L * L; e += TC_THREADS) atomicAdd(dbias_h + e, dB[e]);
  }
}

template <int DH>
cudaError_t launch_bwd_tc(const void* qk, const void* v, const void* d_o,
                          const uint8_t* mask, const float* bias, void* dqkv,
                          float* dbias, Geom g, long long n_groups, int C,
                          int heads, cudaStream_t stream) {
  const bool bias_acc = bias != nullptr && g.L <= TC_BIAS_SMEM_L &&
                        tc_smem(g.L, DH, true) <= (size_t)smem_optin();
  const size_t smem = tc_smem(g.L, DH, bias_acc);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(attn_bwd_tc_kernel<DH>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  unsigned per_head = 0;
  if ((err = blocks_per_head(attn_bwd_tc_kernel<DH>, TC_THREADS, smem,
                             n_groups, heads, &per_head)) != cudaSuccess)
    return err;
  attn_bwd_tc_kernel<DH><<<dim3(per_head, heads), TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(qk), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), mask, bias, static_cast<bf16*>(dqkv),
      dbias, g, (int)n_groups, C, bias_acc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The route a call of these shapes takes: 2 the tensor-core kernel
// (bfloat16, head dim 16, 32 or 64, the group within shared memory), 1 the
// CUDA-core kernel, 0 none (its block would exceed the card's shared
// memory, and the call is refused).
int window_attn_bwd_route(int dtype, int C, int heads, int L, int has_bias) {
  if (heads <= 0 || C % heads != 0 || L <= 0 || (dtype != 0 && dtype != 1))
    return 0;
  if (tc_ok(dtype, C, heads, L)) return 2;
  int tq = 0;
  bool acc = false;
  bwd_config(L, C / heads, has_bias != 0, &tq, &acc);
  return tq ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (qk, v, d_o, dqkv).  qk: (B*Hp*Wp, 2C)
// the Q and K projections (bias added) in pixel order; v: (B*Hp*Wp, C) the
// V projection; d_o: (B*Hp*Wp, C) the cotangent of the head outputs, pixel
// order; mask: (B, Hp, Wp) bool; bias: (heads, L, L) float32 or NULL.
// Writes dqkv: (B*Hp*Wp, 3C) [dQ dK dV] of the projection outputs in pixel
// order, and adds the bias gradient into dbias (heads, L, L) float32,
// zeroed by the caller (NULL without bias).
int window_attn_bwd(const void* qk, const void* v, const void* d_o,
                    const void* mask, const void* bias, void* dqkv,
                    void* dbias, int dtype, int B, int Hp, int Wp, int C,
                    int heads, int wh, int ww, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{Hp, Wp, wh, ww, Hp / wh, Wp / ww, wh * ww};
  const long long n_groups = (long long)B * g.nwh * g.nww;
  if (n_groups == 0) return 0;
  if ((bias == nullptr) != (dbias == nullptr)) return (int)cudaErrorInvalidValue;
  const uint8_t* m8 = static_cast<const uint8_t*>(mask);
  const float* fb = static_cast<const float*>(bias);
  float* fdb = static_cast<float*>(dbias);
  if (dtype == 0)
    return (int)launch_bwd<float>(qk, v, d_o, m8, fb, dqkv, fdb, g, n_groups,
                                  C, heads, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!tc_ok(dtype, C, heads, g.L))
    return (int)launch_bwd<bf16>(qk, v, d_o, m8, fb, dqkv, fdb, g, n_groups,
                                 C, heads, s);
  switch (C / heads) {
    case 16:
      return (int)launch_bwd_tc<16>(qk, v, d_o, m8, fb, dqkv, fdb, g,
                                    n_groups, C, heads, s);
    case 32:
      return (int)launch_bwd_tc<32>(qk, v, d_o, m8, fb, dqkv, fdb, g,
                                    n_groups, C, heads, s);
    default:
      return (int)launch_bwd_tc<64>(qk, v, d_o, m8, fb, dqkv, fdb, g,
                                    n_groups, C, heads, s);
  }
}

}  // extern "C"
