// Fused window attention (K2), backward, for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel's custom VJP: `_bwd` of
// `window_attention_pallas` (memotr_tpu/ops/window_attn.py:263), which is
// jax.vjp of `window_attention_xla` (:61).  This file is the part of that
// VJP that works per window or grid group: the projections the attention
// core needs, the core, and the bias gradient.  The wrapper
// (ops/window_attn_cuda.py, `window_attention_bwd`) does the products that
// reduce over all tokens with torch.matmul, as the JAX package leaves them
// to XLA.
//
// Per (group, head), with a group one window or grid group of L tokens,
// Q, K, V its projected rows (head dim dh), dO the cotangent of the head
// outputs and scale = sqrt(dh) rounded to the activation dtype:
//
//   Q = (x + pos) Wq^T + bq, K = (x + pos) Wk^T + bk, V = x Wv^T + bv,
//   dO = gy Wo (gy the cotangent of the output);
//   S  = Q K^T / scale + bias[h], keys masked where padded (a group whose
//        keys are all padding is opened), P = softmax_f32(S) (recomputed
//        over the group's keys, its row max and sum in float32);
//   dV = P^T dO;  dP = dO V^T;  dS = P o (dP - rowsum(P o dP));
//   dQ = dS K / scale;  dK = dS^T Q / scale;  dBias[h] = sum_groups dS.
//
// rowsum(P o dP) is rowsum(dO o O) of FlashAttention's backward, taken
// from P and dP themselves, so that no head-output map (rounded to bf16 by
// the forward) is read.  A padded key has P = 0, so dS and the bias
// gradient are 0 there; an opened group's keys all pass gradients, as in
// JAX's VJP.
//
// What bounds it.  At window level 0 of the 896x1536 training canvas
// (B=1, 112x192 tokens, C=256, 8 heads, dh=32) the five attention products
// do 10 L C flops a token (3.5 GFLOP at L=64, 18.5 at the grid's L=336)
// and the four projections 8 C^2 (11.3 GFLOP): ~0.015-0.03 ms at the 989
// TFLOP/s bf16 peak; the bytes (x, pos, gy read, dQ, dK, dV written) take
// ~0.02 ms.  The first version of this file took 0.20 / 0.61 ms at L = 64
// / 336 behind two addmm and a matmul for Q/K/V and dO; timed cut by cut on
// the H100 (PERF.md), at L=336 a quarter of its time went to reading the bias
// table from L2 per element, a quarter to one global float32 atomic per
// bias-gradient element (the (8, 336, 336) table fits no block) and a fifth
// to a pass that only computes the row statistics; loading the groups took
// 0.03 ms.  What is left is latency: a few warps an SM, each a chain of
// dependent ldmatrix / mma / exp, and a block's fixed work per group.
//
// Design.  One call, no atomic anywhere:
//
//   (P) attn_bwd_proj_tc_kernel (bf16, C a multiple of 256): Q, K, V and
//       dO of every token, 128-token x 256-column tiles on the tensor cores
//       through a two-stage cp.async ring (x + pos formed in shared memory
//       as a chunk lands), into a scratch (4, heads, tokens, dh) in window
//       order, so that a group's rows of one head are contiguous; it also
//       writes the key flags in window order.  attn_bwd_proj_cc_kernel: the
//       same with CUDA-core FMAs (float32, other widths).
//   (A) the attention core, by route.  Every block keeps a key-offset row
//       in shared memory per group (0, -FLT_MAX padded, -inf past L; 0 for
//       the keys of an opened group), so a logit is product x scale + bias
//       + offset, and the group's rows' pixels, so that no store computes
//       the partition addressing.
//     "tensor_cores" (bf16, dh 16/32/64, the group's bias table and its
//       float32 gradient both fit a block: L up to ~150 at dh=32):
//       attn_bwd_tc_kernel, a block owns one head and walks a strided list
//       of groups, each in three mma.sync passes (row statistics; dK, dV by
//       key tiles; dQ and dS by query tiles), so no warp shares a tile of
//       dQ, dK or dV with another.  (A second buffer that prefetched the
//       next group's rows changed nothing on the H100: the groups' loads
//       are not what holds the kernels back.)  The bias table (rounded to bf16
//       as the forward rounds it) is read into shared memory once per
//       block; dS is summed over the block's groups in a shared-memory
//       table (row pitch 8 more than a multiple of 32: a fragment's float2
//       adds hit 16 banks), written once as the block's partial table.
//     "tensor_cores_tiled" (bf16, larger L): two kernels.  attn_bwd_rows:
//       a block owns one head, a tile of QT query rows and a share of the
//       groups; its bias rows (bf16) and their float32 gradient (64 x 360
//       x 4 B at L=336) stay in shared memory.  Its warps split the rows'
//       keys: S and dP once for the row statistics (merged across the warps
//       by shuffles, written for the second kernel), again for dS, dQ
//       (merged across the warps in a fixed order) and the bias rows.
//       attn_bwd_keys: a block owns one head and a tile of KT keys; its
//       warps split the queries, recompute S^T and dP^T from the row
//       statistics and sum dV = P^T dO and dK = dS^T Q, merged in a fixed
//       order.  9 products where 5 are needed: the forward saves no
//       log-sum-exp, so the rows kernel keeps the statistics pass.
//     "cuda_cores" (float32 and the other head dims): attn_bwd_kernel,
//       CUDA-core FMAs, a block per head over a strided list of groups, the
//       tile's bias rows staged in shared memory, the bias gradient summed
//       in shared memory where the table fits, else into the block's own
//       partial table in device memory (plain adds: no other block writes
//       it).
//   (R) attn_bwd_bias_kernel: the partial tables summed in a fixed order.
// So the whole backward is deterministic.
//
// Left for later: wgmma and TMA; the projections fused into the attention
// kernels (each tile kernel would repeat the K/V or Q/dO projection of a
// group once per tile: 4x the projection work at L=336 in 112-row tiles).
//
// Interface: plain C, loaded with ctypes.  window_attn_bwd_plan says which
// route a call takes and how large its scratch is; the caller allocates it
// and every output and owns the stream.  Returns the first CUDA error of the
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
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

int smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// How many blocks share out the `work` groups of each of `units` block
// rows: the count s that minimises the waves (units s blocks over the
// card's resident blocks) times each block's groups plus BLOCK_SETUP (a
// block's own start and end: its bias rows in, its partial table out, in
// groups' worth).  0 if the kernel cannot run.
constexpr int BLOCK_SETUP = 2;

template <typename K>
int wave_share(K kernel, int threads, size_t smem, long long units,
               long long work) {
  int occ = 0;
  if (allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                    smem) != cudaSuccess ||
      occ < 1)
    return 0;
  const long long slots = (long long)occ * sm_count();
  long long best = 1, best_cost = -1;
  for (long long s = 1; s <= work; ++s) {
    const long long waves = (units * s + slots - 1) / slots;
    const long long cost = waves * ((work + s - 1) / s + BLOCK_SETUP);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return (int)best;
}

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
// Row pitches in floats of the shared bias-gradient rows and of the warps'
// exchanged dQ / dK / dV shares: 8 more than a multiple of 32, so that the
// 8 rows of a fragment's float2 accesses fall on different banks.
__host__ __device__ inline int db_pitch(int Lp) { return Lp + (40 - Lp % 32) % 32; }
__host__ __device__ constexpr int xch_pitch(int dh) { return dh + 8; }
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// ------------------------------------------------------- tensor-core tools

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
// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// A fragments of a 16-row tile (rows [t*16, t*16 + 16), pitch p) over DH
// columns.
template <int DH>
__device__ __forceinline__ void load_a(const bf16* base, int t, int p,
                                       int lane, uint32_t (&a)[DH / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    ldsm_x4(a[ks], base + (t * 16 + lane % 16) * p + ks * 16 + (lane / 16) * 8);
}

// s += A1 B1^T and dp += A2 B2^T over the head dim: A1, A2 the A fragments
// of one 16-row tile, B1, B2 rows [t0, t0 + 16) (pitch p) of two of Q, K,
// V, dO (S and dP, or S^T and dP^T).
template <int DH>
__device__ __forceinline__ void s_dp(const uint32_t (&a1)[DH / 16][4],
                                     const uint32_t (&a2)[DH / 16][4],
                                     const bf16* b1, const bf16* b2, int t0,
                                     int p, int lane, float (&s)[2][4],
                                     float (&dp)[2][4]) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const int off = (t0 + lane % 8 + (lane / 16) * 8) * p + ks * 16 +
                    ((lane / 8) % 2) * 8;
    uint32_t b[4];
    ldsm_x4(b, b1 + off);
    mma_bf16(s[0], a1[ks], b[0], b[1]);
    mma_bf16(s[1], a1[ks], b[2], b[3]);
    ldsm_x4(b, b2 + off);
    mma_bf16(dp[0], a2[ks], b[0], b[1]);
    mma_bf16(dp[1], a2[ks], b[2], b[3]);
  }
}

// acc[n8] += A (16 rows) B, B the rows [k0, k0 + 16) of a (k, n) matrix in
// shared memory (pitch p), n over DH columns: the P V-like products.
template <int DH>
__device__ __forceinline__ void mma_kn(float (&acc)[DH / 8][4],
                                       const uint32_t (&a)[4], const bf16* b,
                                       int k0, int p, int lane) {
#pragma unroll
  for (int dn = 0; dn < DH / 16; ++dn) {
    uint32_t f[4];
    ldsm_x4_t(f, b + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * p + dn * 16 +
                     (lane / 16) * 8);
    mma_bf16(acc[2 * dn], a, f[0], f[1]);
    mma_bf16(acc[2 * dn + 1], a, f[2], f[3]);
  }
}

// ------------------------------------------------------------ projections

// Scratch layout of Q, K, V, dO: (4, heads, tokens, dh), tokens in window
// order: row (z, h, t) at ((z * heads + h) * n_tok + t) * dh.
constexpr int PT_M = 128, PT_N = 256, PT_K = 64, PT_THREADS = 512;
constexpr int PT_AP = PT_K + 8;        // A / [n][k] B pitch (bf16)
constexpr int PT_BP = PT_N + 8;        // [k][n] B pitch (Wo)
// one ring stage: the A chunk, the pos chunk, the B chunk
constexpr int PT_STAGE = 2 * PT_M * PT_AP + PT_N * PT_AP;   // bf16

size_t proj_tc_smem() { return (size_t)2 * PT_STAGE * 2; }

// (P), tensor cores: a block computes a 128-token x 256-column tile of one
// of Q, K, V (z = 0, 1, 2: A = x + pos, x + pos, x; B = rows of W_in) or
// dO (z = 3: A = gy, B = W_out read as (k, n)).  16 warps of 32 rows x 64
// columns; 64-channel chunks through a two-stage cp.async ring, so that a
// chunk's copies overlap the last chunk's products; x + pos formed in
// shared memory as a chunk lands (rounded to bf16, as the JAX version adds
// in bf16).  The blocks of z = 0 also write the key flags in window order.
__global__ void __launch_bounds__(PT_THREADS, 1)
attn_bwd_proj_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ pos,
                        const bf16* __restrict__ gy,
                        const uint8_t* __restrict__ mask,
                        const bf16* __restrict__ w_in,
                        const bf16* __restrict__ b_in,
                        const bf16* __restrict__ w_out,
                        bf16* __restrict__ proj, uint8_t* __restrict__ wmask,
                        Geom g, int n_tok, int C, int heads) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_ct = C / PT_N;
  const int z = blockIdx.y / n_ct, n0 = (blockIdx.y % n_ct) * PT_N;
  const long long t0 = (long long)blockIdx.x * PT_M;
  const int wm = warp % 4, wn = warp / 4;
  const int dh = C / heads;
  const bf16* a_src = z == 3 ? gy : x;
  const bool add_pos = z < 2;
  const int nk = C / PT_K;

  if (blockIdx.y == 0)
    for (int r = tid; r < PT_M; r += PT_THREADS)
      if (t0 + r < n_tok) wmask[t0 + r] = mask[g.pixel(t0 + r)];

  // this thread's two A chunks: rows e / 8, channels (e % 8) 8
  long long a_off[2];
  bool a_ok[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = (tid + u * PT_THREADS) / 8;
    a_ok[u] = t0 + r < n_tok;
    a_off[u] = a_ok[u] ? g.pixel(t0 + r) * C : 0;
  }
  auto issue = [&](int kc) {
    bf16* As = ring + (kc % 2) * PT_STAGE;
    bf16* Ps = As + PT_M * PT_AP;
    bf16* Bs = Ps + PT_M * PT_AP;
    const int k0 = kc * PT_K;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + u * PT_THREADS, r = e / 8, c = (e % 8) * 8;
      cp_async16(As + r * PT_AP + c, a_src + a_off[u] + k0 + c, a_ok[u]);
      if (add_pos)
        cp_async16(Ps + r * PT_AP + c, pos + a_off[u] + k0 + c, a_ok[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = tid + u * PT_THREADS;
      if (z < 3) {                     // W_in rows n0 + r, channels k0 + c
        const int r = e / 8, c = (e % 8) * 8;
        cp_async16(Bs + r * PT_AP + c,
                   w_in + (long long)(z * C + n0 + r) * C + k0 + c, true);
      } else {                         // W_out rows k0 + r, columns n0 + c
        const int r = e / 32, c = (e % 32) * 8;
        cp_async16(Bs + r * PT_BP + c, w_out + (long long)(k0 + r) * C + n0 + c,
                   true);
      }
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  issue(0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) issue(kc + 1);
    else cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    bf16* As = ring + (kc % 2) * PT_STAGE;
    const bf16* Ps = As + PT_M * PT_AP;
    const bf16* Bs = Ps + PT_M * PT_AP;
    if (add_pos) {                     // x + pos over this thread's chunks
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = tid + u * PT_THREADS, r = e / 8, c = (e % 8) * 8;
        uint4 xv = *reinterpret_cast<uint4*>(As + r * PT_AP + c);
        const uint4 pv = *reinterpret_cast<const uint4*>(Ps + r * PT_AP + c);
        __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&xv);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&pv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 xf = __bfloat1622float2(x2[q]);
          const float2 pf = __bfloat1622float2(p2[q]);
          x2[q] = __floats2bfloat162_rn(xf.x + pf.x, xf.y + pf.y);
        }
        *reinterpret_cast<uint4*>(As + r * PT_AP + c) = xv;
      }
    }
    __syncthreads();                   // the chunk (and x + pos) is in
#pragma unroll
    for (int ks = 0; ks < PT_K / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], As + (wm * 32 + i * 16 + lane % 16) * PT_AP + ks * 16 +
                           (lane / 16) * 8);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];
        const int nb = wn * 64 + jj * 16;
        if (z < 3)
          ldsm_x4(b, Bs + (nb + lane % 8 + (lane / 16) * 8) * PT_AP + ks * 16 +
                         ((lane / 8) % 2) * 8);
        else
          ldsm_x4_t(b, Bs + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) * PT_BP +
                           nb + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();                   // before the next issue overwrites
  }
  // + bias in f32, rounded once, into the scratch
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + wn * 64 + j * 8 + 2 * (lane % 4);
    const int h = n / dh, d = n - h * dh;
    const float b0 = z < 3 ? __bfloat162float(b_in[z * C + n]) : 0.f;
    const float b1 = z < 3 ? __bfloat162float(b_in[z * C + n + 1]) : 0.f;
    bf16* dst = proj + ((long long)(z * heads + h) * n_tok) * dh + d;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long t = t0 + wm * 32 + i * 16 + lane / 4 + half * 8;
        if (t < n_tok)
          *reinterpret_cast<__nv_bfloat162*>(dst + t * dh) =
              __floats2bfloat162_rn(acc[i][j][2 * half] + b0,
                                    acc[i][j][2 * half + 1] + b1);
      }
  }
}

constexpr int PC_T = 64, PC_K = 16, PC_THREADS = 256;

// (P), CUDA cores: a block computes a 64-token x 64-column tile of one of
// Q, K, V, dO (z = blockIdx.y / column tiles) with float32 FMAs, 4 x 4
// outputs a thread, through 16-channel chunks in shared memory; the key
// flags in window order as the tensor-core kernel writes them.
template <typename T>
__global__ void __launch_bounds__(PC_THREADS)
attn_bwd_proj_cc_kernel(const T* __restrict__ x, const T* __restrict__ pos,
                        const T* __restrict__ gy,
                        const uint8_t* __restrict__ mask,
                        const T* __restrict__ w_in, const T* __restrict__ b_in,
                        const T* __restrict__ w_out, T* __restrict__ proj,
                        uint8_t* __restrict__ wmask, Geom g, int n_tok, int C,
                        int heads) {
  __shared__ float As[PC_K][PC_T + 1];
  __shared__ float Bs[PC_K][PC_T + 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n_ct = (C + PC_T - 1) / PC_T;
  const int z = blockIdx.y / n_ct, n0 = (blockIdx.y % n_ct) * PC_T;
  const long long t0 = (long long)blockIdx.x * PC_T;
  const int dh = C / heads;
  if (blockIdx.y == 0)
    for (int r = tid; r < PC_T; r += PC_THREADS)
      if (t0 + r < n_tok) wmask[t0 + r] = mask[g.pixel(t0 + r)];
  float acc[4][4] = {};
  for (int k0 = 0; k0 < C; k0 += PC_K) {
#pragma unroll
    for (int u = 0; u < PC_T * PC_K / PC_THREADS; ++u) {
      const int e = tid + u * PC_THREADS, r = e / PC_K, kk = e % PC_K;
      const int k = k0 + kk;
      float a = 0.f, w = 0.f;
      if (t0 + r < n_tok && k < C) {
        const long long i = g.pixel(t0 + r) * C + k;
        if (z < 2) a = round_to<T>(to_f32(x[i]) + to_f32(pos[i]));
        else a = to_f32(z == 2 ? x[i] : gy[i]);
      }
      const int n = n0 + r;
      if (n < C && k < C)
        w = to_f32(z < 3 ? w_in[(long long)(z * C + n) * C + k]
                         : w_out[(long long)k * C + n]);
      As[kk][r] = a;
      Bs[kk][r] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PC_K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        b[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= C) continue;
    const int h = n / dh, d = n - h * dh;
    const float bias = z < 3 ? to_f32(b_in[z * C + n]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long t = t0 + ty * 4 + i;
      if (t < n_tok)
        proj[((long long)(z * heads + h) * n_tok + t) * dh + d] =
            from_f32<T>(acc[i][j] + bias);
    }
  }
}

// (R) g_bias[e] = sum over the n partial tables of partial[k][e], in order.
__global__ void attn_bwd_bias_kernel(const float* __restrict__ partial,
                                   float* __restrict__ g_bias, int n,
                                   long long size) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = 0.f;
  for (int k = 0; k < n; ++k) s += partial[k * size + e];
  g_bias[e] = s;
}

// ------------------------------------------------- CUDA-core route (f32)

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;

// Shared memory of attn_bwd_kernel, in floats: K and V (rows padded to
// dh + 1: the S and dP loops read them across keys), the dK / dV
// accumulators, the tile's Q and dO rows, P (first the tile's bias rows)
// and dP / dS of the tile's rows, the key flags, the rows' rowsum(P o dP),
// and the bias-gradient table when summed here.
size_t bwd_smem_floats(int L, int dh, int tq, bool bias_acc) {
  return (size_t)2 * L * (dh + 1) + (size_t)2 * L * dh + (size_t)2 * tq * dh +
         (size_t)2 * tq * L + L + tq + (bias_acc ? (size_t)L * L : 0);
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

// One head (blockIdx.y) over a strided list of groups; Q, K, V, dO from the
// projection scratch.  The bias gradient goes into this block's partial
// table partial[blockIdx.x][h]: summed in shared memory and stored once
// (bias_acc), or added in place (zeroed by the launcher; only this block
// writes it, each row of a tile by one warp).
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
attn_bwd_kernel(const T* __restrict__ proj, const uint8_t* __restrict__ wmask,
                const float* __restrict__ bias, T* __restrict__ dqkv,
                float* __restrict__ partial, Geom g, int n_groups, int n_tok,
                int C, int heads, int TQ, bool bias_acc) {
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
  (void)delta;

  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale = round_to<T>(sqrtf((float)dh));
  const float* bias_h = bias ? bias + (long long)h * L * L : nullptr;
  float* dbias_h = bias ? partial + ((long long)blockIdx.x * heads + h) * L * L
                        : nullptr;
  const long long C2 = 2LL * C, C3 = 3LL * C;
  const int hc = h * dh;
  const T* Qg = proj + (long long)h * n_tok * dh;
  const T* Kg = proj + (long long)(heads + h) * n_tok * dh;
  const T* Vg = proj + (long long)(2 * heads + h) * n_tok * dh;
  const T* Gg = proj + (long long)(3 * heads + h) * n_tok * dh;

  if (bias_acc)
    for (int e = tid; e < L * L; e += BWD_THREADS) dB[e] = 0.f;

  for (long long grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    __syncthreads();                   // the last group's dK / dV are out
    const long long r0 = grp * L;
    for (int e = tid; e < L * dh; e += BWD_THREADS) {
      const int j = e / dh, d = e - j * dh;
      Ks[j * dp + d] = to_f32(Kg[(r0 + j) * dh + d]);
      Vs[j * dp + d] = to_f32(Vg[(r0 + j) * dh + d]);
      dKs[e] = 0.f;
      dVs[e] = 0.f;
    }
    int any_valid = 0;
    for (int j = tid; j < L; j += BWD_THREADS) {
      const bool pad = wmask[r0 + j] != 0;
      kpad[j] = pad ? 1.f : 0.f;
      any_valid |= !pad;
    }
    // a group whose keys are all padding is opened (barrier as well)
    const bool open = !__syncthreads_or(any_valid);

    for (int q0 = 0; q0 < L; q0 += TQ) {
      const int nq = min(TQ, L - q0);
      for (int e = tid; e < nq * dh; e += BWD_THREADS) {
        Qs[e] = to_f32(Qg[(r0 + q0) * dh + e]);
        dOs[e] = to_f32(Gg[(r0 + q0) * dh + e]);
      }
      // the tile's bias rows, read once in order, rounded as the forward
      for (int e = tid; e < nq * L; e += BWD_THREADS)
        P[e] = bias_h ? round_to<T>(__ldg(bias_h + (long long)q0 * L + e)) : 0.f;
      __syncthreads();

      // S (into P, over its bias) and dP (into dS) for the tile's full rows
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
        s = s / scale + P[e];
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
          else if (dbias_h) dbias_h[row + j] += ds;
        }
      }
      __syncthreads();

      // dQ of the tile's rows (complete), written at once
      for (int e = tid; e < nq * dh; e += BWD_THREADS) {
        const int i = e / dh, d = e - i * dh;
        const float* sr = dS + (size_t)i * L;
        float acc = 0.f;
        for (int j = 0; j < L; ++j) acc = fmaf(sr[j], Ks[j * dp + d], acc);
        const long long p = g.pixel(r0 + q0 + i);
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
      const long long p = g.pixel(r0 + j);
      dqkv[p * C3 + C + hc + d] = from_f32<T>(dKs[e] / scale);
      dqkv[p * C3 + C2 + hc + d] = from_f32<T>(dVs[e]);
    }
  }

  if (bias_acc && dbias_h) {
    __syncthreads();
    for (int e = tid; e < L * L; e += BWD_THREADS) dbias_h[e] = dB[e];
  }
}

// ----------------------------------- tensor-core route, whole groups

constexpr int TC_WARPS = 8, TC_THREADS = TC_WARPS * 32;
// key flags a thread loads for the next group (groups of up to 4 x the
// block's threads)
constexpr int FLAGS = 4;

// waits until this thread's copies are in
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

// The key flags of group i of this block (j < L: 1 padded, 0 not), loaded
// into registers one group ahead so that their latency hides behind the
// current group.
template <int NTHR>
__device__ __forceinline__ void load_flags(const uint8_t* __restrict__ wmask,
                                           long long grp, bool has, int L,
                                           uint8_t (&f)[FLAGS]) {
#pragma unroll
  for (int u = 0; u < FLAGS; ++u) {
    const int j = threadIdx.x + u * NTHR;
    f[u] = has && j < L ? __ldg(wmask + grp * L + j) : 0;
  }
}

// Each key's offset to its logit into shared memory, as the forward masks
// it: 0 for a valid key, -FLT_MAX for a padded one (a logit of -FLT_MAX
// plus a product and a bias rounds to -FLT_MAX), -inf past L; whether a
// key of the group is valid.
template <int NTHR>
__device__ __forceinline__ int store_flags(float* koff, int L, int Lp,
                                           const uint8_t (&f)[FLAGS]) {
  int any_valid = 0;
#pragma unroll
  for (int u = 0; u < FLAGS; ++u) {
    const int j = threadIdx.x + u * NTHR;
    if (j < L) {
      koff[j] = f[u] ? -FLT_MAX : 0.f;
      any_valid |= !f[u];
    } else if (j < Lp) {
      koff[j] = -INFINITY;
    }
  }
  return any_valid;
}

// A group whose keys are all padding is opened: its keys' offsets back to 0
// (block-uniform; a barrier after).
template <int NTHR>
__device__ __forceinline__ void open_group(float* koff, int L) {
#pragma unroll
  for (int u = 0; u < FLAGS; ++u) {
    const int j = threadIdx.x + u * NTHR;
    if (j < L) koff[j] = 0.f;
  }
  __syncthreads();
}

// Shared memory of attn_bwd_tc_kernel: Q, K, V and dO of a group's rows
// (padded to 16, pitch dh + 8 in bf16), each row's log-sum-exp, rowsum(P o
// dP) and pixel, the key offsets, and with a bias the head's bias table in
// bf16 (pitch Lp + 8, zero past L) and its float32 gradient (L rows, pitch
// db_pitch).
size_t tc_smem(int L, int dh, bool bias) {
  const size_t lp = round16(L);
  return 4 * lp * (dh + 8) * 2 + 2 * lp * 4 + lp * 4 + lp * 4 +
         (bias ? lp * (lp + 8) * 2 + (size_t)L * db_pitch(lp) * 4 : 0);
}

// One head (blockIdx.y) over a strided list of groups.  Per
// group, three passes over 16 x 16 tiles of the (query, key) square, every
// product an mma.sync m16n8k16 fed by ldmatrix, every tile's elementwise
// work in the accumulator registers:
//   A, warps over query tiles: S = Q K^T and dP = dO V^T over the keys, an
//      online max / sum / sum of P dP -> each row's log-sum-exp and
//      rowsum(P o dP);
//   B, warps over key tiles: S^T and dP^T again, P^T and dS^T, which are
//      already the A operands of dV += P^T dO and dK += dS^T Q, kept in
//      registers across the query tiles;
//   C, warps over query tiles: S and dP again, dS as the A operand of
//      dQ += dS K, kept in registers across the key tiles; dS into the
//      block's bias-gradient table (each element by one warp).
// The table goes to partial[blockIdx.x][h] once, at the end.
template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
attn_bwd_tc_kernel(const bf16* __restrict__ proj,
                   const uint8_t* __restrict__ wmask,
                   const float* __restrict__ bias, bf16* __restrict__ dqkv,
                   float* __restrict__ partial, Geom g, int n_groups,
                   int n_tok, int C, int heads) {
  constexpr int QP = DH + 8;           // 8 ldmatrix rows hit 8 bank groups
  constexpr int CH = DH / 8;           // 16-byte chunks of a head's row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = g.L, Lp = round16(L), nt = Lp / 16, BP = Lp + 8;
  const int DBP = db_pitch(Lp);
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* bufs = reinterpret_cast<bf16*>(smem_raw);        // Q K V dO
  float* lse = reinterpret_cast<float*>(bufs + 4 * Lp * QP);
  float* delta = lse + Lp;
  int* prow = reinterpret_cast<int*>(delta + Lp);        // each row's pixel
  float* koff = reinterpret_cast<float*>(prow + Lp);     // key offsets
  bf16* Bs = reinterpret_cast<bf16*>(koff + Lp);
  float* dB = reinterpret_cast<float*>(Bs + Lp * BP);
  const bool has_bias = bias != nullptr;

  const float inv_scale = 1.f / round_to<bf16>(sqrtf((float)DH));
  const long long C2 = 2LL * C, C3 = 3LL * C;
  const int hc = h * DH;
  const bf16* src[4];
#pragma unroll
  for (int z = 0; z < 4; ++z)
    src[z] = proj + (long long)(z * heads + h) * n_tok * DH;
  const int n_my = (n_groups - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  // starts the copies of group i's rows
  auto issue = [&](int i) {
    const long long r0 = ((long long)blockIdx.x + (long long)i * gridDim.x) * L;
    bf16* dst = bufs;
    for (int e = tid; e < Lp * CH; e += TC_THREADS) {
      const int r = e / CH, c = (e - r * CH) * 8;
      const bool ok = r < L;
#pragma unroll
      for (int z = 0; z < 4; ++z)
        cp_async16(dst + z * Lp * QP + r * QP + c,
                   src[z] + (ok ? (r0 + r) * DH + c : 0), ok);
    }
    cp_async_commit();
  };

  uint8_t fl[FLAGS];
  load_flags<TC_THREADS>(wmask, blockIdx.x, n_my > 0, L, fl);
  if (has_bias) {
    const float* bias_h = bias + (long long)h * L * L;
    for (int e = tid; e < Lp * Lp; e += TC_THREADS) {
      const int r = e / Lp, c = e - r * Lp;
      Bs[r * BP + c] = __float2bfloat16(
          r < L && c < L ? __ldg(bias_h + (long long)r * L + c) : 0.f);
    }
    for (int e = tid; e < L * DBP; e += TC_THREADS) dB[e] = 0.f;
  }

  for (int i = 0; i < n_my; ++i) {
    const long long grp = blockIdx.x + (long long)i * gridDim.x;
    const long long r0 = grp * L;
    __syncthreads();                   // the last group's passes are done
    const int any_valid = store_flags<TC_THREADS>(koff, L, Lp, fl);
    for (int j = tid; j < L; j += TC_THREADS) prow[j] = (int)g.pixel(r0 + j);
    issue(i);
    load_flags<TC_THREADS>(wmask, grp + gridDim.x, i + 1 < n_my, L, fl);
    cp_async_wait_all();               // this group's rows are in
    // a group whose keys are all padding is opened (barrier as well)
    if (!__syncthreads_or(any_valid)) open_group<TC_THREADS>(koff, L);
    const bf16* Qs = bufs;
    const bf16* Ks = Qs + Lp * QP;
    const bf16* Vs = Ks + Lp * QP;
    const bf16* Gs = Vs + Lp * QP;                       // dO

    auto bias_at = [&](int qi, int kj) -> float {
      return has_bias ? __bfloat162float(Bs[qi * BP + kj]) : 0.f;
    };

    // pass A: per query row, log-sum-exp and rowsum(P o dP)
    for (int qt = warp; qt < nt; qt += TC_WARPS) {
      uint32_t qa[DH / 16][4], ga[DH / 16][4];
      load_a<DH>(Qs, qt, QP, lane, qa);
      load_a<DH>(Gs, qt, QP, lane, ga);
      const int r0w = qt * 16 + lane / 4;          // rows r0w and r0w + 8
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
      for (int k0 = 0; k0 < Lp; k0 += 16) {
        float s[2][4] = {}, dp[2][4] = {};
        s_dp<DH>(qa, ga, Ks, Vs, k0, QP, lane, s, dp);
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = k0 + j * 8 + 2 * (lane % 4) + c % 2;
            s[j][c] = s[j][c] * inv_scale + bias_at(r0w + (c / 2) * 8, key) +
                      koff[key];
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
        const int r = r0w + u * 8;
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
      load_a<DH>(Ks, kt, QP, lane, ka);
      load_a<DH>(Vs, kt, QP, lane, va);
      float dk[DH / 8][4] = {}, dv[DH / 8][4] = {};
      const int j0 = kt * 16 + lane / 4;           // keys j0 and j0 + 8
      for (int qt = 0; qt < nt; ++qt) {
        float st[2][4] = {}, dpt[2][4] = {};
        // S^T and dP^T: K and V as A, Q and dO rows as B
        s_dp<DH>(ka, va, Qs, Gs, qt * 16, QP, lane, st, dpt);
        uint32_t pa[4], sa[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int q = qt * 16 + j * 8 + 2 * (lane % 4) + (c % 2);
            const int key = j0 + (c / 2) * 8;
            const float p = __expf(st[j][c] * inv_scale + bias_at(q, key) +
                                   koff[key] - lse[q]);
            st[j][c] = p;
            dpt[j][c] = p * (dpt[j][c] - delta[q]);
          }
          pa[2 * j] = pack_bf16(st[j][0], st[j][1]);
          pa[2 * j + 1] = pack_bf16(st[j][2], st[j][3]);
          sa[2 * j] = pack_bf16(dpt[j][0], dpt[j][1]);
          sa[2 * j + 1] = pack_bf16(dpt[j][2], dpt[j][3]);
        }
        mma_kn<DH>(dv, pa, Gs, qt * 16, QP, lane);
        mma_kn<DH>(dk, sa, Qs, qt * 16, QP, lane);
      }
#pragma unroll
      for (int n8 = 0; n8 < DH / 8; ++n8)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = j0 + u * 8;
          if (key >= L) continue;
          const long long p = prow[key];
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
      load_a<DH>(Qs, qt, QP, lane, qa);
      load_a<DH>(Gs, qt, QP, lane, ga);
      const int r0w = qt * 16 + lane / 4;
      const float lr[2] = {lse[r0w], lse[r0w + 8]};
      const float dr[2] = {delta[r0w], delta[r0w + 8]};
      float dq[DH / 8][4] = {};
      for (int k0 = 0; k0 < Lp; k0 += 16) {
        float s[2][4] = {}, dp[2][4] = {};
        s_dp<DH>(qa, ga, Ks, Vs, k0, QP, lane, s, dp);
        uint32_t sa[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kp = k0 + j * 8 + 2 * (lane % 4);        // keys kp, kp + 1
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int q = r0w + (c / 2) * 8;
            const int key = kp + (c % 2);
            const float p = __expf(s[j][c] * inv_scale + bias_at(q, key) +
                                   koff[key] - lr[c / 2]);
            s[j][c] = p * (dp[j][c] - dr[c / 2]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {   // a padded key's dS is 0
            const int q = r0w + u * 8;
            if (has_bias && q < L && kp < L) {
              float2* a = reinterpret_cast<float2*>(dB + q * DBP + kp);
              float2 v = *a;
              v.x += s[j][2 * u];
              v.y += s[j][2 * u + 1];
              *a = v;
            }
          }
          sa[2 * j] = pack_bf16(s[j][0], s[j][1]);
          sa[2 * j + 1] = pack_bf16(s[j][2], s[j][3]);
        }
        mma_kn<DH>(dq, sa, Ks, k0, QP, lane);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = r0w + u * 8;
        if (r >= L) continue;
        const long long p = prow[r];
        bf16* dst = dqkv + p * C3 + hc + 2 * (lane % 4);
#pragma unroll
        for (int n8 = 0; n8 < DH / 8; ++n8)
          *reinterpret_cast<__nv_bfloat162*>(dst + n8 * 8) =
              __floats2bfloat162_rn(dq[n8][2 * u] * inv_scale,
                                    dq[n8][2 * u + 1] * inv_scale);
      }
    }
  }

  if (has_bias) {
    __syncthreads();
    float* out = partial + ((long long)blockIdx.x * heads + h) * L * L;
    for (int e = tid; e < L * L; e += TC_THREADS) {
      const int r = e / L;
      out[e] = dB[r * DBP + e - r * L];
    }
  }
}

// ------------------------------- tensor-core route, tiles of a group

// Warps of the tile kernels: 16 at dh <= 32 (at most 128 registers a
// thread), 8 at 64; timed on the H100 at L=336 against 8 (PERF.md).
__host__ __device__ constexpr int tile_warps(int dh) { return dh <= 32 ? 16 : 8; }

// Shared memory of attn_bwd_rows_kernel: K and V of the group (their space
// takes the warps' dQ shares once the products are done) and Q and dO of
// the tile's rows, the tile's bias rows (bf16) and their float32 gradient,
// the warps' row statistics, the merged ones, the rows' pixels, the key
// offsets.
size_t rows_smem(int L, int dh, int qt, int warps, bool bias) {
  const size_t lp = round16(L), ks = warps / (qt / 16);
  const size_t kv = 2 * lp * (dh + 8) * 2, xq = ks * qt * xch_pitch(dh) * 4;
  const size_t qg = 2 * (size_t)qt * (dh + 8) * 2;
  return align16(kv > xq ? kv : xq) + qg +
         (bias ? (size_t)qt * (lp + 8) * 2 + (size_t)qt * db_pitch(lp) * 4 : 0) +
         3 * ks * qt * 4 + 3 * (size_t)qt * 4 + lp * 4;
}

// Shared memory of attn_bwd_keys_kernel: Q and dO of the group (their space
// takes the warps' dK, then dV shares), K and V of the tile's keys, the
// row statistics, the bias columns of the keys (bf16, every query), the
// keys' pixels, the key offsets.
size_t keys_smem(int L, int dh, int kt, int warps, bool bias) {
  const size_t lp = round16(L), qs = warps / (kt / 16);
  const size_t qg = 2 * lp * (dh + 8) * 2, xk = qs * kt * xch_pitch(dh) * 4;
  return align16(qg > xk ? qg : xk) + 2 * (size_t)kt * (dh + 8) * 2 +
         2 * lp * 4 +
         (bias ? lp * (kt + 8) * 2 : 0) + (size_t)kt * 4 + lp * 4;
}

// A block owns head blockIdx.z, query rows [q0, q0 + QT) (q0 = blockIdx.y
// QT) and the groups blockIdx.x, + gridDim.x, ...  Warp (rt, ks) takes the
// rows'
// 16-row tile rt and the key tiles ks, ks + KS, ...: a sweep of S and dP
// for the row statistics (merged over the KS warps of a tile, written to
// stats for the keys kernel), a second for dS, the bias rows' gradient (in
// shared memory over the block's groups) and dQ (merged over the KS warps
// in order).  The gradient rows go to partial[blockIdx.x][h] at the end.
template <int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
attn_bwd_rows_kernel(const bf16* __restrict__ proj,
                     const uint8_t* __restrict__ wmask,
                     const float* __restrict__ bias, bf16* __restrict__ dqkv,
                     float* __restrict__ partial, float* __restrict__ stats,
                     Geom g, int n_groups, int n_tok, int C, int heads,
                     int QT) {
  constexpr int QP = DH + 8, CH = DH / 8, NTHR = WARPS * 32;
  constexpr int XP = xch_pitch(DH);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = g.L, Lp = round16(L), nt = Lp / 16, BP = Lp + 8;
  const int DBP = db_pitch(Lp);
  const int h = blockIdx.z, q0 = blockIdx.y * QT;
  const int RT = QT / 16, KS = WARPS / RT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp % RT, ks = warp / RT;
  const bool has_bias = bias != nullptr;
  const size_t kv = 2 * (size_t)Lp * QP * 2, xq = (size_t)KS * QT * XP * 4;
  const size_t kvb = align16(kv > xq ? kv : xq), qgb = 2 * (size_t)QT * QP * 2;
  unsigned char* p = smem_raw;
  unsigned char* bufs = p;                               // K V | Q dO
  p += kvb + qgb;
  bf16* Bs = reinterpret_cast<bf16*>(p);
  float* dB = reinterpret_cast<float*>(p + (has_bias ? (size_t)QT * BP * 2 : 0));
  if (has_bias) p += (size_t)QT * BP * 2 + (size_t)QT * DBP * 4;
  float* stm = reinterpret_cast<float*>(p);
  float* stl = stm + KS * QT;
  float* std_ = stl + KS * QT;
  float* lse_s = std_ + KS * QT;
  float* dlt_s = lse_s + QT;
  int* prow = reinterpret_cast<int*>(dlt_s + QT);        // the rows' pixels
  float* koff = reinterpret_cast<float*>(prow + QT);     // key offsets

  const float inv_scale = 1.f / round_to<bf16>(sqrtf((float)DH));
  const long long C3 = 3LL * C;
  const int hc = h * DH;
  const bf16* src[4];
#pragma unroll
  for (int z = 0; z < 4; ++z)
    src[z] = proj + (long long)(z * heads + h) * n_tok * DH;
  const int n_my = (n_groups - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  auto issue = [&](int i) {
    const long long r0 = ((long long)blockIdx.x + (long long)i * gridDim.x) * L;
    unsigned char* b = bufs;
    bf16* Kd = reinterpret_cast<bf16*>(b);
    bf16* Vd = Kd + Lp * QP;
    bf16* Qd = reinterpret_cast<bf16*>(b + kvb);
    bf16* Gd = Qd + QT * QP;
    for (int e = tid; e < Lp * CH; e += NTHR) {
      const int r = e / CH, c = (e - r * CH) * 8;
      const bool ok = r < L;
      const long long off = ok ? (r0 + r) * DH + c : 0;
      cp_async16(Kd + r * QP + c, src[1] + off, ok);
      cp_async16(Vd + r * QP + c, src[2] + off, ok);
    }
    for (int e = tid; e < QT * CH; e += NTHR) {
      const int r = e / CH, c = (e - r * CH) * 8;
      const bool ok = q0 + r < L;
      const long long off = ok ? (r0 + q0 + r) * DH + c : 0;
      cp_async16(Qd + r * QP + c, src[0] + off, ok);
      cp_async16(Gd + r * QP + c, src[3] + off, ok);
    }
    cp_async_commit();
  };

  uint8_t fl[FLAGS];
  load_flags<NTHR>(wmask, blockIdx.x, n_my > 0, L, fl);
  if (has_bias) {
    const float* bias_h = bias + (long long)h * L * L;
    for (int e = tid; e < QT * Lp; e += NTHR) {
      const int r = e / Lp, c = e - r * Lp, q = q0 + r;
      Bs[r * BP + c] = __float2bfloat16(
          q < L && c < L ? __ldg(bias_h + (long long)q * L + c) : 0.f);
    }
    for (int e = tid; e < QT * DBP; e += NTHR) dB[e] = 0.f;
  }
  auto bias_at = [&](int r, int key) -> float {
    return has_bias ? __bfloat162float(Bs[r * BP + key]) : 0.f;
  };
  const int rl = rt * 16 + lane / 4;               // local rows rl, rl + 8

  for (int i = 0; i < n_my; ++i) {
    const long long grp = blockIdx.x + (long long)i * gridDim.x;
    const long long r0 = grp * L;
    __syncthreads();                   // the last group is done
    const int any_valid = store_flags<NTHR>(koff, L, Lp, fl);
    for (int r = tid; r < QT; r += NTHR)
      prow[r] = q0 + r < L ? (int)g.pixel(r0 + q0 + r) : 0;
    issue(i);
    load_flags<NTHR>(wmask, grp + gridDim.x, i + 1 < n_my, L, fl);
    cp_async_wait_all();
    if (!__syncthreads_or(any_valid)) open_group<NTHR>(koff, L);
    unsigned char* b = bufs;
    const bf16* Ks = reinterpret_cast<const bf16*>(b);
    const bf16* Vs = Ks + Lp * QP;
    const bf16* Qs = reinterpret_cast<const bf16*>(b + kvb);
    const bf16* Gs = Qs + QT * QP;
    float* dQx = reinterpret_cast<float*>(b);

    uint32_t qa[DH / 16][4], ga[DH / 16][4];
    load_a<DH>(Qs, rt, QP, lane, qa);
    load_a<DH>(Gs, rt, QP, lane, ga);

    // sweep 1: the warp's share of each row's max, sum and sum of P dP
    {
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
      for (int kt = ks; kt < nt; kt += KS) {
        float s[2][4] = {}, dp[2][4] = {};
        s_dp<DH>(qa, ga, Ks, Vs, kt * 16, QP, lane, s, dp);
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = kt * 16 + j * 8 + 2 * (lane % 4) + c % 2;
            s[j][c] = s[j][c] * inv_scale + bias_at(rl + (c / 2) * 8, key) +
                      koff[key];
            tmax[c / 2] = fmaxf(tmax[c / 2], s[j][c]);
          }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          tmax[u] = fmaxf(tmax[u], __shfl_xor_sync(0xffffffffu, tmax[u], 1));
          tmax[u] = fmaxf(tmax[u], __shfl_xor_sync(0xffffffffu, tmax[u], 2));
          const float mn = fmaxf(m[u], tmax[u]);   // finite: a tile has a key < L
          const float corr = __expf(m[u] - mn);
          m[u] = mn;
          l[u] *= corr;
          dd[u] *= corr;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float pv = __expf(s[j][c] - m[c / 2]);
            l[c / 2] += pv;
            dd[c / 2] = fmaf(pv, dp[j][c], dd[c / 2]);
          }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
        l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
        dd[u] += __shfl_xor_sync(0xffffffffu, dd[u], 1);
        dd[u] += __shfl_xor_sync(0xffffffffu, dd[u], 2);
        if (lane % 4 == 0) {
          const int r = ks * QT + rl + u * 8;
          stm[r] = m[u];
          stl[r] = l[u];
          std_[r] = dd[u];
        }
      }
    }
    __syncthreads();
    // merge the KS shares of each row: KS lanes a row (KS divides 32),
    // by shuffles in a fixed order; rows past L take no probability
    for (int t = tid; t < QT * KS; t += NTHR) {
      const int r = t / KS, k = t - r * KS;
      const float mk = stm[k * QT + r];
      float mx = mk;
      for (int o = 1; o < KS; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float w = __expf(mk - mx);
      float ls = stl[k * QT + r] * w, ds = std_[k * QT + r] * w;
      for (int o = 1; o < KS; o <<= 1) {
        ls += __shfl_xor_sync(0xffffffffu, ls, o);
        ds += __shfl_xor_sync(0xffffffffu, ds, o);
      }
      const int q = q0 + r;
      if (k == 0) {
        const float lv = q < L ? mx + __logf(ls) : INFINITY;
        const float dv = q < L ? ds / ls : 0.f;
        lse_s[r] = lv;
        dlt_s[r] = dv;
        if (q < L) {
          stats[(long long)h * n_tok + r0 + q] = lv;
          stats[(long long)(heads + h) * n_tok + r0 + q] = dv;
        }
      }
    }
    __syncthreads();

    // sweep 2: dS, the bias rows' gradient, the warp's share of dQ
    float dq[DH / 8][4] = {};
    {
      const float lr[2] = {lse_s[rl], lse_s[rl + 8]};
      const float dr[2] = {dlt_s[rl], dlt_s[rl + 8]};
      for (int kt = ks; kt < nt; kt += KS) {
        float s[2][4] = {}, dp[2][4] = {};
        s_dp<DH>(qa, ga, Ks, Vs, kt * 16, QP, lane, s, dp);
        uint32_t sa[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kp = kt * 16 + j * 8 + 2 * (lane % 4);   // keys kp, kp + 1
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = rl + (c / 2) * 8;
            const int key = kp + (c % 2);
            const float pv = __expf(s[j][c] * inv_scale + bias_at(r, key) +
                                    koff[key] - lr[c / 2]);
            s[j][c] = pv * (dp[j][c] - dr[c / 2]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {   // a padded key's dS is 0
            const int r = rl + u * 8;
            if (has_bias && q0 + r < L && kp < L) {
              float2* a = reinterpret_cast<float2*>(dB + r * DBP + kp);
              float2 v = *a;
              v.x += s[j][2 * u];
              v.y += s[j][2 * u + 1];
              *a = v;
            }
          }
          sa[2 * j] = pack_bf16(s[j][0], s[j][1]);
          sa[2 * j + 1] = pack_bf16(s[j][2], s[j][3]);
        }
        mma_kn<DH>(dq, sa, Ks, kt * 16, QP, lane);
      }
    }
    __syncthreads();                   // K and V are read: their space
#pragma unroll                         // takes the dQ shares
    for (int n8 = 0; n8 < DH / 8; ++n8)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        *reinterpret_cast<float2*>(dQx + (ks * QT + rl + u * 8) * XP + n8 * 8 +
                                   2 * (lane % 4)) =
            make_float2(dq[n8][2 * u], dq[n8][2 * u + 1]);
    __syncthreads();
    for (int e = tid; e < QT * DH / 2; e += NTHR) {
      const int r = e / (DH / 2), d = (e - r * (DH / 2)) * 2;
      const int q = q0 + r;
      if (q >= L) continue;
      float a0 = 0.f, a1 = 0.f;
      for (int k = 0; k < KS; ++k) {
        const float2 v = *reinterpret_cast<const float2*>(
            dQx + (k * QT + r) * XP + d);
        a0 += v.x;
        a1 += v.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(dqkv + (long long)prow[r] * C3 + hc + d) =
          __floats2bfloat162_rn(a0 * inv_scale, a1 * inv_scale);
    }
  }

  if (has_bias) {
    __syncthreads();
    float* out = partial + ((long long)blockIdx.x * heads + h) * L * L;
    for (int e = tid; e < QT * L; e += NTHR) {
      const int r = e / L, c = e - r * L;
      if (q0 + r < L) out[(long long)(q0 + r) * L + c] = dB[r * DBP + c];
    }
  }
}

// A block owns head blockIdx.z, keys [k0, k0 + KT) (k0 = blockIdx.y KT)
// and the groups blockIdx.x, + gridDim.x, ...  Warp (kr, qs) takes
// the keys' 16-key tile kr and the query tiles qs, qs + QS, ...: S^T and
// dP^T, P^T and dS^T from the rows kernel's statistics, dV += P^T dO and
// dK += dS^T Q; the QS warps' shares of a tile merged in order.
template <int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
attn_bwd_keys_kernel(const bf16* __restrict__ proj,
                     const uint8_t* __restrict__ wmask,
                     const float* __restrict__ bias, bf16* __restrict__ dqkv,
                     const float* __restrict__ stats, Geom g, int n_groups,
                     int n_tok, int C, int heads, int KT) {
  constexpr int QP = DH + 8, CH = DH / 8, NTHR = WARPS * 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = g.L, Lp = round16(L), nt = Lp / 16, TP = KT + 8;
  const int h = blockIdx.z, k0 = blockIdx.y * KT;
  const int KR = KT / 16, QS = WARPS / KR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kr = warp % KR, qs = warp / KR;
  const bool has_bias = bias != nullptr;
  constexpr int XP = xch_pitch(DH);
  const size_t qg = 2 * (size_t)Lp * QP * 2, xk = (size_t)QS * KT * XP * 4;
  const size_t qgb = align16(qg > xk ? qg : xk);
  const size_t kvb = 2 * (size_t)KT * QP * 2, stb = 2 * (size_t)Lp * 4;
  unsigned char* p = smem_raw;
  unsigned char* bufs = p;                   // Q dO | K V | lse delta
  p += qgb + kvb + stb;
  bf16* Bt = reinterpret_cast<bf16*>(p);
  if (has_bias) p += (size_t)Lp * TP * 2;
  int* pkey = reinterpret_cast<int*>(p);                 // the keys' pixels
  float* koff = reinterpret_cast<float*>(pkey + KT);     // key offsets

  const float inv_scale = 1.f / round_to<bf16>(sqrtf((float)DH));
  const long long C2 = 2LL * C, C3 = 3LL * C;
  const int hc = h * DH;
  const bf16* src[4];
#pragma unroll
  for (int z = 0; z < 4; ++z)
    src[z] = proj + (long long)(z * heads + h) * n_tok * DH;
  const float* st_src[2] = {stats + (long long)h * n_tok,
                            stats + (long long)(heads + h) * n_tok};
  const int n_my = (n_groups - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  auto issue = [&](int i) {
    const long long r0 = ((long long)blockIdx.x + (long long)i * gridDim.x) * L;
    unsigned char* b = bufs;
    bf16* Qd = reinterpret_cast<bf16*>(b);
    bf16* Gd = Qd + Lp * QP;
    bf16* Kd = reinterpret_cast<bf16*>(b + qgb);
    bf16* Vd = Kd + KT * QP;
    float* Sd = reinterpret_cast<float*>(b + qgb + kvb);
    for (int e = tid; e < Lp * CH; e += NTHR) {
      const int r = e / CH, c = (e - r * CH) * 8;
      const bool ok = r < L;
      const long long off = ok ? (r0 + r) * DH + c : 0;
      cp_async16(Qd + r * QP + c, src[0] + off, ok);
      cp_async16(Gd + r * QP + c, src[3] + off, ok);
    }
    for (int e = tid; e < KT * CH; e += NTHR) {
      const int r = e / CH, c = (e - r * CH) * 8;
      const bool ok = k0 + r < L;
      const long long off = ok ? (r0 + k0 + r) * DH + c : 0;
      cp_async16(Kd + r * QP + c, src[1] + off, ok);
      cp_async16(Vd + r * QP + c, src[2] + off, ok);
    }
    for (int e = tid; e < 2 * L; e += NTHR) {
      const int z = e / L, q = e - z * L;
      cp_async4(Sd + z * Lp + q, st_src[z] + r0 + q);
    }
    cp_async_commit();
  };

  // rows past L: no probability
  for (int q = L + tid; q < Lp; q += NTHR) {
    float* Sd = reinterpret_cast<float*>(bufs + qgb + kvb);
    Sd[q] = INFINITY;
    Sd[Lp + q] = 0.f;
  }
  uint8_t fl[FLAGS];
  load_flags<NTHR>(wmask, blockIdx.x, n_my > 0, L, fl);
  if (has_bias) {
    const float* bias_h = bias + (long long)h * L * L;
    for (int e = tid; e < Lp * KT; e += NTHR) {
      const int q = e / KT, c = e - q * KT;
      Bt[q * TP + c] = __float2bfloat16(
          q < L && k0 + c < L ? __ldg(bias_h + (long long)q * L + k0 + c) : 0.f);
    }
  }
  const int kl = kr * 16 + lane / 4;               // local keys kl, kl + 8

  for (int i = 0; i < n_my; ++i) {
    const long long grp = blockIdx.x + (long long)i * gridDim.x;
    const long long r0 = grp * L;
    __syncthreads();                   // the last group is done
    const int any_valid = store_flags<NTHR>(koff, L, Lp, fl);
    for (int r = tid; r < KT; r += NTHR)
      pkey[r] = k0 + r < L ? (int)g.pixel(r0 + k0 + r) : 0;
    issue(i);
    load_flags<NTHR>(wmask, grp + gridDim.x, i + 1 < n_my, L, fl);
    cp_async_wait_all();
    if (!__syncthreads_or(any_valid)) open_group<NTHR>(koff, L);
    unsigned char* b = bufs;
    const bf16* Qs = reinterpret_cast<const bf16*>(b);
    const bf16* Gs = Qs + Lp * QP;
    const bf16* Ks = reinterpret_cast<const bf16*>(b + qgb);
    const bf16* Vs = Ks + KT * QP;
    const float* lse_s = reinterpret_cast<const float*>(b + qgb + kvb);
    const float* dlt_s = lse_s + Lp;
    float* xch = reinterpret_cast<float*>(b);

    uint32_t ka[DH / 16][4], va[DH / 16][4];
    load_a<DH>(Ks, kr, QP, lane, ka);
    load_a<DH>(Vs, kr, QP, lane, va);
    float dk[DH / 8][4] = {}, dv[DH / 8][4] = {};
    for (int qt = qs; qt < nt; qt += QS) {
      float st[2][4] = {}, dpt[2][4] = {};
      s_dp<DH>(ka, va, Qs, Gs, qt * 16, QP, lane, st, dpt);
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = qt * 16 + j * 8 + 2 * (lane % 4) + (c % 2);
          const int key = kl + (c / 2) * 8;
          const float bv = has_bias ? __bfloat162float(Bt[q * TP + key]) : 0.f;
          const float ko = k0 + key < Lp ? koff[k0 + key] : -INFINITY;
          const float pv = __expf(st[j][c] * inv_scale + bv + ko - lse_s[q]);
          st[j][c] = pv;
          dpt[j][c] = pv * (dpt[j][c] - dlt_s[q]);
        }
        pa[2 * j] = pack_bf16(st[j][0], st[j][1]);
        pa[2 * j + 1] = pack_bf16(st[j][2], st[j][3]);
        sa[2 * j] = pack_bf16(dpt[j][0], dpt[j][1]);
        sa[2 * j + 1] = pack_bf16(dpt[j][2], dpt[j][3]);
      }
      mma_kn<DH>(dv, pa, Gs, qt * 16, QP, lane);
      mma_kn<DH>(dk, sa, Qs, qt * 16, QP, lane);
    }
    // the QS shares of dK, then of dV, through the space of Q and dO
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      __syncthreads();                 // Q, dO (or the last round) are read
#pragma unroll
      for (int n8 = 0; n8 < DH / 8; ++n8)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* a = round == 0 ? dk[n8] : dv[n8];
          *reinterpret_cast<float2*>(xch + (qs * KT + kl + u * 8) * XP +
                                     n8 * 8 + 2 * (lane % 4)) =
              make_float2(a[2 * u], a[2 * u + 1]);
        }
      __syncthreads();
      for (int e = tid; e < KT * DH / 2; e += NTHR) {
        const int r = e / (DH / 2), d = (e - r * (DH / 2)) * 2;
        const int key = k0 + r;
        if (key >= L) continue;
        float a0 = 0.f, a1 = 0.f;
        for (int k = 0; k < QS; ++k) {
          const float2 v = *reinterpret_cast<const float2*>(
              xch + (k * KT + r) * XP + d);
          a0 += v.x;
          a1 += v.y;
        }
        const float sc = round == 0 ? inv_scale : 1.f;
        *reinterpret_cast<__nv_bfloat162*>(dqkv + (long long)pkey[r] * C3 +
                                           (round == 0 ? C : C2) + hc + d) =
            __floats2bfloat162_rn(a0 * sc, a1 * sc);
      }
    }
  }
}

// ------------------------------------------------------------ planning

enum Route { NONE = 0, CUDA_CORES = 1, TENSOR_CORES = 2, TENSOR_CORES_TILED = 3 };

struct Plan {
  int route = NONE;
  int blocks = 0;      // blocks a head (and a tile) along the groups; the
                       // partial bias tables are blocks x heads x L x L
  int blocks_b = 0;    // the keys kernel's, tiled route
  int tile = 0;        // CUDA-core query tile, or the rows kernel's QT
  int tile_b = 0;      // the keys kernel's KT
  bool bias_acc = false;
  size_t smem = 0, smem_b = 0;
};

// The largest tile (64, 32 or 16 rows) whose shared memory fits, for a rows
// or keys kernel; false if none does.
template <typename F>
bool pick_tile(int L, int warps, size_t optin, F smem, int* tile) {
  const int lp = round16(L);
  for (int t = 64; t >= 16; t /= 2)
    if (t <= 16 * warps && (t <= lp || t == 16) && smem(t) <= optin) {
      *tile = t;
      return true;
    }
  return false;
}

template <int DH>
void plan_tc(Plan& pl, int L, long long n_groups, int heads, bool bias,
             size_t optin) {
  const size_t wg = tc_smem(L, DH, bias);
  if (wg <= optin) {
    pl.route = TENSOR_CORES;
    pl.smem = wg;
    pl.blocks = wave_share(attn_bwd_tc_kernel<DH>, TC_THREADS, wg, heads,
                           n_groups);
    if (!pl.blocks) pl.route = NONE;
    return;
  }
  constexpr int W = tile_warps(DH), WK = W;
  if (!pick_tile(L, W, optin, [&](int t) {
        return rows_smem(L, DH, t, W, bias); }, &pl.tile) ||
      !pick_tile(L, WK, optin, [&](int t) {
        return keys_smem(L, DH, t, WK, bias); }, &pl.tile_b))
    return;
  pl.route = TENSOR_CORES_TILED;
  pl.smem = rows_smem(L, DH, pl.tile, W, bias);
  pl.smem_b = keys_smem(L, DH, pl.tile_b, WK, bias);
  pl.blocks = wave_share(attn_bwd_rows_kernel<DH, W>, W * 32, pl.smem,
                         (long long)heads * ((L + pl.tile - 1) / pl.tile),
                         n_groups);
  pl.blocks_b = wave_share(attn_bwd_keys_kernel<DH, WK>, WK * 32, pl.smem_b,
                           (long long)heads * ((L + pl.tile_b - 1) / pl.tile_b),
                           n_groups);
  if (!pl.blocks || !pl.blocks_b) pl.route = NONE;
}

Plan make_plan(int dtype, int C, int heads, int L, long long n_groups,
               bool bias) {
  Plan pl;
  if (heads <= 0 || C % heads != 0 || L <= 0 || n_groups <= 0 ||
      (dtype != 0 && dtype != 1))
    return pl;
  const int dh = C / heads;
  const size_t optin = (size_t)smem_optin();
  if (dtype == 1 && dh % 16 == 0 && dh <= 64) {
    if (dh == 16) plan_tc<16>(pl, L, n_groups, heads, bias, optin);
    else if (dh == 32) plan_tc<32>(pl, L, n_groups, heads, bias, optin);
    else if (dh == 64) plan_tc<64>(pl, L, n_groups, heads, bias, optin);
    if (pl.route != NONE) return pl;
    pl = Plan();
  }
  bwd_config(L, dh, bias, &pl.tile, &pl.bias_acc);
  if (!pl.tile) return pl;
  pl.smem = bwd_smem_floats(L, dh, pl.tile, pl.bias_acc) * sizeof(float);
  pl.blocks = dtype == 0
      ? wave_share(attn_bwd_kernel<float>, BWD_THREADS, pl.smem, heads, n_groups)
      : wave_share(attn_bwd_kernel<bf16>, BWD_THREADS, pl.smem, heads, n_groups);
  if (pl.blocks) pl.route = CUDA_CORES;
  return pl;
}

// ------------------------------------------------------------- launching

template <int DH>
cudaError_t launch_tc(const Plan& pl, const bf16* proj, const uint8_t* wmask,
                      const float* bias, bf16* dqkv, float* partial,
                      float* stats, Geom g, long long n_groups, int n_tok,
                      int C, int heads, cudaStream_t stream) {
  cudaError_t err;
  if (pl.route == TENSOR_CORES) {
    if ((err = allow_smem(attn_bwd_tc_kernel<DH>, pl.smem)) != cudaSuccess)
      return err;
    attn_bwd_tc_kernel<DH><<<dim3(pl.blocks, heads), TC_THREADS, pl.smem,
                             stream>>>(proj, wmask, bias, dqkv, partial, g,
                                       (int)n_groups, n_tok, C, heads);
    return cudaGetLastError();
  }
  constexpr int W = tile_warps(DH), WK = W;
  if ((err = allow_smem(attn_bwd_rows_kernel<DH, W>, pl.smem)) != cudaSuccess ||
      (err = allow_smem(attn_bwd_keys_kernel<DH, WK>, pl.smem_b)) != cudaSuccess)
    return err;
  const int L = g.L;
  attn_bwd_rows_kernel<DH, W>
      <<<dim3(pl.blocks, (L + pl.tile - 1) / pl.tile, heads), W * 32, pl.smem,
         stream>>>(proj, wmask, bias, dqkv, partial, stats, g, (int)n_groups,
                   n_tok, C, heads, pl.tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_keys_kernel<DH, WK>
      <<<dim3(pl.blocks_b, (L + pl.tile_b - 1) / pl.tile_b, heads), WK * 32,
         pl.smem_b, stream>>>(proj, wmask, bias, dqkv, stats, g, (int)n_groups,
                              n_tok, C, heads, pl.tile_b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cc(const Plan& pl, const T* proj, const uint8_t* wmask,
                      const float* bias, T* dqkv, float* partial, Geom g,
                      long long n_groups, int n_tok, int C, int heads,
                      cudaStream_t stream) {
  cudaError_t err;
  if (bias && !pl.bias_acc &&
      (err = cudaMemsetAsync(partial, 0,
                             (size_t)pl.blocks * heads * g.L * g.L * sizeof(float),
                             stream)) != cudaSuccess)
    return err;
  if ((err = allow_smem(attn_bwd_kernel<T>, pl.smem)) != cudaSuccess) return err;
  attn_bwd_kernel<T><<<dim3(pl.blocks, heads), BWD_THREADS, pl.smem, stream>>>(
      proj, wmask, bias, dqkv, partial, g, (int)n_groups, n_tok, C, heads,
      pl.tile, pl.bias_acc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_proj_cc(const void* x, const void* pos, const void* gy,
                           const uint8_t* mask, const void* w_in,
                           const void* b_in, const void* w_out, void* proj,
                           uint8_t* wmask, Geom g, int n_tok, int C, int heads,
                           cudaStream_t stream) {
  const dim3 grid((n_tok + PC_T - 1) / PC_T, 4 * ((C + PC_T - 1) / PC_T));
  attn_bwd_proj_cc_kernel<T><<<grid, PC_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(pos),
      static_cast<const T*>(gy), mask, static_cast<const T*>(w_in),
      static_cast<const T*>(b_in), static_cast<const T*>(w_out),
      static_cast<T*>(proj), wmask, g, n_tok, C, heads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The route a call of these shapes takes (0: none, the call is refused;
// 1 cuda_cores; 2 tensor_cores; 3 tensor_cores_tiled), and in out[0] the
// partial bias tables it sums (0 without a bias), in out[1] the float32
// row statistics it keeps (2 x heads x tokens on the tiled route).
int window_attn_bwd_plan(int dtype, int B, int Hp, int Wp, int C, int heads,
                         int wh, int ww, int has_bias, long long* out) {
  out[0] = out[1] = 0;
  if (wh <= 0 || ww <= 0 || Hp % wh || Wp % ww) return NONE;
  const long long n_groups = (long long)B * (Hp / wh) * (Wp / ww);
  const Plan pl = make_plan(dtype, C, heads, wh * ww, n_groups, has_bias != 0);
  if (pl.route == NONE) return NONE;
  out[0] = has_bias ? pl.blocks : 0;
  out[1] = pl.route == TENSOR_CORES_TILED ? 2LL * heads * B * Hp * Wp : 0;
  return pl.route;
}

// dtype: 0 = float32, 1 = bfloat16 (x, pos, gy, w_in, b_in, w_out, proj,
// dqkv).  x, pos, gy: (B, Hp, Wp, C) pixel order; mask (B, Hp, Wp) bool;
// w_in (3C, C), b_in (3C), w_out (C, C) in the activation dtype; bias
// (heads, L, L) float32 or NULL.  Scratch: proj (4, heads, B Hp Wp, dh) in
// the activation dtype; wmask (B Hp Wp) bytes, the mask in window order;
// fws float32, the partial bias tables then the row
// statistics (window_attn_bwd_plan's counts).  Writes dqkv (B Hp Wp, 3C):
// [dQ dK dV] of the projection outputs in pixel order, and g_bias (heads,
// L, L) float32 (NULL without bias).
int window_attn_bwd(const void* x, const void* pos, const void* gy,
                    const void* mask, const void* w_in, const void* b_in,
                    const void* w_out, const void* bias, void* proj,
                    void* wmask, void* fws, void* dqkv, void* g_bias, int dtype, int B, int Hp, int Wp,
                    int C, int heads, int wh, int ww, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((bias == nullptr) != (g_bias == nullptr) || wh <= 0 || ww <= 0 ||
      Hp % wh || Wp % ww)
    return (int)cudaErrorInvalidValue;
  const Geom g{Hp, Wp, wh, ww, Hp / wh, Wp / ww, wh * ww};
  const long long n_groups = (long long)B * g.nwh * g.nww;
  if (n_groups == 0) return 0;
  const int n_tok = (int)(n_groups * g.L);
  const Plan pl = make_plan(dtype, C, heads, g.L, n_groups, bias != nullptr);
  if (pl.route == NONE) return (int)cudaErrorInvalidValue;
  const uint8_t* m8 = static_cast<const uint8_t*>(mask);
  uint8_t* wm8 = static_cast<uint8_t*>(wmask);
  const float* fb = static_cast<const float*>(bias);
  float* partial = static_cast<float*>(fws);
  float* stats = partial + (bias ? (long long)pl.blocks * heads * g.L * g.L : 0);
  cudaError_t err;
  // (P) Q, K, V, dO
  if (dtype == 1 && C % PT_N == 0) {
    const dim3 grid((n_tok + PT_M - 1) / PT_M, 4 * (C / PT_N));
    const size_t smem = proj_tc_smem();
    if ((err = allow_smem(attn_bwd_proj_tc_kernel, smem)) != cudaSuccess)
      return (int)err;
    attn_bwd_proj_tc_kernel<<<grid, PT_THREADS, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(pos),
        static_cast<const bf16*>(gy), m8, static_cast<const bf16*>(w_in),
        static_cast<const bf16*>(b_in), static_cast<const bf16*>(w_out),
        static_cast<bf16*>(proj), wm8, g, n_tok, C, heads);
    err = cudaGetLastError();
  } else if (dtype == 1) {
    err = launch_proj_cc<bf16>(x, pos, gy, m8, w_in, b_in, w_out, proj, wm8,
                               g, n_tok, C, heads, s);
  } else {
    err = launch_proj_cc<float>(x, pos, gy, m8, w_in, b_in, w_out, proj, wm8,
                                g, n_tok, C, heads, s);
  }
  if (err != cudaSuccess) return (int)err;
  // (A) the attention core
  if (pl.route == CUDA_CORES) {
    err = dtype == 0
        ? launch_cc<float>(pl, static_cast<const float*>(proj), wm8, fb,
                           static_cast<float*>(dqkv), partial, g, n_groups,
                           n_tok, C, heads, s)
        : launch_cc<bf16>(pl, static_cast<const bf16*>(proj), wm8, fb,
                          static_cast<bf16*>(dqkv), partial, g, n_groups,
                          n_tok, C, heads, s);
  } else {
    const bf16* pj = static_cast<const bf16*>(proj);
    bf16* dq = static_cast<bf16*>(dqkv);
    switch (C / heads) {
      case 16:
        err = launch_tc<16>(pl, pj, wm8, fb, dq, partial, stats, g, n_groups,
                            n_tok, C, heads, s);
        break;
      case 32:
        err = launch_tc<32>(pl, pj, wm8, fb, dq, partial, stats, g, n_groups,
                            n_tok, C, heads, s);
        break;
      default:
        err = launch_tc<64>(pl, pj, wm8, fb, dq, partial, stats, g, n_groups,
                            n_tok, C, heads, s);
    }
  }
  if (err != cudaSuccess || !bias) return (int)err;
  // (R) the bias gradient
  const long long size = (long long)heads * g.L * g.L;
  attn_bwd_bias_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      partial, static_cast<float*>(g_bias), pl.blocks, size);
  return (int)cudaGetLastError();
}

}  // extern "C"
