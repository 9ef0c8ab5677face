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
// L is 64 for the 8x8 windows and 312 / 84 / 24 / 6 for the grid groups of
// the 800x1536 canvas (336 at 896x1536).  A "group" below is one window or
// grid group.
//
// What bounds it.  Per token the projections do 8 C^2 = 524k operations
// (C=256) and the attention 4 L C: 85% of the work is the four projections
// at L=64, 67% at L=312.  The bytes a token must move are x, pos, the mask
// and out: ~1.5 KB.  At 24 lanes of the 800x1536 canvas a step's 12 calls
// do 1.28 TFLOP against ~1 GB: 1.29 ms at the 989 TFLOP/s bf16 peak, so the
// bound is the tensor cores, and only wgmma reaches their rate.  Past the
// bound, three costs decide the time.  (1) The softmax is CUDA-core work:
// ~10-13 instructions a logit (scale, bias, mask, max, exp, sum, P), and a
// step has 2.1 G logits (8 heads x 64 keys a window token, x 312 keys a
// grid token at level 0).  (2) The weights are 512 KB in bf16, twice a
// block's shared memory: they stream from L2, so each pass has to serve as
// many rows as a block holds.  (3) Registers: ptxas gives every thread of
// a 384-thread block 168 (setmaxnreg does not raise that budget), and the
// O fragments of all heads take 64 of them.
//
// Design of the bfloat16 route ("wgmma"; C = 64 ... 256 in steps of 64,
// head dim 16, 32 or 64, groups of up to 512 keys, a block within the
// card's shared memory):
//   * k2_prep_kernel rounds W_in and W_out to bf16 once a call, and the
//     bias table to bf16 in the order the attention core reads it (each
//     lane's 32 logits of a 16 x 64 tile as four 16-byte pieces), into the
//     scratch.
//   * A block is two consumer warpgroups and a producer warpgroup.  Each
//     consumer owns a 64-row tile (wgmma's M) across all heads.  One thread
//     of the producer keeps NSTAGE 64x64 weight blocks in flight by TMA
//     (128-byte swizzle) through full / empty mbarriers; both consumers use
//     every block, so the weights cross L2 once per 128 rows.  A tile's x
//     and x + pos (rounded to bf16) are gathered once through the partition
//     addressing by cp.async into the same swizzled layout, and stay in
//     shared memory for every head; the next tile's are fetched while the
//     current one finishes.
//   * Every projection is wgmma m64n64k16 (bf16 in, f32 accumulate) over
//     C/64 weight blocks; bias in f32, rounded once.  The attention core
//     keeps the previous kernel's numerics and mma.sync tiles: per warp 16
//     query rows, mma.sync m16n8k16 via ldmatrix (the softmax lives in the
//     accumulator registers between the two products), an online f32
//     softmax over key tiles of 64 with scale, bias, key mask (keys of
//     other groups or past L at -inf, padded keys at -FLT_MAX unless the
//     group is opened), P rounded to bf16, O / l rounded to bf16.  The
//     output projection runs from O / l on wgmma and stores O Wo^T + bo
//     through the merge addressing into `out`, each 64-column block staged
//     in shared memory for 16-byte stores: no head-output map.
//   * The kernel is instantiated per mode (one mode's state only: with the
//     mode a runtime value its registers spilled).
//   * "fused" mode, groups of L <= 64 (the windows; grid levels 2 and 3):
//     one launch after the prep.  A tile holds floor(64 / L) whole groups
//     (keys of another group masked); Q, K, V of a 64-column chunk of heads
//     are projected into shared memory, its heads attend, the next chunk
//     follows.  O / l of every head stays in registers as wgmma A
//     fragments (warp w holds rows 16w .. 16w + 15 in both layouts; ptxas
//     keeps them in local memory), and the output projection takes A from
//     them.
//   * Larger groups (grid L = 84, 312, 336): a group's Q, K and V for all
//     heads (~480 KB at L = 312) fit no block, and neither do its x and
//     x + pos (320 KB); its keys would have to be spread over a cluster and
//     read across it.  Instead "kv" mode projects K and V of every token to
//     a bf16 scratch (heads, tokens, head dim), and "query" mode gives each
//     warpgroup a 64-row query tile: Q of all heads from its x + pos into
//     shared memory, then, through a cp.async ring of key tiles (K, V and
//     the tile's bias), the group's keys head by head; O / l overwrites the
//     head's Q columns, and the output projection reads it from shared
//     memory.  This costs K and V once through device memory (~1 KB a
//     token each way) and a second launch, at the grid layer's levels 0
//     and 1.
// With a gradient the head outputs O / l (tokens x C, window order, bf16)
// are also stored for the backward's output-projection gradient.
//
// Float32, and shapes the wgmma route does not take (head dim 8, C not a
// multiple of 64 or above 256, more than 512 keys), run three CUDA-core
// kernels with f32 FMAs: proj_kernel (QKV projection through the partition
// addressing into a Q/K/V scratch), attn_kernel (per (group, head,
// 32-query tile) exact two-pass softmax) and proj_kernel again for the
// output projection.  No model configuration of the repository reaches
// them in bf16.
//
// Interface: plain C, loaded with ctypes; the caller allocates `out`, the
// scratch (window_attn_plan() says which route and how much) and `o` (the
// CUDA-core route always needs it; the wgmma route writes it where given),
// and owns the stream.  Returns cudaGetLastError() after the launches.

#include <cuda.h>
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

constexpr int ROWS = 64;               // rows of a warpgroup's tile: wgmma's M
constexpr int CONSUMERS = 2;           // warpgroups of a block
// + a producer warpgroup, which gives its registers to the consumers:
// 168 a thread at launch (384 threads), 40 / 232 after setmaxnreg
constexpr int TC_THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int NSTAGE = 5;              // weight blocks in flight
constexpr int WBLOCK = 64 * 64 * 2;    // bytes of a 64 x 64 bf16 block
constexpr int MAX_KEYS = 512;          // keys of a group, rounded to 64
constexpr int MAX_C = 256;
// per warpgroup: pixel of each row (8 B) for this item and the next, key
// penalties (float), key codes, "group has an unpadded key" flags
constexpr int META = 2 * ROWS * 8 + MAX_KEYS * 4 + MAX_KEYS + 64;

enum { FUSED = 0, KV = 1, QUERY = 2 };

// Query mode's ring of key tiles: a stage holds K and V of 64 keys of one
// head and the bias of the warpgroup's 64 query rows for them (in
// fragment order, 8 KB); stages by head dim, 48 KB in all.
__host__ __device__ constexpr int kv_stages(int dh) {
  return dh == 64 ? 2 : dh == 32 ? 3 : 4;
}
__host__ __device__ constexpr uint32_t kv_stage_bytes(int dh) {
  return 2 * 64 * dh * 2 + 8192;
}

// Shared memory of a block, the same on the host and in the kernel.  Per
// warpgroup: region r1 (the x + pos tile, then in fused mode the Q, K, V
// blocks of a chunk, in query mode the ring of key tiles) and region x
// (the x tile; in query mode Q of all heads).
struct Plan {
  int nch, dh, Lr, G, R;                   // R: rows of a bias table
  uint32_t r1, xr, per_wg, total;
};

__host__ __device__ inline Plan make_plan(int C, int heads, int L,
                                          int mode) {
  Plan p;
  p.nch = C / 64;
  p.dh = C / heads;
  p.Lr = (L + 63) / 64 * 64;
  p.G = L <= ROWS ? ROWS / L : 1;
  p.R = L <= ROWS ? ROWS : p.Lr;
  const uint32_t tile = (uint32_t)p.nch * WBLOCK;
  const uint32_t ring =
      mode == QUERY ? kv_stages(p.dh) * kv_stage_bytes(p.dh) : 0;
  p.r1 = tile + 3 * WBLOCK > ring ? tile + 3 * WBLOCK : ring;
  p.xr = tile;
  p.per_wg = p.r1 + p.xr;
  p.total = 1024 + NSTAGE * WBLOCK + CONSUMERS * (p.per_wg + META) +
            2 * NSTAGE * 8;
  return p;
}

// byte offset -> its place in a 128-byte-swizzled buffer (the pattern of
// TMA's CU_TENSOR_MAP_SWIZZLE_128B and of wgmma's 128B layout, on a
// 1024-byte-aligned base): 16-byte unit i of each 128-byte line goes to
// i ^ (line % 8).  Rows of 32, 64 or 128 bytes read by ldmatrix at one
// column are then conflict-free.
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ ((off >> 3) & 0x70);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma / TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier of one consumer warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}
// one 64 x 64 bf16 block of the weights (columns col0.., rows row0..) by
// TMA into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col0, int row0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col0), "r"(row0), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major bf16 operand in the 128-byte swizzle: rows
// of 64 elements (128 B), 8-row groups 1024 B apart (SBO), base 1024-byte
// aligned.  Adding 2 advances K by 16 elements (32 B).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of wgmma operands across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[16][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(a[i][c])::"memory");
}

#define K2_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define K2_D32_OPS(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16, shared) B^T (B: 64 x 16, shared)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K2_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : K2_D32_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// the same with A (64 x 16) in registers: this thread's fragment a[4]
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K2_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : K2_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
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

// (lo, hi) rounded to bf16 (nearest even) in one 32-bit register, lo in
// the low half; no local variable's address is taken, so nothing goes to
// local memory
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// the bf16 pair of a register as float32
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// 8 bf16 of x + 8 of pos -> x + pos rounded to bf16
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  return pack_bf16(bf16_lo(a) + bf16_lo(b), bf16_hi(a) + bf16_hi(b));
}

// Weight block b of a work item's stream -> (first weight row, first
// column) in the bf16 weights [W_in; W_out] (4C x C).
__device__ __forceinline__ void weight_block(int mode, int nch, int C, int b,
                                             int& row0, int& col0) {
  col0 = (b % nch) * 64;
  const int pre = (mode == FUSED ? 3 : mode == QUERY ? 1 : 2) * nch * nch;
  if (b >= pre) {                          // the output projection
    row0 = 3 * C + (b - pre) / nch * 64;
  } else if (mode == FUSED) {              // chunk c: Q, K, V
    const int c = b / (3 * nch), z = (b / nch) % 3;
    row0 = z * C + c * 64;
  } else if (mode == QUERY) {              // Q, chunk by chunk
    row0 = b / nch * 64;
  } else {                                 // K then V
    row0 = C + b / nch * 64;
  }
}

__device__ __forceinline__ int item_blocks(int mode, int nch) {
  return (mode == KV ? 2 : mode == QUERY ? 2 : 4) * nch * nch;
}

// The weight ring: stage s's block at ring + s * WBLOCK, its full and
// empty barriers.  `n` counts the blocks a warpgroup has consumed of the
// sequence the producer issues; both warpgroups use every block, and each
// consuming warp releases it (one arrival).
struct Ring {
  uint32_t ring, full, empty;
  __device__ uint32_t stage(uint32_t n) const { return ring + (n % NSTAGE) * WBLOCK; }
  __device__ uint32_t full_bar(uint32_t n) const { return full + (n % NSTAGE) * 8; }
  __device__ uint32_t empty_bar(uint32_t n) const { return empty + (n % NSTAGE) * 8; }
  __device__ uint32_t parity(uint32_t n) const { return (n / NSTAGE) & 1; }
  __device__ void release(uint32_t k, int lane) const {
    if (lane == 0) mbar_arrive(empty_bar(k));
  }
};

// acc = A (64 x C; C/64 swizzled blocks at `a`) . W^T over the ring's next
// C/64 blocks (64 weight rows).  One wgmma group stays in flight; a stage
// is released (one arrival per warp) when its products are done.
__device__ __forceinline__ void proj_ss(float (&acc)[32], uint32_t a, int nch,
                                        const Ring& rg, uint32_t& n,
                                        int lane) {
  // zeros (the first product overwrites them) tell the compiler that acc's
  // last value is dead, so it is not kept live across other work
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nch; ++kb, ++n) {
    mbar_wait(rg.full_bar(n), rg.parity(n));
    wgmma_fence();
    const uint64_t da = desc_sw128(a + kb * WBLOCK);
    const uint64_t db = desc_sw128(rg.stage(n));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss(acc, da + 2 * ks, db + 2 * ks, kb > 0 || ks > 0);
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();
      rg.release(n - 1, lane);
    }
  }
  wgmma_wait<0>();
  rg.release(n - 1, lane);
  fence_regs(acc);
}

// acc = O (64 x C; this thread's A fragments) . W^T over the next C/64
// blocks: the output projection.
__device__ __forceinline__ void proj_rs(float (&acc)[32],
                                        uint32_t (&o)[16][4], int nch,
                                        const Ring& rg, uint32_t& n,
                                        int lane) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_regs(o);
#pragma unroll
  for (int kb = 0; kb < MAX_C / 64; ++kb) {
    if (kb < nch) {
      mbar_wait(rg.full_bar(n), rg.parity(n));
      wgmma_fence();
      const uint64_t db = desc_sw128(rg.stage(n));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs(acc, o[kb * 4 + ks], db + 2 * ks, kb > 0 || ks > 0);
      wgmma_commit();
      if (kb > 0) {
        wgmma_wait<1>();
        rg.release(n - 1, lane);
      }
      ++n;
    }
  }
  wgmma_wait<0>();
  rg.release(n - 1, lane);
  fence_regs(acc);
  fence_regs(o);
}

// acc + bias (f32, rounded to bf16 first), rounded once, into a swizzled
// 64 x 64 block of shared memory (rows 16 wq + lane / 4 (+ 8)).
__device__ __forceinline__ void store_block(const float (&acc)[32],
                                            unsigned char* dst,
                                            const float* __restrict__ bias,
                                            int wq, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    const float b0 = round_to<bf16>(__ldg(bias + col));
    const float b1 = round_to<bf16>(__ldg(bias + col + 1));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * wq + lane / 4 + 8 * half;
      *reinterpret_cast<uint32_t*>(dst + swz(r * 128 + col * 2)) =
          pack_bf16(acc[4 * j + 2 * half] + b0, acc[4 * j + 2 * half + 1] + b1);
    }
  }
}

// Slots [slot0, slot0 + DH/16) of the output projection's A fragments
// (a runtime slot, a compile-time register index).
template <int DH>
__device__ __forceinline__ void put_o(uint32_t (&o)[16][4], int slot0,
                                      const uint32_t (&of)[DH / 16][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      if (i == slot0 + kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[i][c] = of[kk][c];
}

// The attention core of one head for one warp's 16 query rows q0 +
// [0, 16), key tile by key tile (attn_begin, attn_tile per 64 keys,
// attn_end).  The numerics of the previous mma.sync kernel: f32
// logits scaled by 1 / bf16(sqrt(dh)), the bias rounded to bf16 and added
// in f32, keys padded to the tile or of another group at -inf, padded keys
// at -FLT_MAX unless the group is opened, an online f32 softmax, P rounded
// to bf16 for P V, O / l rounded to bf16.
template <int DH> struct Attn {
  uint32_t qa[DH / 16][4];
  float m[2], lsum[2];
  float oacc[DH / 8][4];
};

// Q of a head: a swizzled 64 x 64 block at `q`, columns from q_col.
template <int DH>
__device__ __forceinline__ void attn_begin(Attn<DH>& a, uint32_t q, int q_col,
                                           int q0, int lane) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    ldsm_x4(a.qa[ks], q + swz((q0 + lane % 16) * 128 +
                              (q_col + ks * 16 + (lane / 16) * 8) * 2));
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    a.m[u] = -INFINITY;
    a.lsum[u] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) a.oacc[j][c] = 0.f;
}

// The key mask of this thread's 32 logits of a key tile, 2 bits each
// (logit (j, c) at bit 2 (4 j + c) of mask[j / 4]): 0 kept, 1 -FLT_MAX
// (a padded key of a group that is not opened), 2 -inf (no key, or a key
// of another group).  kcode[key] = flag << 6 | group (flag 0 key, 1 padded
// key, 2 no key) for the tile's 64 keys; the thread's rows u = 0, 1 are in
// group rg[u] (255: no row), opened where ropen[u].
__device__ __forceinline__ void key_mask(uint32_t (&mask)[2],
                                         const uint8_t* kcode,
                                         const int (&rg)[2],
                                         const bool (&ropen)[2], int lane) {
  mask[0] = mask[1] = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cd = kcode[j * 8 + 2 * (lane % 4) + e], f = cd >> 6;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t m = f == 2 || (cd & 63) != rg[u] ? 2u
                           : f == 1 && !ropen[u]         ? 1u
                                                          : 0u;
        const int c = 2 * u + e;
        mask[j / 4] |= m << (2 * (4 * (j % 4) + c));
      }
    }
}

// this thread's 32 bias values of a key tile, in the fragment order of
// k2_prep_kernel: value (j, c) of logit tile j is b[(j * 4 + c) / 8] element
// (j * 4 + c) % 8
__device__ __forceinline__ float frag_bias(const uint4 (&b)[4], int j, int c) {
  const int v = j * 4 + c;
  const uint4& q = b[v / 8];
  const int i = (v % 8) / 2;
  const uint32_t w = i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
  return v % 2 ? bf16_hi(w) : bf16_lo(w);
}

// One tile of 64 keys: K and V in swizzled row-major buffers (row pitch
// k_rb / v_rb bytes, the head's columns from col); b: the bias of the
// thread's logits where has_bias.  The key mask: where every row is of one
// group (ROWFREE), pen[key] added to the logit (0 kept, -FLT_MAX a padded
// key of a group that is not opened: x - FLT_MAX rounds to -FLT_MAX for
// any logit below 2^103, -inf no key); else `mask` (key_mask), applied
// only where `masked` (some logit of the warp's tile is masked).
template <int DH, bool ROWFREE>
__device__ __forceinline__ void attn_tile(Attn<DH>& a, uint32_t k, int k_rb,
                                          uint32_t v, int v_rb, int col,
                                          const uint32_t (&mask)[2],
                                          const float* pen, bool masked,
                                          const uint4 (&b)[4], bool has_bias,
                                          int lane) {
  const float inv_scale = 1.f / round_to<bf16>(sqrtf((float)DH));
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t r[4];
      ldsm_x4(r, k + swz((j * 8 + lane % 8 + (lane / 16) * 8) * k_rb +
                         (col + ks * 16 + ((lane / 8) % 2) * 8) * 2));
      mma_bf16(s[j], a.qa[ks], r[0], r[1]);
      mma_bf16(s[j + 1], a.qa[ks], r[2], r[3]);
    }
  }
  // scale, bias, key mask; the tile's row maxima
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float x = s[j][c] * inv_scale;
      if (has_bias) x += frag_bias(b, j, c);
      if (ROWFREE) {
        x += pen[j * 8 + 2 * (lane % 4) + c % 2];
      } else if (masked) {
        const uint32_t m = (mask[j / 4] >> (2 * (4 * (j % 4) + c))) & 3u;
        x = m == 0 ? x : m == 1 ? -FLT_MAX : -INFINITY;
      }
      s[j][c] = x;
      tmax[c / 2] = fmaxf(tmax[c / 2], x);
    }
  float corr[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    tmax[u] = fmaxf(tmax[u], __shfl_xor_sync(0xffffffffu, tmax[u], 1));
    tmax[u] = fmaxf(tmax[u], __shfl_xor_sync(0xffffffffu, tmax[u], 2));
    const float mn = fmaxf(a.m[u], tmax[u]);
    corr[u] = __expf(a.m[u] - mn);             // 0 on the first tile
    a.m[u] = mn;
    a.lsum[u] *= corr[u];
  }
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    a.oacc[j][0] *= corr[0];
    a.oacc[j][1] *= corr[0];
    a.oacc[j][2] *= corr[1];
    a.oacc[j][3] *= corr[1];
  }
  // P = exp(S - m) in f32, rounded to bf16 into the A operand of P V
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = 2 * kk + t;
      const float p0 = __expf(s[j][0] - a.m[0]), p1 = __expf(s[j][1] - a.m[0]);
      const float p2 = __expf(s[j][2] - a.m[1]), p3 = __expf(s[j][3] - a.m[1]);
      a.lsum[0] += p0 + p1;
      a.lsum[1] += p2 + p3;
      pa[2 * t] = pack_bf16(p0, p1);
      pa[2 * t + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int dn = 0; dn < DH / 16; ++dn) {
      uint32_t r[4];
      ldsm_x4_t(r, v + swz((kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * v_rb +
                           (col + dn * 16 + (lane / 16) * 8) * 2));
      mma_bf16(a.oacc[2 * dn], pa, r[0], r[1]);
      mma_bf16(a.oacc[2 * dn + 1], pa, r[2], r[3]);
    }
  }
}

// O / l, rounded to bf16, as the A fragments of the head's dh columns
// (columns 16 kk + [0, 16): one k16 step of the output projection).
template <int DH>
__device__ __forceinline__ void attn_end(Attn<DH>& a,
                                         uint32_t (&of)[DH / 16][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    a.lsum[u] += __shfl_xor_sync(0xffffffffu, a.lsum[u], 1);
    a.lsum[u] += __shfl_xor_sync(0xffffffffu, a.lsum[u], 2);
    a.lsum[u] = 1.f / a.lsum[u];
  }
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    of[kk][0] = pack_bf16(a.oacc[2 * kk][0] * a.lsum[0],
                          a.oacc[2 * kk][1] * a.lsum[0]);
    of[kk][1] = pack_bf16(a.oacc[2 * kk][2] * a.lsum[1],
                          a.oacc[2 * kk][3] * a.lsum[1]);
    of[kk][2] = pack_bf16(a.oacc[2 * kk + 1][0] * a.lsum[0],
                          a.oacc[2 * kk + 1][1] * a.lsum[0]);
    of[kk][3] = pack_bf16(a.oacc[2 * kk + 1][2] * a.lsum[1],
                          a.oacc[2 * kk + 1][3] * a.lsum[1]);
  }
}

// Head h's outputs of this thread's rows into o (tokens x C, window order)
template <int DH>
__device__ __forceinline__ void store_o(bf16* __restrict__ o,
                                        const uint32_t (&of)[DH / 16][4],
                                        int tok0, int nrows, int C, int h,
                                        int wq, int lane) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = 16 * wq + lane / 4 + 8 * u;
    if (r >= nrows) continue;
    bf16* dst = o + (long long)(tok0 + r) * C + h * DH + 2 * (lane % 4);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      *reinterpret_cast<uint32_t*>(dst + 16 * kk) = of[kk][u];
      *reinterpret_cast<uint32_t*>(dst + 16 * kk + 8) = of[kk][2 + u];
    }
  }
}

// The rows of tile T: first token (window order) and count; in query mode
// also the group and the tile's place in it.
__device__ __forceinline__ void tile_rows(int mode, int T, int n_tiles,
                                          const Plan& p, int L, int M,
                                          int& tok0, int& nrows, int& grp,
                                          int& tt) {
  tok0 = 0, nrows = 0, grp = 0, tt = 0;
  if (T >= n_tiles) return;
  if (mode == FUSED) {
    tok0 = T * p.G * L;
    nrows = min(p.G * L, M - tok0);
  } else if (mode == KV) {
    tok0 = T * ROWS;
    nrows = min(ROWS, M - tok0);
  } else {
    const int tpg = p.Lr / ROWS;
    grp = T / tpg;
    tt = T - grp * tpg;
    tok0 = grp * L + tt * ROWS;
    nrows = min(ROWS, L - tt * ROWS);
  }
}

// The pixels of a tile's rows (-1: no row), then its x into region x and
// its pos into r1 by cp.async (one committed group), zeros past the rows.
__device__ __forceinline__ void fetch_tile(long long* pix, const Geom& g,
                                           int tok0, int nrows,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ pos,
                                           uint32_t r1, uint32_t xr, int C,
                                           int t, int bar_id) {
  if (t < ROWS) pix[t] = t < nrows ? g.pixel(tok0 + t) : -1;
  wg_sync(bar_id);
  const int units = C / 8;                 // 16-byte units of a row
  for (int e = t; e < ROWS * units; e += 128) {
    const int r = e / units, u = e - r * units;
    const long long px = pix[r];
    const long long src = px >= 0 ? px * C + u * 8 : 0;
    const uint32_t d = (u / 8) * WBLOCK + swz(r * 128 + (u % 8) * 16);
    cp_async16(xr + d, x + src, px >= 0);
    cp_async16(r1 + d, pos + src, px >= 0);
  }
  cp_async_commit();
}

// Query mode: the copies of key-tile step i (head i / tpg, tile i % tpg)
// into ring stage i % kv_stages: K and V of 64 keys of the group (zeros
// past its L keys) and the bias tile of the warpgroup's query rows.  One
// committed group a step, empty past the last.
template <int DH>
__device__ __forceinline__ void issue_kv(int i, int steps, int tpg,
                                         uint32_t r1,
                                         const bf16* __restrict__ kv,
                                         const bf16* __restrict__ bias,
                                         int heads, int M, int grp, int tt,
                                         int L, int kv_rows, int R, int t) {
  if (i < steps) {
    const int h = i / tpg, kt = i - h * tpg;
    const uint32_t st = r1 + (i % kv_stages(DH)) * kv_stage_bytes(DH);
    const bf16* ksrc =
        kv + ((long long)h * M + (long long)grp * L + kt * 64) * DH;
    const bf16* vsrc = ksrc + (long long)heads * M * DH;
    constexpr int hu = DH / 8;             // 16-byte units of a K / V row
    for (int e = t; e < 64 * hu; e += 128) {
      const int j = e / hu, u = e - j * hu;
      const bool ok = kt * 64 + j < kv_rows;
      const uint32_t d = swz(j * DH * 2 + u * 16);
      cp_async16(st + d, ksrc + (ok ? j * DH + u * 8 : 0), ok);
      cp_async16(st + 64 * DH * 2 + d, vsrc + (ok ? j * DH + u * 8 : 0), ok);
    }
    if (bias != nullptr)
      for (int e = t; e < 512; e += 128) {
        const int w = e / 128, u = e - w * 128;
        const bf16* src =
            bias + (((long long)h * (R / 16) + 4 * tt + w) * tpg + kt) * 1024 +
            u * 8;
        cp_async16(st + 4 * 64 * DH + w * 2048 + u * 16, src, true);
      }
  }
  cp_async_commit();
}

// The wgmma route: see the header.  Work item i of a block covers tiles
// 2i (warpgroup 0) and 2i + 1 (warpgroup 1); a fused tile is G whole
// groups, a kv tile 64 tokens in window order, a query tile 64 query rows
// of one group.  Each warpgroup fetches its next tile's x and pos while it
// finishes the current one.
template <int DH, int MODE>
__global__ void __launch_bounds__(TC_THREADS, 1)
k2_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ pos,
             const uint8_t* __restrict__ mask,
             const __grid_constant__ CUtensorMap wmap,
             const float* __restrict__ b_in, const float* __restrict__ b_out,
             const bf16* __restrict__ bias, bf16* __restrict__ kv,
             bf16* __restrict__ o, bf16* __restrict__ out, Geom g,
             int n_groups, int C, int heads, int n_tiles) {
  // one instantiation a mode: with the mode a runtime value, every mode's
  // state stays live and spills
  constexpr int mode = MODE;
  constexpr int NKV = kv_stages(DH);
  constexpr uint32_t KVB = kv_stage_bytes(DH);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const Plan p = make_plan(C, heads, g.L, MODE);
  const int L = g.L, nch = p.nch;
  const uint32_t wg0 = base + NSTAGE * WBLOCK;
  unsigned char* meta0 = gbase + NSTAGE * WBLOCK + CONSUMERS * p.per_wg;
  const uint32_t bars = wg0 + CONSUMERS * (p.per_wg + META);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Ring rg{base, bars, bars + NSTAGE * 8};
  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(rg.full + 8 * s, 1);
      mbar_init(rg.empty + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_items = (n_tiles + CONSUMERS - 1) / CONSUMERS;
  const int per_item = item_blocks(mode, nch);

  if (warp >= CONSUMERS * 4) {             // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS * 4 && lane == 0) {
      uint32_t n = 0;
      for (int it = blockIdx.x; it < n_items; it += gridDim.x)
        for (int b = 0; b < per_item; ++b, ++n) {
          int row0, col0;
          weight_block(mode, nch, C, b, row0, col0);
          if (n >= NSTAGE) mbar_wait(rg.empty_bar(n), (n / NSTAGE - 1) & 1);
          mbar_expect_tx(rg.full_bar(n), WBLOCK);
          tma_load(rg.stage(n), &wmap, col0, row0, rg.full_bar(n));
        }
    }
    return;
  }

  // a consumer warpgroup
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4, wq = warp % 4, t = tid % 128;
  const int bar_id = 1 + wg;
  const uint32_t r1 = wg0 + wg * p.per_wg, xr = r1 + p.r1;
  unsigned char* r1g = gbase + (r1 - base);
  unsigned char* xrg = gbase + (xr - base);
  long long* pixes = reinterpret_cast<long long*>(meta0 + wg * META);
  float* pen = reinterpret_cast<float*>(pixes + 2 * ROWS);
  uint8_t* kcode = reinterpret_cast<uint8_t*>(pen + MAX_KEYS);
  uint8_t* gkey = kcode + MAX_KEYS;        // group has an unpadded key
  const int M = n_groups * L;
  const int tpg = p.Lr / ROWS;
  const int units = C / 8;
  uint32_t n = 0;
  float acc[32];
  uint32_t oreg[16][4];

  int tok0, nrows, grp, tt;
  tile_rows(mode, CONSUMERS * blockIdx.x + wg, n_tiles, p, L, M, tok0, nrows,
            grp, tt);
  fetch_tile(pixes, g, tok0, nrows, x, pos, r1, xr, C, t, bar_id);
  int parity = 0, ntok0, nnrows, ngrp, ntt;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x, parity ^= 1,
           tok0 = ntok0, nrows = nnrows, grp = ngrp, tt = ntt) {
    const int T = CONSUMERS * it + wg;
    long long* pix = pixes + parity * ROWS;
    // the next item's rows
    tile_rows(mode, T + CONSUMERS * gridDim.x, n_tiles, p, L, M, ntok0,
              nnrows, ngrp, ntt);
    long long* npix = pixes + (parity ^ 1) * ROWS;
    if (t < ROWS) gkey[t] = 0;
    wg_sync(bar_id);
    if (mode == FUSED) {
      if (t < ROWS) {
        int cd = 2 << 6 | 63;
        if (t < nrows) {
          const int pad = mask[pix[t]] ? 1 : 0;
          cd = pad << 6 | t / L;
          if (!pad) gkey[t / L] = 1;
        }
        kcode[t] = (uint8_t)cd;
      }
    } else if (mode == QUERY) {
      for (int j = t; j < p.Lr; j += 128) {
        int cd = 2 << 6;
        if (j < L && T < n_tiles) {
          const int pad = mask[g.pixel((long long)grp * L + j)] ? 1 : 0;
          cd = pad << 6;
          if (!pad) gkey[0] = 1;
        }
        kcode[j] = (uint8_t)cd;
      }
    }
    // this tile's x and pos are in: x + pos (bf16) over pos
    cp_async_wait<0>();
    for (int e = t; e < ROWS * units; e += 128) {
      const int r = e / units, u = e - r * units;
      const uint32_t d = (u / 8) * WBLOCK + swz(r * 128 + (u % 8) * 16);
      const uint4 xv = *reinterpret_cast<const uint4*>(xrg + d);
      const uint4 pv = *reinterpret_cast<const uint4*>(r1g + d);
      *reinterpret_cast<uint4*>(r1g + d) =
          make_uint4(add_bf16x2(xv.x, pv.x), add_bf16x2(xv.y, pv.y),
                     add_bf16x2(xv.z, pv.z), add_bf16x2(xv.w, pv.w));
    }
    fence_proxy_async();
    wg_sync(bar_id);

    // the key mask: a penalty a key where every row is of one group (query
    // mode; fused mode at G = 1), else two bits a logit (key_mask)
    const bool rowfree = mode == QUERY || (mode == FUSED && p.G == 1);
    uint32_t kmask[2] = {0, 0};
    bool kmasked = false;
    if (mode != KV && rowfree) {
      const bool open = !gkey[0];
      for (int j = t; j < (mode == QUERY ? p.Lr : ROWS); j += 128) {
        const int f = kcode[j] >> 6;
        pen[j] = f == 2 ? -INFINITY : f == 1 && !open ? -FLT_MAX : 0.f;
      }
      wg_sync(bar_id);
    } else if constexpr (mode == FUSED) {
      int rgrp[2];                         // this thread's two query rows
      bool ropen[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 16 * wq + lane / 4 + 8 * u;
        const bool ok = r < nrows;
        rgrp[u] = ok ? r / L : 255;
        ropen[u] = ok && !gkey[ok ? rgrp[u] : 0];
      }
      key_mask(kmask, kcode, rgrp, ropen, lane);
      kmasked = __any_sync(0xffffffffu, (kmask[0] | kmask[1]) != 0);
    }

    if constexpr (mode == KV) {
      // K and V of every head, to kv (2, heads, tokens, dh)
      for (int nb = 0; nb < 2 * nch; ++nb) {
        proj_ss(acc, nb < nch ? r1 : xr, nch, rg, n, lane);
        if (nb == 2 * nch - 1) {           // r1 and x are free
          fence_proxy_async();
          fetch_tile(npix, g, ntok0, nnrows, x, pos, r1, xr, C, t, bar_id);
        }
        const int z = nb / nch, cb = (nb - z * nch) * 64;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cb + 8 * j + 2 * (lane % 4);
          const float b0 = round_to<bf16>(__ldg(b_in + C + nb * 64 + col - cb));
          const float b1 =
              round_to<bf16>(__ldg(b_in + C + nb * 64 + col - cb + 1));
          const int h = col / DH, d = col - h * DH;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * wq + lane / 4 + 8 * half;
            if (r >= nrows) continue;
            *reinterpret_cast<__nv_bfloat162*>(
                kv + (((long long)z * heads + h) * M + tok0 + r) * DH + d) =
                __floats2bfloat162_rn(acc[4 * j + 2 * half] + b0,
                                      acc[4 * j + 2 * half + 1] + b1);
          }
        }
      }
      continue;
    }

    if constexpr (mode == FUSED) {
      unsigned char* qc = r1g + nch * WBLOCK;
      const uint32_t qs = r1 + nch * WBLOCK;
      for (int c = 0; c < nch; ++c) {
        proj_ss(acc, r1, nch, rg, n, lane);
        store_block(acc, qc, b_in + c * 64, wq, lane);
        proj_ss(acc, r1, nch, rg, n, lane);
        store_block(acc, qc + WBLOCK, b_in + C + c * 64, wq, lane);
        proj_ss(acc, xr, nch, rg, n, lane);
        store_block(acc, qc + 2 * WBLOCK, b_in + 2 * C + c * 64, wq, lane);
        if (c == nch - 1) {                // the tile and x are free
          fence_proxy_async();
          fetch_tile(npix, g, ntok0, nnrows, x, pos, r1, xr, C, t, bar_id);
        } else {
          wg_sync(bar_id);                 // Q, K, V of the chunk are in
        }
#pragma unroll
        for (int hh = 0; hh < 64 / DH; ++hh) {
          const int h = c * (64 / DH) + hh;
          Attn<DH> a;
          attn_begin<DH>(a, qs, hh * DH, 16 * wq, lane);
          uint4 bp[4];
          if (bias != nullptr) {
            const uint4* src = reinterpret_cast<const uint4*>(
                                   bias + ((long long)h * 4 + wq) * 1024) +
                               lane;
#pragma unroll
            for (int q = 0; q < 4; ++q) bp[q] = __ldg(src + 32 * q);
          }
          if (rowfree)
            attn_tile<DH, true>(a, qs + WBLOCK, 128, qs + 2 * WBLOCK, 128,
                                hh * DH, kmask, pen, false, bp,
                                bias != nullptr, lane);
          else
            attn_tile<DH, false>(a, qs + WBLOCK, 128, qs + 2 * WBLOCK, 128,
                                 hh * DH, kmask, pen, kmasked, bp,
                                 bias != nullptr, lane);
          uint32_t of[DH / 16][4];
          attn_end<DH>(a, of);
          put_o<DH>(oreg, h * (DH / 16), of);
          if (o != nullptr) store_o<DH>(o, of, tok0, nrows, C, h, wq, lane);
        }
        wg_sync(bar_id);                   // the chunk's attention is done
      }
    } else if constexpr (mode == QUERY) {
      for (int c = 0; c < nch; ++c) {
        proj_ss(acc, r1, nch, rg, n, lane);
        store_block(acc, xrg + c * WBLOCK, b_in + c * 64, wq, lane);
      }
      fence_proxy_async();
      wg_sync(bar_id);                     // Q of every head is in; r1 free
      // key tiles (head h, tile kt) = step h * tpg + kt through a ring of
      // NKV stages in r1: K, V (64 x dh each) and the bias tile
      const int kv_rows = T < n_tiles ? L : 0, steps = heads * tpg;
#pragma unroll 1
      for (int s = 0; s < NKV - 1; ++s)
        issue_kv<DH>(s, steps, tpg, r1, kv, bias, heads, M, grp, tt, L,
                     kv_rows, p.R, t);
      Attn<DH> a;
      for (int i = 0; i < steps; ++i) {
        cp_async_wait<NKV - 2>();
        wg_sync(bar_id);                   // step i is in; step i - 1 done
        issue_kv<DH>(i + NKV - 1, steps, tpg, r1, kv, bias, heads, M, grp, tt,
                     L, kv_rows, p.R, t);
        const int h = i / tpg, kt = i - h * tpg;
        const uint32_t st = r1 + (i % NKV) * KVB;
        if (kt == 0)
          attn_begin<DH>(a, xr + (h * DH / 64) * WBLOCK, (h * DH) % 64,
                         16 * wq, lane);
        uint4 bp[4];
        if (bias != nullptr) {
          const uint4* src = reinterpret_cast<const uint4*>(
              gbase + (st - base) + 4 * 64 * DH + wq * 2048) + lane;
#pragma unroll
          for (int q = 0; q < 4; ++q) bp[q] = src[32 * q];
        }
        attn_tile<DH, true>(a, st, DH * 2, st + 64 * DH * 2, DH * 2, 0, kmask,
                            pen + kt * 64, false, bp, bias != nullptr, lane);
        if (kt == tpg - 1) {
          uint32_t of[DH / 16][4];
          attn_end<DH>(a, of);
          // O / l over the head's Q columns of the warp's own rows (read
          // into registers at kt == 0): the A operand of the output
          // projection
          unsigned char* ob = xrg + (h * DH / 64) * WBLOCK;
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int r = 16 * wq + lane / 4 + 8 * u;
              const int cl = (h * DH) % 64 + 16 * kk + 2 * (lane % 4);
              *reinterpret_cast<uint32_t*>(ob + swz(r * 128 + cl * 2)) =
                  of[kk][u];
              *reinterpret_cast<uint32_t*>(ob + swz(r * 128 + cl * 2 + 16)) =
                  of[kk][2 + u];
            }
          if (o != nullptr) store_o<DH>(o, of, tok0, nrows, C, h, wq, lane);
        }
      }
      cp_async_wait<0>();
      fence_proxy_async();
      wg_sync(bar_id);                     // O of every head is in
    }

    // out = O Wo^T + bo, through the merge addressing: each 64-column block
    // staged in shared memory (r1 past the x + pos tile, free now), then
    // stored a row's 128 bytes by 8 neighbouring threads
    unsigned char* stage = r1g + nch * WBLOCK;
    for (int nb = 0; nb < nch; ++nb) {
      if constexpr (mode == FUSED)
        proj_rs(acc, oreg, nch, rg, n, lane);
      else
        proj_ss(acc, xr, nch, rg, n, lane);
      store_block(acc, stage, b_out + nb * 64, wq, lane);
      wg_sync(bar_id);
#pragma unroll
      for (int e = t; e < ROWS * 8; e += 128) {
        const int r = e / 8, u = e % 8;
        const long long px = pix[r];
        if (px < 0) continue;
        *reinterpret_cast<uint4*>(out + px * C + nb * 64 + u * 8) =
            *reinterpret_cast<const uint4*>(stage + swz(r * 128 + u * 16));
      }
      wg_sync(bar_id);
    }
    if constexpr (mode == QUERY) {         // O (region x) is read
      fence_proxy_async();
      fetch_tile(npix, g, ntok0, nnrows, x, pos, r1, xr, C, t, bar_id);
    }
  }
  cp_async_wait<0>();
}

// W_in and W_out rounded to bf16 once a call, and the bias table rounded to
// bf16 in the order the attention core reads it: for head h, 16-row block
// qb of a table of R rows and keys, 64-key tile kt, lane l, the lane's 32
// logits (j, c) of mma.sync's accumulator layout (row 16 qb + l / 4 +
// 8 (c / 2), key 64 kt + 8 j + 2 (l % 4) + c % 2) as four 16-byte pieces,
// piece q of every lane together.  A fused tile of G groups of L keys has
// the groups' blocks on its diagonal (0 between groups); R = 64 there, the
// group's keys rounded up to 64 otherwise (G = 1).
__global__ void k2_prep_kernel(const float* __restrict__ w_in,
                               const float* __restrict__ w_out,
                               const float* __restrict__ bias,
                               bf16* __restrict__ wbf, bf16* __restrict__ bbf,
                               long long n_in4, long long n_w4, int heads,
                               int L, int G, int R) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n_bias = bias != nullptr ? (long long)heads * R * R : 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_w4 + n_bias; i += stride) {
    if (i < n_w4) {
      const float4 v = i < n_in4
                           ? __ldg(reinterpret_cast<const float4*>(w_in) + i)
                           : __ldg(reinterpret_cast<const float4*>(w_out) +
                                   (i - n_in4));
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(wbf + 4 * i);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
      continue;
    }
    const long long e = i - n_w4;
    const int within = (int)(e % 1024);
    const long long chunk = e / 1024;      // (h, qb, kt)
    const int nkt = R / 64, nqb = R / 16;
    const int kt = (int)(chunk % nkt), qb = (int)(chunk / nkt % nqb);
    const int h = (int)(chunk / nkt / nqb);
    const int q = within / 256, l = (within / 8) % 32, w = within % 8;
    const int v = q * 8 + w, j = v / 4, c = v % 4;
    const int r = 16 * qb + l / 4 + 8 * (c / 2);
    const int key = 64 * kt + 8 * j + 2 * (l % 4) + c % 2;
    const bool ok = r < G * L && key < G * L && r / L == key / L;
    bbf[e] = __float2bfloat16(
        ok ? __ldg(bias + ((long long)h * L + r % L) * L + key % L) : 0.f);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// bf16 elements of the wgmma route's scratch: the weights (4C x C), the
// bias table (heads x R x R, k2_prep_kernel's order, rounded up to 64),
// and for L > 64 K and V of every token (2 x tokens x C).
long long tc_scratch(int C, int heads, int L, bool bias, long long tokens) {
  const long long R = make_plan(C, heads, L, FUSED).R;
  const long long nb = bias ? (heads * R * R + 63) / 64 * 64 : 0;
  return 4LL * C * C + nb + (L > ROWS ? 2 * tokens * C : 0);
}

// The wgmma route takes bf16, C = 64 ... 256 in steps of 64, head dim 16,
// 32 or 64, at most MAX_KEYS keys, and a block that fits the card.
bool tc_ok(int dtype, int C, int heads, int L) {
  if (dtype != 1 || C % 64 != 0 || C > MAX_C || heads < 1 || C % heads != 0)
    return false;
  const int dh = C / heads;
  if ((dh != 16 && dh != 32 && dh != 64) || L < 1 || L > MAX_KEYS)
    return false;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  const uint32_t kv = make_plan(C, heads, L, KV).total;
  const uint32_t query = make_plan(C, heads, L, QUERY).total;
  const uint32_t smem = L <= ROWS ? make_plan(C, heads, L, FUSED).total
                                  : (kv > query ? kv : query);
  return smem <= (uint32_t)optin && encode_tiled() != nullptr;
}

// Blocks of one wave: resident blocks per SM x SMs, at most `work`.
template <typename K>
cudaError_t one_wave(K kernel, int threads, size_t smem, long long work,
                     unsigned* blocks) {
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
  long long n = (long long)occ * n_sm;
  n = n < 1 ? 1 : (n > work ? work : n);
  *blocks = (unsigned)n;
  return cudaSuccess;
}

template <int DH, int MODE>
cudaError_t launch_tc_mode(int n_tiles, const bf16* x, const bf16* pos,
                           const uint8_t* mask, const CUtensorMap& map,
                           const float* b_in, const float* b_out,
                           const bf16* bias, bf16* kv, bf16* o, bf16* out,
                           Geom g, int n_groups, int C, int heads,
                           cudaStream_t stream) {
  cudaError_t err;
  const size_t smem = make_plan(C, heads, g.L, MODE).total;
  if ((err = allow_smem(k2_tc_kernel<DH, MODE>, smem)) != cudaSuccess)
    return err;
  unsigned grid = 0;
  if ((err = one_wave(k2_tc_kernel<DH, MODE>, TC_THREADS, smem,
                      (n_tiles + CONSUMERS - 1) / CONSUMERS, &grid)) !=
      cudaSuccess)
    return err;
  k2_tc_kernel<DH, MODE><<<grid, TC_THREADS, smem, stream>>>(
      x, pos, mask, map, b_in, b_out, bias, kv, o, out, g, n_groups, C, heads,
      n_tiles);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_tc(const bf16* x, const bf16* pos, const uint8_t* mask,
                      const float* w_in, const float* b_in,
                      const float* w_out, const float* b_out,
                      const float* bias, bf16* scratch, bf16* o, bf16* out,
                      Geom g, long long n_groups, int C, int heads,
                      cudaStream_t stream) {
  cudaError_t err;
  const int L = g.L;
  const Plan p = make_plan(C, heads, L, FUSED);
  bf16* wbf = scratch;
  bf16* bbf = bias != nullptr ? wbf + 4LL * C * C : nullptr;
  bf16* kv = wbf + tc_scratch(C, heads, L, bias != nullptr, 0);
  const long long n_in4 = 3LL * C * C / 4, n_w4 = 4LL * C * C / 4;
  const long long n_bias = bias != nullptr ? (long long)heads * p.R * p.R : 0;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long prep_work = (n_w4 + n_bias + 255) / 256;
  k2_prep_kernel<<<(unsigned)(prep_work < 4 * n_sm ? prep_work : 4 * n_sm),
                   256, 0, stream>>>(w_in, w_out, bias, wbf, bbf, n_in4, n_w4,
                                     heads, L, p.G, p.R);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)4 * C};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {64, 64}, unit[2] = {1, 1};
  if (encode_tiled()(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wbf, dims,
                     strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;

  const long long M = n_groups * L;
  if (L <= ROWS)
    return launch_tc_mode<DH, FUSED>((int)((n_groups + p.G - 1) / p.G), x,
                                     pos, mask, map, b_in, b_out, bbf,
                                     nullptr, o, out, g, (int)n_groups, C,
                                     heads, stream);
  if ((err = launch_tc_mode<DH, KV>((int)((M + ROWS - 1) / ROWS), x, pos,
                                    mask, map, b_in, b_out, bbf, kv, nullptr,
                                    out, g, (int)n_groups, C, heads,
                                    stream)) != cudaSuccess)
    return err;
  return launch_tc_mode<DH, QUERY>((int)(n_groups * (p.Lr / ROWS)), x, pos,
                                   mask, map, b_in, b_out, bbf, kv, o, out, g,
                                   (int)n_groups, C, heads, stream);
}

// Float32, or bf16 shapes that the wgmma route does not take: the three
// CUDA-core kernels through the Q/K/V scratch `qkv`.
template <typename T>
cudaError_t launch_cuda_cores(const void* x, const void* pos,
                              const uint8_t* mask, const float* w_in,
                              const float* b_in, const float* w_out,
                              const float* b_out, const float* bias, void* qkv,
                              void* o, void* out, Geom g, long long n_win,
                              int C, int heads, cudaStream_t stream) {
  if (qkv == nullptr || o == nullptr) return cudaErrorInvalidValue;
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

// The route of a call and its scratch: 1 for the wgmma route (*scratch =
// its bf16 elements: weights, bias table, K and V where L > 64), 0 for the
// CUDA-core route (*scratch = the Q/K/V scratch's 3 x tokens x C elements
// in the activation dtype; `o` is then required).
int window_attn_plan(int dtype, int B, int Hp, int Wp, int C, int heads,
                     int wh, int ww, int has_bias, long long* scratch) {
  const long long tokens = (long long)B * Hp * Wp;
  const int L = wh * ww;
  if (tc_ok(dtype, C, heads, L)) {
    *scratch = tc_scratch(C, heads, L, has_bias != 0, tokens);
    return 1;
  }
  *scratch = 3 * tokens * C;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, pos, scratch, o, out).  Weights and
// biases are float32; mask is (B, Hp, Wp) bool (one byte each); bias is
// (heads, L, L) float32 or NULL.  scratch: window_attn_plan()'s; o:
// B*Hp*Wp*C elements (the head outputs in window order), or NULL on the
// wgmma route where nothing needs them.
int window_attn_fwd(const void* x, const void* pos, const void* mask,
                    const void* w_in, const void* b_in, const void* w_out,
                    const void* b_out, const void* bias, void* scratch,
                    void* o, void* out, int dtype, int B, int Hp, int Wp,
                    int C, int heads, int wh, int ww, void* stream) {
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
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_cuda_cores<float>(x, pos, m8, fw_in, fb_in, fw_out,
                                         fb_out, fbias, scratch, o, out, g,
                                         n_win, C, heads, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!tc_ok(dtype, C, heads, g.L))
    return (int)launch_cuda_cores<bf16>(x, pos, m8, fw_in, fb_in, fw_out,
                                        fb_out, fbias, scratch, o, out, g,
                                        n_win, C, heads, s);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* pb = static_cast<const bf16*>(pos);
  bf16* sb = static_cast<bf16*>(scratch);
  bf16* ob = static_cast<bf16*>(o);
  bf16* outb = static_cast<bf16*>(out);
#define K2_TC(DH)                                                           \
  launch_tc<DH>(xb, pb, m8, fw_in, fb_in, fw_out, fb_out, fbias, sb, ob,    \
                outb, g, n_win, C, heads, s)
  switch (C / heads) {
    case 16:
      return (int)K2_TC(16);
    case 32:
      return (int)K2_TC(32);
    default:
      return (int)K2_TC(64);
  }
#undef K2_TC
}

}  // extern "C"
