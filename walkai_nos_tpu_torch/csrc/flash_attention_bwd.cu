// Attention backward: K5 (dq and the row term D') and K6 (dk, dv).
//
// Replaces: walkai_nos_tpu/ops/attention.py:_flash_bwd_impl and its two
// TPU kernels, _flash_dq_kernel (K5) and _flash_dkv_kernel (K6), together
// with the XLA reduction in front of them (D'). They run the backward of
// flash_attention, flash_attention_with_lse and, after a recompute of
// (out, lse) with K4, of flash_attention_packed (the ViT's training path).
//
// What they compute, per (batch, head), from q, k, v [s, d], the output O
// and its cotangent g = dO, the saved f32 logsumexp lse [sq] and an
// optional f32 lse cotangent g_lse [sq]:
//   D' = rowsum(dO * O) - g_lse (K5 writes it, f32 [b, h, sq]),
//   S = (q k^T) * scale, P = exp(S - lse) on visible entries,
//   dP = g v^T, dS = P * (dP - D'),
//   dq = dS k * scale (K5), dk = dS^T q * scale and dv = P^T g (K6).
// K6 reads the D' that K5 wrote, so K5 launches first, on the same
// stream. Visibility is the forward's: key k is visible to query row q iff
// k < kv_len and, when causal, k <= q + sk - sq. P is SELECTED to 0 off
// the visible set, never multiplied by a mask: a row with lse < ~-88 over
// a zero tail would give exp(0 - lse) = inf and inf * 0 = NaN. A row that
// sees no key (causal, sq > sk) took the mean of V over all sk keys in the
// forward; its scores were constants, so it adds 1/sk * g to every dv row
// and nothing to dq or dk, as autodiff of the reference gives.
//
// Both kernels are deterministic: every output element is summed by one
// CTA in an order fixed by the shapes (dq over key tiles in order, dk and
// dv over query tiles in order, each D' row by the same threads in the
// same order), with no atomics, so gradients are bitwise identical from
// run to run.
//
// What bounds them on an H100, at the ViT's shape (b 32, s 296, h 6, d 64,
// bf16, per layer call): K5 reads q, k, v, dO, O and lse and writes dq and
// D', 44.1 MB (13.2 us at 3.35 TB/s) for 6.5 GFLOP (6.5 us of bf16 tensor
// cores); K6 reads q, k, v, dO, lse and D' and writes dk and dv, 44.1 MB
// (13.2 us) for 8.6 GFLOP (8.7 us). Bytes, on paper. At a causal LM shape
// (s 2048, d 64) the products bound them instead.
//
// The bf16 arm (the one every path of the port runs on the card): every
// product on tensor cores, as warpgroup MMA (wgmma.m64n64k16, bf16 in, f32
// accumulate; no TMA), no atomics:
// - one CTA per (batch*head, 64-row tile), one warpgroup of 4 warps, each
//   warp owning 16 rows: K5's query rows (Q and dO resident), K6's key rows
//   (K and V resident). The streamed operand (K5: K/V tiles; K6: Q/dO tiles
//   with their lse and D' rows) goes through a two-stage ring of 16-byte
//   cp.async.cg copies, the next tile in flight while the current one
//   computes, the ragged tail zero-filled through src-size;
// - operand tiles stay bf16 in shared memory as 64-column panels of 128-byte
//   rows, the 16-byte chunks of row r XOR-swizzled by r & 7: the hardware's
//   128-byte swizzle, so wgmma reads the tiles as they lie; head_dim below
//   64 or 128 is zero-padded;
// - S = Q K^T and dP = dO V^T (K6: S^T = K Q^T and dP^T = V dO^T,
//   key-major) read both operands from shared memory; P and dS are formed
//   in the accumulator registers and packed to bf16 as the register A
//   operand of the second product (dq += dS K; dv += P^T dO, dk += dS^T Q),
//   whose B operand is read transposed (MN-major) from the tile, so P and
//   dS never touch shared memory (as in FlashAttention-2/3), and B is read
//   once per warpgroup;
// - where a row start is not 16-byte aligned or d * 2 bytes is not a
//   multiple of 16, the same kernels load element by element into the same
//   swizzled tiles (a template switch of the load path, not another
//   kernel).
// The tiles, their copies and the wgmma wrappers live in hopper_mma.cuh,
// shared with the forward kernels (flash_attention.cu).
// What holds them above the bound at the ViT's shape: each CTA re-reads
// the streamed operand of its head from L2 (five 64-row tiles), and a
// tile's two products, its exponentials and its copies run one after the
// other within the CTA, overlapped only across the 3-4 CTAs an SM holds.
//
// The f32 arm keeps the earlier CUDA-core body (one 4x4 score block per
// thread over f32 tiles in shared memory, 256 threads); K5's f32 arm also
// computes D' in its prologue. Tensor cores would take f32 as TF32, which
// cannot meet the f32 tolerance (1e-4 relative), and no path of the port
// runs attention in f32 on the card.

#include <math.h>

#include "hopper_mma.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// P and dS of one (query row qp, key kp) entry; see the header for the
// visibility rule and the rows that see no key.
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float dd,
                                     int qp, int kp, const Shape& sh,
                                     float* p, float* ds) {
  const int offset = sh.sk - sh.sq;
  *p = 0.f;
  *ds = 0.f;
  if (qp >= sh.sq || kp >= sh.sk) return;
  const bool visible =
      kp < sh.kv_len && !(sh.causal && kp > qp + offset);
  if (visible) {
    *p = expf(s * sh.scale - lse);
    *ds = *p * (dp - dd);
  } else if (sh.causal && qp + offset < 0) {
    *p = 1.f / static_cast<float>(sh.sk);
  }
}

// The bf16 arm's P and dS over a warp's 16 x 64 accumulator (8-wide
// fragment n, element i: row g + 8 * (i >> 1), column 8 * n + 2t +
// (i & 1)), with the exponent in base 2: sc2 = scale * log2 e, lse2 =
// lse * log2 e. `qp(n, i)` and `kp(n, i)` give the entry's query row and
// key; `full` says the caller knows every entry is visible and in range,
// which skips the visibility rule of p_ds for the tile.
template <typename Lse, typename Dd, typename Qp, typename Kp>
__device__ __forceinline__ void tile_p_ds(const float (&s)[8][4],
                                          const float (&dp)[8][4], Lse lse2,
                                          Dd dd, Qp qp, Kp kp, bool full,
                                          float sc2, const Shape& sh,
                                          float (&p)[8][4],
                                          float (&ds)[8][4]) {
  if (full) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[n][i] = exp2f(fmaf(s[n][i], sc2, -lse2(n, i)));
        ds[n][i] = p[n][i] * (dp[n][i] - dd(n, i));
      }
    return;
  }
  const int offset = sh.sk - sh.sq;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_ = qp(n, i);
      const int k_ = kp(n, i);
      float pv = 0.f, dv = 0.f;
      if (q_ < sh.sq && k_ < sh.sk) {
        if (k_ < sh.kv_len && !(sh.causal && k_ > q_ + offset)) {
          pv = exp2f(fmaf(s[n][i], sc2, -lse2(n, i)));
          dv = pv * (dp[n][i] - dd(n, i));
        } else if (sh.causal && q_ + offset < 0) {
          pv = 1.f / static_cast<float>(sh.sk);
        }
      }
      p[n][i] = pv;
      ds[n][i] = dv;
    }
}

// Sum over the warp's lanes; every lane gets the same bits (each butterfly
// step adds the same two values, in either order).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// ---------------------------------------------------------------------------
// bf16 arm: tensor cores.

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// kBlock f32 values of a row vector from index row0 (zero past `rows`).
template <bool kAsync>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int row0, int rows, int i) {
  const int row = row0 + i;
  const bool ok = row < rows;
  if constexpr (kAsync) {
    cp_async4(smem_addr(dst + i), ok ? src + row : src, ok ? 4 : 0);
  } else {
    dst[i] = ok ? src[row] : 0.f;
  }
}

// K5's prologue: D' = rowsum(dO * O) - g_lse of the tile's rows, from the
// swizzled dO and O tiles, into d_s and (rows < sq) dcap. Two threads per
// row, each summing every other 16-byte chunk in order, then one exchange
// (both get the same bits); the zero padding past d adds nothing.
template <int DMAX>
__device__ __forceinline__ void row_term(const bf16* g_s, const bf16* o_s,
                                         int q0, long long rows0,
                                         const float* g_lse, float* dcap,
                                         float* d_s, const Shape& sh) {
  static_assert(kMmaThreads == 2 * kBlock, "two threads per D' row");
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  float sum = 0.f;
#pragma unroll
  for (int c = half; c < DMAX / 8; c += 2) {
    const uint4 gv = *reinterpret_cast<const uint4*>(g_s + swz<DMAX>(r, c));
    const uint4 ov = *reinterpret_cast<const uint4*>(o_s + swz<DMAX>(r, c));
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 gf2 = __bfloat1622float2(g2[j]);
      const float2 of2 = __bfloat1622float2(o2[j]);
      sum = fmaf(gf2.x, of2.x, sum);
      sum = fmaf(gf2.y, of2.y, sum);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const int qp = q0 + r;
  if (qp < sh.sq && g_lse != nullptr) sum -= g_lse[rows0 + qp];
  if (half == 0) {
    d_s[r] = sum;
    if (qp < sh.sq) dcap[rows0 + qp] = sum;
  }
}

// ---------------------------------------------------------------------------
// bf16 arm: warpgroup MMA (wgmma). One warpgroup per CTA; B operands read
// from shared memory once per warpgroup.

template <int DMAX>
constexpr size_t dq_wgmma_smem() {
  // Q, dO, two stages of K and V (O passes through K's second stage), the
  // tile's D' rows.
  return sizeof(bf16) * 6 * kBlock * DMAX + sizeof(float) * kBlock;
}

template <int DMAX>
constexpr size_t dkv_wgmma_smem() {
  // K, V, two stages of Q and dO, two stages of lse and D' rows.
  return sizeof(bf16) * 6 * kBlock * DMAX + sizeof(float) * 4 * kBlock;
}

// K5, bf16. Grid: (query tiles, batch * heads). The warpgroup owns 64
// query rows (warp w rows 16w ..), Q and dO resident in shared memory as
// the A operands of S = Q K^T and dP = dO V^T; dQ += dS K takes dS from
// registers and K MN-major, one 64-column panel of dq at a time.
template <int DMAX, bool kAsync>
__global__ void __launch_bounds__(kMmaThreads, DMAX == 64 ? 4 : 1)
    flash_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                   const bf16* __restrict__ o, const float* __restrict__ lse,
                   const float* __restrict__ g_lse, float* __restrict__ dcap,
                   bf16* __restrict__ dq, Layout lq, Layout lk, Layout lv,
                   Layout lg, Layout lo, Layout ldq, Shape sh) {
  constexpr int kTile = kBlock * DMAX;
  constexpr int kPanels = DMAX / 64;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_wg);
  bf16* g_s = q_s + kTile;
  bf16* k_s = g_s + kTile;      // [2][kTile]
  bf16* v_s = k_s + 2 * kTile;  // [2][kTile]
  float* d_s = reinterpret_cast<float*>(v_s + 2 * kTile);  // [kBlock]

  const int lane = threadIdx.x & 31;
  const int wr0 = (threadIdx.x >> 5) * 16;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int bi = bh / sh.heads;
  const int hi = bh % sh.heads;
  const int q0 = blockIdx.x * kBlock;
  const int offset = sh.sk - sh.sq;
  const long long rows0 = static_cast<long long>(bh) * sh.sq;

  const bf16* kb = k + bi * lk.sb + hi * lk.sh;
  const bf16* vb = v + bi * lv.sb + hi * lv.sh;
  // Key tiles any row of this tile sees (rows that see no key add 0).
  int end = sh.kv_len;
  if (sh.causal) end = min(end, min(q0 + kBlock, sh.sq) + offset);
  const int ntiles = end > 0 ? (end + kBlock - 1) / kBlock : 0;

  // Q, dO and O (into K's second stage, free until the walk starts), then
  // the first K/V tile.
  load_tile_bf16<DMAX, kAsync>(q_s, q + bi * lq.sb + hi * lq.sh, lq.ss, q0,
                               sh.sq, sh.d);
  load_tile_bf16<DMAX, kAsync>(g_s, g + bi * lg.sb + hi * lg.sh, lg.ss, q0,
                               sh.sq, sh.d);
  load_tile_bf16<DMAX, kAsync>(k_s + kTile, o + bi * lo.sb + hi * lo.sh,
                               lo.ss, q0, sh.sq, sh.d);
  cp_async_commit();
  if (ntiles > 0) {
    load_tile_bf16<DMAX, kAsync>(k_s, kb, lk.ss, 0, sh.sk, sh.d);
    load_tile_bf16<DMAX, kAsync>(v_s, vb, lv.ss, 0, sh.sk, sh.d);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  row_term<DMAX>(g_s, k_s + kTile, q0, rows0, g_lse, dcap, d_s, sh);
  __syncthreads();
  float dd[2], lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + gq + 8 * h;
    dd[h] = d_s[row];
    lse2[h] = q0 + row < sh.sq ? lse[rows0 + q0 + row] * kLog2e : 0.f;
  }
  const float sc2 = sh.scale * kLog2e;
  // The warp's key tiles before full_end are visible and in range.
  int full_end = 0;
  if (q0 + wr0 + 16 <= sh.sq)
    full_end = sh.causal ? min(sh.kv_len, q0 + wr0 + offset + 1) : sh.kv_len;

  const uint64_t q_d = tile_desc(q_s);
  const uint64_t g_d = tile_desc(g_s);
  float acc[DMAX / 8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int p = 0; p < kPanels; ++p) zero(panel<DMAX>(acc, p));

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {
      const int nxt = (t + 1) * kBlock;
      load_tile_bf16<DMAX, kAsync>(k_s + (st ^ 1) * kTile, kb, lk.ss, nxt,
                                   sh.sk, sh.d);
      load_tile_bf16<DMAX, kAsync>(v_s + (st ^ 1) * kTile, vb, lv.ss, nxt,
                                   sh.sk, sh.d);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const uint64_t k_d = tile_desc(k_s + st * kTile);
    const uint64_t v_d = tile_desc(v_s + st * kTile);
    const int k0 = t * kBlock;
    zero(s);
    zero(dp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4 * kPanels; ++j) {
      const int off = (j >> 2) * kPanelStep + 2 * (j & 3);
      wgmma_ss(s, q_d + off, k_d + off, j);
    }
#pragma unroll
    for (int j = 0; j < 4 * kPanels; ++j) {
      const int off = (j >> 2) * kPanelStep + 2 * (j & 3);
      wgmma_ss(dp, g_d + off, v_d + off, j);
    }
    wgmma_finish();
    fence_acc(s);
    fence_acc(dp);
    float p[8][4], ds[8][4];
    tile_p_ds(
        s, dp, [&](int, int i) { return lse2[i >> 1]; },
        [&](int, int i) { return dd[i >> 1]; },
        [&](int, int i) { return q0 + wr0 + gq + 8 * (i >> 1); },
        [&](int n, int i) { return k0 + 8 * n + 2 * t4 + (i & 1); },
        k0 + kBlock <= full_end, sc2, sh, p, ds);
    uint32_t a[4][4];
    to_a_frags(ds, a);
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs(panel<DMAX>(acc, pn), a[j], k_d + pn * kPanelStep + 128 * j);
    wgmma_finish();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) fence_acc(panel<DMAX>(acc, pn));
    __syncthreads();
  }

  // dq through Q's tile (no wgmma reads it any more), then out in 16-byte
  // rows.
  frags_to_tile<DMAX>(q_s, wr0, acc, sh.scale);
  __syncthreads();
  store_tile_bf16<DMAX>(dq + bi * ldq.sb + hi * ldq.sh, ldq.ss, q_s, q0,
                        sh.sq, sh.d);
}

// K6, bf16. Grid: (key tiles, batch * heads). The warpgroup owns 64 key
// rows (warp w rows 16w ..): S^T = K Q^T and dP^T = V dO^T with K and V
// resident as A operands, then dV += P^T dO and dK += dS^T Q with P^T and
// dS^T from registers and dO and Q MN-major, a 64-column panel at a time.
template <int DMAX, bool kAsync>
__global__ void __launch_bounds__(kMmaThreads, DMAX == 64 ? 3 : 1)
    flash_dkv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ dcap, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                    Layout lg, Layout ldk, Layout ldv, Shape sh) {
  constexpr int kTile = kBlock * DMAX;
  constexpr int kPanels = DMAX / 64;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_wg);
  bf16* v_s = k_s + kTile;
  bf16* q_s = v_s + kTile;      // [2][kTile]
  bf16* g_s = q_s + 2 * kTile;  // [2][kTile]
  float* lse_s = reinterpret_cast<float*>(g_s + 2 * kTile);  // [2][kBlock]
  float* d_s = lse_s + 2 * kBlock;                           // [2][kBlock]

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int bi = bh / sh.heads;
  const int hi = bh % sh.heads;
  const int k0 = blockIdx.x * kBlock;
  const int kw0 = k0 + (threadIdx.x >> 5) * 16;
  const int offset = sh.sk - sh.sq;
  const long long rows0 = static_cast<long long>(bh) * sh.sq;

  // Query tiles that reach this key tile. Rows that see no key (causal,
  // sq > sk) reach every key tile; otherwise the causal diagonal gives the
  // first query row that sees key k0, and a key tile wholly past kv_len is
  // seen by no row.
  const bool blind_rows = sh.causal && offset < 0;
  int begin = 0;
  if (!blind_rows) {
    if (k0 >= sh.kv_len) begin = sh.sq;
    else if (sh.causal) begin = max(0, k0 - offset) / kBlock * kBlock;
  }
  const int ntiles = (sh.sq - begin + kBlock - 1) / kBlock;
  const bool keys_full = kw0 + 16 <= sh.kv_len;
  const float sc2 = sh.scale * kLog2e;

  const bf16* qb = q + bi * lq.sb + hi * lq.sh;
  const bf16* gb = g + bi * lg.sb + hi * lg.sh;
  const float* lse_b = lse + rows0;
  const float* d_b = dcap + rows0;

  load_tile_bf16<DMAX, kAsync>(k_s, k + bi * lk.sb + hi * lk.sh, lk.ss, k0,
                               sh.sk, sh.d);
  load_tile_bf16<DMAX, kAsync>(v_s, v + bi * lv.sb + hi * lv.sh, lv.ss, k0,
                               sh.sk, sh.d);
  cp_async_commit();
  auto load_q_tile = [&](int stage, int qt0) {
    load_tile_bf16<DMAX, kAsync>(q_s + stage * kTile, qb, lq.ss, qt0, sh.sq,
                                 sh.d);
    load_tile_bf16<DMAX, kAsync>(g_s + stage * kTile, gb, lg.ss, qt0, sh.sq,
                                 sh.d);
    for (int i = threadIdx.x; i < 2 * kBlock; i += kMmaThreads) {
      if (i < kBlock)
        load_rows_f32<kAsync>(lse_s + stage * kBlock, lse_b, qt0, sh.sq, i);
      else
        load_rows_f32<kAsync>(d_s + stage * kBlock, d_b, qt0, sh.sq,
                              i - kBlock);
    }
  };
  if (ntiles > 0) load_q_tile(0, begin);
  cp_async_commit();

  const uint64_t k_d = tile_desc(k_s);
  const uint64_t v_d = tile_desc(v_s);
  float acc_k[DMAX / 8][4], acc_v[DMAX / 8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int p = 0; p < kPanels; ++p) {
    zero(panel<DMAX>(acc_k, p));
    zero(panel<DMAX>(acc_v, p));
  }

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    const int q0 = begin + t * kBlock;
    if (t + 1 < ntiles) load_q_tile(st ^ 1, q0 + kBlock);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const uint64_t q_d = tile_desc(q_s + st * kTile);
    const uint64_t g_d = tile_desc(g_s + st * kTile);
    const float* lse_t = lse_s + st * kBlock;
    const float* d_t = d_s + st * kBlock;
    zero(s);
    zero(dp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4 * kPanels; ++j) {
      const int off = (j >> 2) * kPanelStep + 2 * (j & 3);
      wgmma_ss(s, k_d + off, q_d + off, j);
    }
#pragma unroll
    for (int j = 0; j < 4 * kPanels; ++j) {
      const int off = (j >> 2) * kPanelStep + 2 * (j & 3);
      wgmma_ss(dp, v_d + off, g_d + off, j);
    }
    wgmma_finish();
    fence_acc(s);
    fence_acc(dp);
    float p[8][4], ds[8][4];
    const int c0 = 2 * t4;
    tile_p_ds(
        s, dp, [&](int n, int i) { return lse_t[c0 + 8 * n + (i & 1)] * kLog2e; },
        [&](int n, int i) { return d_t[c0 + 8 * n + (i & 1)]; },
        [&](int n, int i) { return q0 + c0 + 8 * n + (i & 1); },
        [&](int, int i) { return kw0 + gq + 8 * (i >> 1); },
        keys_full && q0 + kBlock <= sh.sq &&
            (!sh.causal || kw0 + 15 <= q0 + offset),
        sc2, sh, p, ds);
    uint32_t pa[4][4], da[4][4];
    to_a_frags(p, pa);
    to_a_frags(ds, da);
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs(panel<DMAX>(acc_v, pn), pa[j], g_d + pn * kPanelStep + 128 * j);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs(panel<DMAX>(acc_k, pn), da[j], q_d + pn * kPanelStep + 128 * j);
    }
    wgmma_finish();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      fence_acc(panel<DMAX>(acc_k, pn));
      fence_acc(panel<DMAX>(acc_v, pn));
    }
    __syncthreads();
  }

  // dk and dv through K's and V's tiles (no wgmma reads them any more),
  // then out in 16-byte rows.
  frags_to_tile<DMAX>(k_s, kw0 - k0, acc_k, sh.scale);
  frags_to_tile<DMAX>(v_s, kw0 - k0, acc_v, 1.f);
  __syncthreads();
  store_tile_bf16<DMAX>(dk + bi * ldk.sb + hi * ldk.sh, ldk.ss, k_s, k0,
                        sh.sk, sh.d);
  store_tile_bf16<DMAX>(dv + bi * ldv.sb + hi * ldv.sh, ldv.ss, v_s, k0,
                        sh.sk, sh.d);
}

// ---------------------------------------------------------------------------
// f32 arm: CUDA cores.

template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          const Layout& L, int row0, int rows,
                                          int d) {
  for (int i = threadIdx.x; i < kBlock * DMAX; i += kThreads) {
    const int r = i / DMAX;
    const int e = i % DMAX;
    const int row = row0 + r;
    float x = 0.f;
    if (row < rows && e < d) x = to_f(src[row * L.ss + e]);
    dst[r * ld + e] = x;
  }
}

// S = A B^T and dP = G W^T for the thread's 4x4 block: rows ty + 16*i of
// the row-side tiles (a_s, g_s), rows tx + 16*j of the column-side tiles
// (b_s, w_s).
template <int DMAX>
__device__ __forceinline__ void two_products(const float* a_s,
                                             const float* g_s,
                                             const float* b_s,
                                             const float* w_s, int d, int ty,
                                             int tx, float s[4][4],
                                             float dp[4][4]) {
  constexpr int kLd = DMAX + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < d; ++e) {
    float a[4], g[4], b[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = a_s[(ty + 16 * i) * kLd + e];
      g[i] = g_s[(ty + 16 * i) * kLd + e];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = b_s[(tx + 16 * j) * kLd + e];
      w[j] = w_s[(tx + 16 * j) * kLd + e];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
}

// K5, f32. Grid: (query tiles, batch * heads).
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const T* __restrict__ o,
    const float* __restrict__ lse, const float* __restrict__ g_lse,
    float* __restrict__ dcap, T* __restrict__ dq, Layout lq, Layout lk,
    Layout lv, Layout lg, Layout lo, Layout ldq, Shape sh) {
  constexpr int kLd = DMAX + 1;
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* g_s = q_s + kBlock * kLd;
  float* k_s = g_s + kBlock * kLd;
  float* v_s = k_s + kBlock * kLd;
  float* ds_s = v_s + kBlock * kLd;  // [kBlock, kBlock + 1]
  float* d_s = ds_s + kBlock * (kBlock + 1);  // [kBlock]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int bi = bh / sh.heads;
  const int hi = bh % sh.heads;
  const int q0 = blockIdx.x * kBlock;
  const int offset = sh.sk - sh.sq;
  const long long rows0 = static_cast<long long>(bh) * sh.sq;

  load_tile<T, DMAX>(q_s, kLd, q + bi * lq.sb + hi * lq.sh, lq, q0, sh.sq,
                     sh.d);
  load_tile<T, DMAX>(g_s, kLd, g + bi * lg.sb + hi * lg.sh, lg, q0, sh.sq,
                     sh.d);
  __syncthreads();
  // D' = rowsum(dO * O) - g_lse: each warp sums kBlock / 8 rows, lanes
  // striding the columns, then a butterfly; lane 0 writes it.
  {
    const int lane = tid & 31;
    const T* ob = o + bi * lo.sb + hi * lo.sh;
    for (int r = tid >> 5; r < kBlock; r += kThreads / 32) {
      const int qp = q0 + r;
      float sum = 0.f;
      if (qp < sh.sq) {
        for (int e = lane; e < sh.d; e += 32)
          sum += g_s[r * kLd + e] * to_f(ob[qp * lo.ss + e]);
      }
      sum = warp_sum(sum);
      if (qp < sh.sq && g_lse != nullptr) sum -= g_lse[rows0 + qp];
      if (lane == 0) {
        d_s[r] = sum;
        if (qp < sh.sq) dcap[rows0 + qp] = sum;
      }
    }
  }
  __syncthreads();
  float lse_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    lse_r[i] = qp < sh.sq ? lse[rows0 + qp] : 0.f;
    d_r[i] = d_s[ty + 16 * i];
  }

  // Key tiles any row of this tile sees (rows that see no key add 0).
  int end = sh.kv_len;
  if (sh.causal) end = min(end, min(q0 + kBlock, sh.sq) + offset);
  const T* kb = k + bi * lk.sb + hi * lk.sh;
  const T* vb = v + bi * lv.sb + hi * lv.sh;

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < end; k0 += kBlock) {
    __syncthreads();
    load_tile<T, DMAX>(k_s, kLd, kb, lk, k0, sh.sk, sh.d);
    load_tile<T, DMAX>(v_s, kLd, vb, lv, k0, sh.sk, sh.d);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<DMAX>(q_s, g_s, k_s, v_s, sh.d, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p, ds;
        p_ds(s[i][j], dp[i][j], lse_r[i], d_r[i], q0 + ty + 16 * i,
             k0 + tx + 16 * j, sh, &p, &ds);
        ds_s[(ty + 16 * i) * (kBlock + 1) + tx + 16 * j] = ds;
      }
    __syncthreads();
    const int kn = min(kBlock, sh.sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[4], b[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ds_s[(ty + 16 * i) * (kBlock + 1) + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = k_s[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  T* out = dq + bi * ldq.sb + hi * ldq.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sh.sq) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int e = tx + 16 * j;
      if (e < sh.d) out[qp * ldq.ss + e] = from_f<T>(acc[i][j] * sh.scale);
    }
  }
}

// K6, f32. Grid: (key tiles, batch * heads). The thread's score block is
// (query rows ty + 16*i, keys tx + 16*j); its output block is (keys
// ty + 16*i, columns tx + 16*j).
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ dcap, T* __restrict__ dk, T* __restrict__ dv,
    Layout lq, Layout lk, Layout lv, Layout lg, Layout ldk, Layout ldv,
    Shape sh) {
  constexpr int kLd = DMAX + 1;
  constexpr int kCols = DMAX / 16;
  constexpr int kLp = kBlock + 1;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBlock * kLd;
  float* q_s = v_s + kBlock * kLd;
  float* g_s = q_s + kBlock * kLd;
  float* p_s = g_s + kBlock * kLd;   // [kBlock, kLp], query-major
  float* ds_s = p_s + kBlock * kLp;  // [kBlock, kLp], query-major

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int bi = bh / sh.heads;
  const int hi = bh % sh.heads;
  const int k0 = blockIdx.x * kBlock;
  const int offset = sh.sk - sh.sq;

  load_tile<T, DMAX>(k_s, kLd, k + bi * lk.sb + hi * lk.sh, lk, k0, sh.sk,
                     sh.d);
  load_tile<T, DMAX>(v_s, kLd, v + bi * lv.sb + hi * lv.sh, lv, k0, sh.sk,
                     sh.d);

  // Query tiles that reach this key tile; see flash_dkv_wgmma.
  const bool blind_rows = sh.causal && offset < 0;
  int begin = 0;
  if (!blind_rows) {
    if (k0 >= sh.kv_len) begin = sh.sq;
    else if (sh.causal) begin = max(0, k0 - offset) / kBlock * kBlock;
  }
  const T* qb = q + bi * lq.sb + hi * lq.sh;
  const T* gb = g + bi * lg.sb + hi * lg.sh;
  const long long row0 = static_cast<long long>(bh) * sh.sq;

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int q0 = begin; q0 < sh.sq; q0 += kBlock) {
    __syncthreads();
    load_tile<T, DMAX>(q_s, kLd, qb, lq, q0, sh.sq, sh.d);
    load_tile<T, DMAX>(g_s, kLd, gb, lg, q0, sh.sq, sh.d);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<DMAX>(q_s, g_s, k_s, v_s, sh.d, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      const float lse_i = qp < sh.sq ? lse[row0 + qp] : 0.f;
      const float d_i = qp < sh.sq ? dcap[row0 + qp] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p, ds;
        p_ds(s[i][j], dp[i][j], lse_i, d_i, qp, k0 + tx + 16 * j, sh, &p,
             &ds);
        p_s[(ty + 16 * i) * kLp + tx + 16 * j] = p;
        ds_s[(ty + 16 * i) * kLp + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    const int qn = min(kBlock, sh.sq - q0);
    for (int qq = 0; qq < qn; ++qq) {
      float p[4], ds[4], gq[kCols], qv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = p_s[qq * kLp + ty + 16 * i];
        ds[i] = ds_s[qq * kLp + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        gq[j] = g_s[qq * kLd + tx + 16 * j];
        qv[j] = q_s[qq * kLd + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          acc_v[i][j] = fmaf(p[i], gq[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(ds[i], qv[j], acc_k[i][j]);
        }
    }
  }

  T* dkb = dk + bi * ldk.sb + hi * ldk.sh;
  T* dvb = dv + bi * ldv.sb + hi * ldv.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= sh.sk) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int e = tx + 16 * j;
      if (e >= sh.d) continue;
      dkb[kp * ldk.ss + e] = from_f<T>(acc_k[i][j] * sh.scale);
      dvb[kp * ldv.ss + e] = from_f<T>(acc_v[i][j]);
    }
  }
}

template <int DMAX>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (4 * kBlock * (DMAX + 1) + kBlock * (kBlock + 1) + kBlock);
}

template <int DMAX>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kBlock * (DMAX + 1) + 2 * kBlock * (kBlock + 1));
}

// ---------------------------------------------------------------------------
// Launchers and entry points.

struct DqArgs {
  const void *q, *k, *v, *g, *o, *lse, *g_lse;
  void *dcap, *dq;
};

struct DkvArgs {
  const void *q, *k, *v, *g, *lse, *dcap;
  void *dk, *dv;
};

template <int DMAX, bool kAsync>
int launch_dq_wgmma(const DqArgs& a, const long long* st, int b,
                    const Shape& sh, cudaStream_t stream) {
  static bool ready = false;
  auto kernel = flash_dq_wgmma<DMAX, kAsync>;
  const int err = allow_smem(kernel, dq_wgmma_smem<DMAX>(), &ready);
  if (err) return err;
  const dim3 grid((sh.sq + kBlock - 1) / kBlock, b * sh.heads);
  kernel<<<grid, kMmaThreads, dq_wgmma_smem<DMAX>(), stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
      static_cast<const bf16*>(a.o), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.g_lse), static_cast<float*>(a.dcap),
      static_cast<bf16*>(a.dq), layout(st, 0), layout(st, 1), layout(st, 2),
      layout(st, 3), layout(st, 4), layout(st, 5), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX, bool kAsync>
int launch_dkv_wgmma(const DkvArgs& a, const long long* st, int b,
                     const Shape& sh, cudaStream_t stream) {
  static bool ready = false;
  auto kernel = flash_dkv_wgmma<DMAX, kAsync>;
  const int err = allow_smem(kernel, dkv_wgmma_smem<DMAX>(), &ready);
  if (err) return err;
  const dim3 grid((sh.sk + kBlock - 1) / kBlock, b * sh.heads);
  kernel<<<grid, kMmaThreads, dkv_wgmma_smem<DMAX>(), stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dcap),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), layout(st, 0),
      layout(st, 1), layout(st, 2), layout(st, 3), layout(st, 4),
      layout(st, 5), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_dq_f32(const DqArgs& a, const long long* st, int b,
                  const Shape& sh, cudaStream_t stream) {
  static bool ready = false;
  auto kernel = flash_dq_kernel<float, DMAX>;
  const int err = allow_smem(kernel, dq_smem<DMAX>(), &ready);
  if (err) return err;
  const dim3 grid((sh.sq + kBlock - 1) / kBlock, b * sh.heads);
  kernel<<<grid, kThreads, dq_smem<DMAX>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g),
      static_cast<const float*>(a.o), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.g_lse), static_cast<float*>(a.dcap),
      static_cast<float*>(a.dq), layout(st, 0), layout(st, 1), layout(st, 2),
      layout(st, 3), layout(st, 4), layout(st, 5), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_dkv_f32(const DkvArgs& a, const long long* st, int b,
                   const Shape& sh, cudaStream_t stream) {
  static bool ready = false;
  auto kernel = flash_dkv_kernel<float, DMAX>;
  const int err = allow_smem(kernel, dkv_smem<DMAX>(), &ready);
  if (err) return err;
  const dim3 grid((sh.sk + kBlock - 1) / kBlock, b * sh.heads);
  kernel<<<grid, kThreads, dkv_smem<DMAX>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dcap),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), layout(st, 0),
      layout(st, 1), layout(st, 2), layout(st, 3), layout(st, 4),
      layout(st, 5), sh);
  return static_cast<int>(cudaGetLastError());
}

int dq_bf16(const DqArgs& a, const long long* st, int b, const Shape& sh,
            cudaStream_t stream) {
  const void* ptrs[5] = {a.q, a.k, a.v, a.g, a.o};
  const bool fast = async_ok(ptrs, 5, st, sh.d);
  if (sh.d <= 64)
    return fast ? launch_dq_wgmma<64, true>(a, st, b, sh, stream)
                : launch_dq_wgmma<64, false>(a, st, b, sh, stream);
  return fast ? launch_dq_wgmma<128, true>(a, st, b, sh, stream)
              : launch_dq_wgmma<128, false>(a, st, b, sh, stream);
}

int dkv_bf16(const DkvArgs& a, const long long* st, int b, const Shape& sh,
             cudaStream_t stream) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.g};
  const bool fast = async_ok(ptrs, 4, st, sh.d);
  if (sh.d <= 64)
    return fast ? launch_dkv_wgmma<64, true>(a, st, b, sh, stream)
                : launch_dkv_wgmma<64, false>(a, st, b, sh, stream);
  return fast ? launch_dkv_wgmma<128, true>(a, st, b, sh, stream)
              : launch_dkv_wgmma<128, false>(a, st, b, sh, stream);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 = ok).
// st: int64 element strides (batch, head, row) of each tensor view, in
// argument order: q, k, v, g, o, dq for K5 (18 values); q, k, v, g, dk, dv
// for K6 (18 values). Column strides are 1. lse, g_lse and dcap: [b, h, sq]
// f32, contiguous; g_lse may be null (no lse cotangent). K5 writes dcap
// (D'), which K6 reads: launch K5 first, on the same stream.
int flash_dq_bf16(const void* q, const void* k, const void* v, const void* g,
                  const void* o, const void* lse, const void* g_lse,
                  void* dcap, void* dq, const long long* st, int b, int h,
                  int sq, int sk, int d, int kv_len, int causal, float scale,
                  void* stream) {
  if (bad_shape(d, sq, sk, kv_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{h, sq, sk, d, kv_len, causal, scale};
  return dq_bf16(DqArgs{q, k, v, g, o, lse, g_lse, dcap, dq}, st, b, sh,
                 static_cast<cudaStream_t>(stream));
}

int flash_dq_f32(const void* q, const void* k, const void* v, const void* g,
                 const void* o, const void* lse, const void* g_lse,
                 void* dcap, void* dq, const long long* st, int b, int h,
                 int sq, int sk, int d, int kv_len, int causal, float scale,
                 void* stream) {
  if (bad_shape(d, sq, sk, kv_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{h, sq, sk, d, kv_len, causal, scale};
  const DqArgs a{q, k, v, g, o, lse, g_lse, dcap, dq};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d <= 64 ? launch_dq_f32<64>(a, st, b, sh, s)
                 : launch_dq_f32<128>(a, st, b, sh, s);
}

int flash_dkv_bf16(const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* dcap, void* dk, void* dv,
                   const long long* st, int b, int h, int sq, int sk, int d,
                   int kv_len, int causal, float scale, void* stream) {
  if (bad_shape(d, sq, sk, kv_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{h, sq, sk, d, kv_len, causal, scale};
  return dkv_bf16(DkvArgs{q, k, v, g, lse, dcap, dk, dv}, st, b, sh,
                  static_cast<cudaStream_t>(stream));
}

int flash_dkv_f32(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* dcap, void* dk, void* dv,
                  const long long* st, int b, int h, int sq, int sk, int d,
                  int kv_len, int causal, float scale, void* stream) {
  if (bad_shape(d, sq, sk, kv_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{h, sq, sk, d, kv_len, causal, scale};
  const DkvArgs a{q, k, v, g, lse, dcap, dk, dv};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d <= 64 ? launch_dkv_f32<64>(a, st, b, sh, s)
                 : launch_dkv_f32<128>(a, st, b, sh, s);
}

}  // extern "C"
