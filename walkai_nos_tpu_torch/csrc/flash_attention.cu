// Full-sequence attention forward: K3 (packed ViT attention) and K4 (flash
// forward with logsumexp), one templated body per arm.
//
// Replaces:
// - K3: walkai_nos_tpu/ops/attention.py:_packed_pallas_fwd and its body
//   _packed_kernel (the TPU kernel behind flash_attention_packed): softmax
//   attention read straight off the fused qkv projection [b, s, 3*h*d]
//   (q, k and v of head i at column offsets i*d, h*d + i*d, 2*h*d + i*d),
//   written as [b, s, h*d], the layout the out-projection consumes. No
//   transposing copy goes through device memory.
// - K4: walkai_nos_tpu/ops/attention.py:_flash_pallas_impl and its body
//   _flash_kernel: online-softmax attention over [b, h, s, d] that also
//   writes the f32 per-row logsumexp the backward (K5, K6) rebuilds P from.
//
// Both entry points launch the same kernel on strided views: every tensor
// is addressed as (batch, head, row, column) with its own batch, head and
// row strides and unit column stride, so the packed tensor is read as it
// lies. K3 writes no logsumexp.
//
// Semantics (the JAX kernels', plus the edge the JAX wrapper leaves to its
// reference):
// - scores in f32, times head_dim^-0.5; f32 running max and sum;
// - bottom-right causal mask: query row q sees key k iff k <= q + sk - sq;
//   keys at or past kv_len are masked too; a masked score is -1e30, not
//   -inf, as in the reference; a key column past sk (no key at all) is
//   -inf and weighs exactly 0;
// - key tiles no row of a query tile can see (past the causal diagonal or
//   past kv_len) are skipped, not read;
// - causal with sq > sk leaves rows that see no key. The reference's
//   softmax over equal -1e30 logits gives them the mean of V over all sk
//   keys; a query tile holding such a row therefore scans every key tile,
//   and the online softmax yields exactly that mean (every masked key
//   weighs exp(0) = 1 while the row's max stays -1e30). The running max
//   starts at -1e30, never -inf, so no (-inf) - (-inf) is ever formed.
//
// What bounds it on an H100, at the ViT's shape (b 32, s 296, h 6, d 64,
// bf16, per layer call): K3 reads 21.8 MB and writes 7.3 MB, 8.7 us at
// 3.35 TB/s; its 4.3 GFLOP take 4.4 us of bf16 tensor-core time. So the
// bytes bound it, barely; the scores never leave the chip. At a causal
// LM-training shape (b 2, h 32, s 2048, d 64) the products over the
// visible pairs bound K4 (34.4 GFLOP, 35 us).
//
// The bf16 arm (the one every path of the port runs on the card): both
// products on tensor cores, as warpgroup MMA (wgmma.m64n64k16, bf16 in,
// f32 accumulate; no TMA), with the tiles and wgmma wrappers of
// hopper_mma.cuh (shared with the backward, K5/K6):
// - one CTA per (batch*head, query tile) with one warpgroup of 4 warps per
//   64 query rows, each warp owning 16 rows: one warpgroup (960 CTAs at
//   the ViT's shape) below kTwoWarpgroupRows query rows, two sharing each
//   K/V tile above it (half the K/V bytes per query row through L2, for
//   the long sequences where that pays); causal grids start the query
//   tiles with the most key tiles first, across all heads;
// - each warpgroup's Q tile is loaded once into a swizzled bf16 panel
//   (d 128: two); K and V stream in 64-row tiles through a two-stage ring
//   of 16-byte cp.async.cg copies, loaded a whole iteration ahead, the
//   ragged tail zero-filled through src-size;
// - S = Q K^T reads both operands K-major from shared memory, unscaled
//   (the scale multiplies the f32 scores, as _packed_kernel does);
// - software pipelined: an iteration issues S(t+1) = Q K(t+1)^T and
//   O += P(t) V(t) as two wgmma groups, and runs the online softmax of
//   S(t+1) while the second is on the tensor cores (so K runs one tile
//   ahead of V in the ring); the last iteration is peeled, so every
//   product and wait in the loop is unconditional (ptxas serializes the
//   wgmma of a loop that reads an accumulator under a condition);
// - the online softmax stays in registers: a row of the accumulator lives
//   in the 4 lanes of a quad, so a row max is two shuffles; exp2 with the
//   scale folded into log2 e; the row sums stay per lane until the end;
//   tiles a warp sees in full skip the mask;
// - P never leaves registers: packed to bf16, it is the register A operand
//   of O += P V, whose B operand is the V tile read MN-major (as
//   _packed_kernel and the plain versions, P is rounded to bf16 for that
//   product); O is rescaled only after the product that wrote it is done;
// - O / l is staged through the Q tiles and written with 16-byte stores;
//   lse = m + log(l) is f32 [b, h, sq], the layout K5/K6 read;
// - views whose rows are not 16-byte aligned or whose d * 2 bytes is not a
//   multiple of 16 load element by element into the same tiles (a template
//   switch of the load path).
//
// The f32 arm keeps the CUDA-core body: each of 256 threads computes a 4x4
// block of scores and a 4 x (head_dim/16) block of the output over f32
// tiles in shared memory. Tensor cores would take f32 as TF32, which
// cannot meet the f32 tolerance (1e-4 relative).

#include <math.h>

#include "hopper_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
// A masked score in the bf16 arm's base-2 logit domain.
constexpr float kMasked2 = kNegInf * kLog2e;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16 arm: warpgroup MMA.

template <int DMAX, int kWG>
constexpr size_t fwd_wgmma_smem() {
  return sizeof(bf16) * (kWG + 4) * kBlock * DMAX;  // Q tiles, two K and V stages
}

// Max and sum over the 4 lanes of a quad: one row of an accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Scores of key tile k0 (a warp's 16 x 64 accumulator) to base-2 logits,
// masked where the warp does not see the whole tile (k0 + kBlock >
// full_end), folded into the running max m2 and this lane's share of the
// running sum l of each of the thread's two rows. Leaves the unnormalised
// probabilities in s and the rows' rescale factors in alpha.
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m2)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int full_end, int qrow,
                                             int t4, float sc2,
                                             const Shape& sh) {
  if (k0 + kBlock <= full_end) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] *= sc2;
  } else {
    const int offset = sh.sk - sh.sq;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + 8 * n + 2 * t4 + (i & 1);
        const int qp = qrow + 8 * (i >> 1);
        if (kp >= sh.sk) {
          s[n][i] = -INFINITY;
        } else if (kp >= sh.kv_len || (sh.causal && kp > qp + offset)) {
          s[n][i] = kMasked2;
        } else {
          s[n][i] *= sc2;
        }
      }
  }
  // Every tile holds a key (k0 < sk), visible or masked, so a row's max is
  // at least kMasked2 and stays finite.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    const float m_new = fmaxf(m2[h], quad_max(mx));
    alpha[h] = exp2f(m2[h] - m_new);
    m2[h] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[n][i] = exp2f(s[n][i] - m2[i >> 1]);
      rs[i >> 1] += s[n][i];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
}

// Grid: (query tiles of 64 * kWG rows, batch * heads). kWG warpgroups,
// each owning 64 query rows (warp w of warpgroup g rows 64g + 16w ..) with
// its own resident Q tile, share each streamed K/V tile (kWG = 2 halves the
// K/V bytes each query row pulls through L2). Software pipelined: the
// products of one iteration are S(t+1) = Q K(t+1)^T and O += P(t) V(t),
// issued together; the softmax of S(t+1) runs while O += P(t) V(t) is on
// the tensor cores. So K runs one tile ahead of V: commit group G(j) holds
// K(j+1) and V(j), issued at the end of iteration j - 2 (when the stages
// it overwrites are read), a whole iteration before iteration j reads it.
template <int DMAX, bool kAsync, bool kLse, int kWG>
__global__ void __launch_bounds__(kWG * kMmaThreads, (DMAX == 64 ? 4 : 2) / kWG)
    flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, Layout lq, Layout lk, Layout lv,
                    Layout lo, Shape sh) {
  constexpr int kTile = kBlock * DMAX;
  constexpr int kPanels = DMAX / 64;
  constexpr int kN = kWG * kMmaThreads;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  bf16* q_all = reinterpret_cast<bf16*>(smem_wg);  // [kWG][kTile]
  bf16* k_s = q_all + kWG * kTile;  // [2][kTile], K(j) in stage j & 1
  bf16* v_s = k_s + 2 * kTile;      // [2][kTile], V(j) in stage j & 1

  const int wg = threadIdx.x / kMmaThreads;
  bf16* q_s = q_all + wg * kTile;   // this warpgroup's rows
  const int lane = threadIdx.x & 31;
  const int wr0 = ((threadIdx.x % kMmaThreads) >> 5) * 16;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  // Causal: CTAs start in order of their linear index, so the query tiles
  // that scan the most key tiles, of every head, take the lowest ones.
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int bh = sh.causal ? lin % gridDim.y : blockIdx.y;
  const int qt = sh.causal ? gridDim.x - 1 - lin / gridDim.y : blockIdx.x;
  const int bi = bh / sh.heads;
  const int hi = bh % sh.heads;
  const int c0 = qt * kWG * kBlock;  // the CTA's first query row
  const int q0 = c0 + wg * kBlock;   // the warpgroup's
  const int wq0 = q0 + wr0;
  const int offset = sh.sk - sh.sq;

  // Key range this CTA scans: all keys when it holds a row that sees none
  // (that row takes the mean of V), else up to kv_len and the diagonal.
  int end;
  if (sh.causal && c0 + offset < 0) {
    end = sh.sk;
  } else {
    end = sh.kv_len;
    if (sh.causal) end = min(end, min(c0 + kWG * kBlock, sh.sq) + offset);
  }
  const int ntiles = (end + kBlock - 1) / kBlock;
  // The warp's key tiles before full_end are visible to all its rows.
  int full_end = sh.kv_len;
  if (sh.causal) full_end = min(full_end, wq0 + offset + 1);

  const bf16* kb = k + bi * lk.sb + hi * lk.sh;
  const bf16* vb = v + bi * lv.sb + hi * lv.sh;
  auto load_group = [&](int j) {
    if (j + 1 < ntiles)
      load_tile_bf16<DMAX, kAsync, kN>(k_s + ((j + 1) & 1) * kTile, kb,
                                       lk.ss, (j + 1) * kBlock, sh.sk, sh.d);
    if (j < ntiles)
      load_tile_bf16<DMAX, kAsync, kN>(v_s + (j & 1) * kTile, vb, lv.ss,
                                       j * kBlock, sh.sk, sh.d);
    cp_async_commit();
  };
  for (int g = 0; g < kWG; ++g)
    load_tile_bf16<DMAX, kAsync, kN>(q_all + g * kTile, q + bi * lq.sb + hi * lq.sh,
                                     lq.ss, c0 + g * kBlock, sh.sq, sh.d);
  load_tile_bf16<DMAX, kAsync, kN>(k_s, kb, lk.ss, 0, sh.sk, sh.d);
  cp_async_commit();
  load_group(0);

  const float sc2 = sh.scale * kLog2e;
  const uint64_t q_d = tile_desc(q_s);
  float acc[DMAX / 8][4], s[8][4];
#pragma unroll
  for (int p = 0; p < kPanels; ++p) zero(panel<DMAX>(acc, p));
  // Per row h of the thread (rows wq0 + gq + 8h): running max in base 2
  // and this lane's share of the running sum.
  float m2[2] = {kMasked2, kMasked2};
  float l[2] = {0.f, 0.f};
  float alpha[2];

  // S(0), then its softmax: P(0) as the A operand of the first PV.
  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();
  zero(s);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4 * kPanels; ++j) {
    const int off = (j >> 2) * kPanelStep + 2 * (j & 3);
    wgmma_ss(s, q_d + off, tile_desc(k_s) + off, j);
  }
  wgmma_finish();
  fence_acc(s);
  softmax_tile(s, m2, l, alpha, 0, full_end, wq0 + gq, t4, sc2, sh);
  uint32_t a[4][4];
  to_a_frags(s, a);
  __syncthreads();  // K(0) is read: G(1) may overwrite its stage
  load_group(1);

  // Iterations 0 .. ntiles - 2: S(t + 1) and O += P(t) V(t); the last
  // iteration, O += P(n - 1) V(n - 1) alone, is peeled off below, so every
  // product and wait in the loop is unconditional.
  for (int t = 0; t + 1 < ntiles; ++t) {
    cp_async_wait<1>();  // G(t): K(t + 1) and V(t)
    fence_async_smem();
    __syncthreads();
    const uint64_t k_d = tile_desc(k_s + ((t + 1) & 1) * kTile);
    const uint64_t v_d = tile_desc(v_s + (t & 1) * kTile);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4 * kPanels; ++j) {
      const int off = (j >> 2) * kPanelStep + 2 * (j & 3);
      wgmma_ss(s, q_d + off, k_d + off, j);
    }
    wgmma_commit();
    // A product of its own: the softmax below reads S(t + 1)'s registers
    // while this one runs.
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs(panel<DMAX>(acc, pn), a[j], v_d + pn * kPanelStep + 128 * j);
    wgmma_commit();
    wgmma_wait<1>();  // S(t + 1) is done; O += P(t) V(t) may still run
    fence_acc(s);
    softmax_tile(s, m2, l, alpha, (t + 1) * kBlock, full_end, wq0 + gq, t4,
                 sc2, sh);
    wgmma_wait<0>();
    fence_frags(a);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) fence_acc(panel<DMAX>(acc, pn));
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];
    to_a_frags(s, a);
    __syncthreads();  // K(t + 1) and V(t) are read: their stages are free
    load_group(t + 2);
  }
  {
    const int t = ntiles - 1;
    cp_async_wait<1>();  // G(t): V(t)
    fence_async_smem();
    __syncthreads();
    const uint64_t v_d = tile_desc(v_s + (t & 1) * kTile);
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs(panel<DMAX>(acc, pn), a[j], v_d + pn * kPanelStep + 128 * j);
    wgmma_finish();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) fence_acc(panel<DMAX>(acc, pn));
    __syncthreads();
  }

  // O / l through Q's tile (no wgmma reads it any more), then out in
  // 16-byte rows.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv[h] = 1.f / l[h];
  }
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] *= inv[i >> 1];
  frags_to_tile<DMAX>(q_s, wr0, acc, 1.f);
  __syncthreads();
  for (int g = 0; g < kWG; ++g)
    store_tile_bf16<DMAX, kN>(o + bi * lo.sb + hi * lo.sh, lo.ss,
                              q_all + g * kTile, c0 + g * kBlock, sh.sq, sh.d);
  if (kLse && t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = wq0 + gq + 8 * h;
      // A row that sees no key keeps the max -1e30 exactly, as the
      // reference's logsumexp does.
      const float m = m2[h] == kMasked2 ? kNegInf : m2[h] * kLn2;
      if (qp < sh.sq) lse[static_cast<long long>(bh) * sh.sq + qp] = m + logf(l[h]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 arm: CUDA cores.

// Loads rows [row0, row0 + kBlock) of one (batch, head) view into a
// [kBlock, ld] f32 tile, times `mul`; rows past `rows` and columns past d
// are zero.
template <int DMAX>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          const Layout& L, int row0, int rows,
                                          int d, float mul) {
  for (int i = threadIdx.x; i < kBlock * DMAX; i += kThreads) {
    const int r = i / DMAX;
    const int e = i % DMAX;
    const int row = row0 + r;
    float x = 0.f;
    if (row < rows && e < d) x = src[row * L.ss + e] * mul;
    dst[r * ld + e] = x;
  }
}

// Grid: (query tiles, batch * heads). Thread (ty, tx) = (tid / 16, tid % 16)
// owns query rows ty + 16*i (i < 4), key columns tx + 16*j (j < 4) of each
// score tile and output columns tx + 16*j (j < DMAX/16). The 16 threads of
// one ty are one half-warp, so a row's reductions are four shuffles. q is
// scaled in f32 before the product; P stays f32 in the PV product.
template <int DMAX, bool kLse>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, Layout lq, Layout lk, Layout lv, Layout lo,
    Shape sh) {
  constexpr int kLd = DMAX + 1;
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBlock, kLd], pre-scaled
  float* k_s = q_s + kBlock * kLd;    // [kBlock, kLd]
  float* v_s = k_s + kBlock * kLd;    // [kBlock, kLd]
  float* p_s = v_s + kBlock * kLd;    // [kBlock, kBlock + 1]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int bi = bh / sh.heads;
  const int hi = bh % sh.heads;
  const int q0 = blockIdx.x * kBlock;
  const int offset = sh.sk - sh.sq;

  const float* qb = q + bi * lq.sb + hi * lq.sh;
  const float* kb = k + bi * lk.sb + hi * lk.sh;
  const float* vb = v + bi * lv.sb + hi * lv.sh;
  load_tile<DMAX>(q_s, kLd, qb, lq, q0, sh.sq, sh.d, sh.scale);

  // Key range this tile scans.
  int end;
  if (sh.causal && q0 + offset < 0) {
    end = sh.sk;  // a row that sees no key: mean of V over every key
  } else {
    end = sh.kv_len;
    if (sh.causal) end = min(end, min(q0 + kBlock, sh.sq) + offset);
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < end; k0 += kBlock) {
    __syncthreads();  // previous tile's readers are done
    load_tile<DMAX>(k_s, kLd, kb, lk, k0, sh.sk, sh.d, 1.f);
    load_tile<DMAX>(v_s, kLd, vb, lv, k0, sh.sk, sh.d, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int e = 0; e < sh.d; ++e) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * kLd + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = k_s[(tx + 16 * j) * kLd + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= sh.sk) {
          s[i][j] = -INFINITY;  // not a key at all
        } else if (kp >= sh.kv_len || (sh.causal && kp > qp + offset)) {
          s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        p_s[(ty + 16 * i) * (kBlock + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kn = min(kBlock, sh.sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float p[4], b[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * (kBlock + 1) + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = v_s[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p[i], b[j], acc[i][j]);
    }
  }

  float* ob = o + bi * lo.sb + hi * lo.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sh.sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int e = tx + 16 * j;
      if (e < sh.d) ob[qp * lo.ss + e] = acc[i][j] * inv;
    }
    if (kLse && tx == 0)
      lse[static_cast<long long>(bh) * sh.sq + qp] = m[i] + logf(l[i]);
  }
}

template <int DMAX>
constexpr size_t f32_smem() {
  return sizeof(float) * (3 * kBlock * (DMAX + 1) + kBlock * (kBlock + 1));
}

// ---------------------------------------------------------------------------
// Launchers.

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
};

template <int DMAX, bool kAsync, bool kLse, int kWG>
int launch_wgmma(const Args& a, const long long* st, int b, const Shape& sh,
                 cudaStream_t stream) {
  static bool ready = false;
  auto kernel = flash_fwd_wgmma<DMAX, kAsync, kLse, kWG>;
  constexpr size_t smem = fwd_wgmma_smem<DMAX, kWG>();
  const int err = allow_smem(kernel, smem, &ready);
  if (err) return err;
  const dim3 grid((sh.sq + kWG * kBlock - 1) / (kWG * kBlock), b * sh.heads);
  kernel<<<grid, kWG * kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o),
      static_cast<float*>(a.lse), layout(st, 0), layout(st, 1),
      layout(st, 2), layout(st, 3), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX, bool kLse>
int launch_f32(const Args& a, const long long* st, int b, const Shape& sh,
               cudaStream_t stream) {
  static bool ready = false;
  auto kernel = flash_fwd_kernel<DMAX, kLse>;
  const int err = allow_smem(kernel, f32_smem<DMAX>(), &ready);
  if (err) return err;
  const dim3 grid((sh.sq + kBlock - 1) / kBlock, b * sh.heads);
  kernel<<<grid, kThreads, f32_smem<DMAX>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), layout(st, 0), layout(st, 1),
      layout(st, 2), layout(st, 3), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX, bool kLse, int kWG>
int launch_bf16_wg(const Args& a, const long long* st, int b, const Shape& sh,
                   cudaStream_t stream) {
  const void* ptrs[3] = {a.q, a.k, a.v};
  return async_ok(ptrs, 3, st, sh.d)
             ? launch_wgmma<DMAX, true, kLse, kWG>(a, st, b, sh, stream)
             : launch_wgmma<DMAX, false, kLse, kWG>(a, st, b, sh, stream);
}

// Two warpgroups (128 query rows a CTA) halve the K/V bytes each query row
// pulls through L2, which pays where sequences are long; short ones lose
// more to the 128-row padding and the halved CTA count (PERF.md §6).
constexpr int kTwoWarpgroupRows = 512;

template <bool kLse>
int launch_bf16(const Args& a, const long long* st, int b, const Shape& sh,
                cudaStream_t stream) {
  const bool two = sh.sq >= kTwoWarpgroupRows;
  if (sh.d <= 64)
    return two ? launch_bf16_wg<64, kLse, 2>(a, st, b, sh, stream)
               : launch_bf16_wg<64, kLse, 1>(a, st, b, sh, stream);
  return two ? launch_bf16_wg<128, kLse, 2>(a, st, b, sh, stream)
             : launch_bf16_wg<128, kLse, 1>(a, st, b, sh, stream);
}

template <bool kLse>
int launch_f32_any(const Args& a, const long long* st, int b, const Shape& sh,
                   cudaStream_t stream) {
  return sh.d <= 64 ? launch_f32<64, kLse>(a, st, b, sh, stream)
                    : launch_f32<128, kLse>(a, st, b, sh, stream);
}

}  // namespace

extern "C" {

int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, const long long* strides, int b, int h, int sq,
                   int sk, int d, int kv_len, int causal, float scale,
                   void* stream) {
  if (bad_shape(d, sq, sk, kv_len))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<true>(Args{q, k, v, o, lse}, strides, b,
                           Shape{h, sq, sk, d, kv_len, causal, scale},
                           static_cast<cudaStream_t>(stream));
}

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, const long long* strides, int b, int h, int sq,
                  int sk, int d, int kv_len, int causal, float scale,
                  void* stream) {
  if (bad_shape(d, sq, sk, kv_len))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32_any<true>(Args{q, k, v, o, lse}, strides, b,
                              Shape{h, sq, sk, d, kv_len, causal, scale},
                              static_cast<cudaStream_t>(stream));
}

int packed_attention_bf16(const void* q, const void* k, const void* v,
                          void* o, const long long* strides, int b, int h,
                          int s, int d, float scale, void* stream) {
  if (bad_shape(d, s, s, s)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<false>(Args{q, k, v, o, nullptr}, strides, b,
                            Shape{h, s, s, d, s, 0, scale},
                            static_cast<cudaStream_t>(stream));
}

int packed_attention_f32(const void* q, const void* k, const void* v, void* o,
                         const long long* strides, int b, int h, int s, int d,
                         float scale, void* stream) {
  if (bad_shape(d, s, s, s)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32_any<false>(Args{q, k, v, o, nullptr}, strides, b,
                               Shape{h, s, s, d, s, 0, scale},
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
