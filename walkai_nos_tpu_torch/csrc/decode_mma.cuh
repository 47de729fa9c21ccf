// The decode-attention kernels on Hopper, shared by K7 (decode_attention.cu,
// a dense per-sequence cache) and K1 (paged_attention.cu, 128-row pool
// blocks read through a block table, with int8 pools and fresh-row
// injection): one CTA body for both, parametrised by where a cell's keys
// live (kPaged).
//
// A cell is one (batch row, kv head, chunk of query rows); its query rows
// (row order (group, step)) attend over key positions 0 .. S - 1, row of
// step t seeing positions <= index + t. Work is cut into tiles of keys.
// The grid is (batch, kv heads * chunks, nsplit); nsplit comes from the
// shapes and the card alone, and split z takes tiles
// [z * nvis / nsplit, (z + 1) * nvis / nsplit) of its own row's nvis
// visible tiles, computed on the device from the index. So no CTA idles
// at a half-full cache, and a row's result depends on its own inputs and
// index only.
//
// Numerics follow _stream_fold (walkai_nos_tpu/ops/decode_attention.py):
// f32 scores with the softmax scale (and a K scale) applied to the f32
// score, masked scores -1e30, f32 running max / sum / accumulator, the V
// scale folded into p, and p (or p * vs) rounded to q's type before the
// PV product; the running sum takes p unscaled and unrounded.
//
// Two bodies:
// - decode_mma_kernel (bf16 q, bf16 or int8 pool): 4 warps, products on
//   tensor cores as mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
//   operands from shared memory through ldmatrix. The query rows are
//   padded to 16-row m-tiles; a warp owns one m-tile (Q fragments in
//   registers up to head_dim 128) and a share of each tile's keys, in
//   16-key sub-chunks: S = Q K^T, the online softmax in registers, P packed
//   to bf16 as the A operand of O += P V (V through ldmatrix.trans). Each
//   warp keeps its own (m, l, O); the warps merge once, at the end, in
//   shared memory in warp order. K/V tiles of 64 keys arrive through a
//   ring of cp.async stages (three, four for int8 tiles), tiles j + 1 ..
//   in flight while tile j computes; the ring's wait is the only barrier
//   of the loop. The Q rows are copied first, before the index is read.
//   Tile rows are not padded: their 16-byte chunks are XOR-swizzled by
//   row, so ldmatrix reads without bank conflicts and four CTAs fit an SM
//   (rows padded by 16 bytes allowed three). An
//   int8 tile lands as int8 and each warp widens its own 16-key sub-chunk
//   to bf16 in a per-warp buffer (lossless: |k| <= 127).
// - decode_fma_kernel (f32 q): the CUDA-core body (tensor cores would take
//   f32 as TF32, which cannot meet the f32 tolerance), on the same split
//   and a two-stage cp.async ring, one phase per tile for scores, softmax
//   and PV.
// The splits combine in split order, with no atomics in a sum, so two
// calls give the same bits. In the bf16 arms a cell of at most 512 outputs
// (the decode step: 8 query rows of 64) is combined by its last CTA to
// finish, chosen by a per-cell ticket that the CTA resets: 5-8% faster
// than a second kernel there on an H100. Larger cells (a multi-step
// verify) and the f32 arms take a second kernel, whose CTAs share the
// rows: one CTA combining a verify's 40 rows made the call 1.3-1.5x as
// long.

#pragma once

#include <math.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr int kDecThreads = 128;  // 4 warps a CTA
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kKeys = 64;         // keys per tile of the bf16 arms
constexpr int kPageRows = 128;    // rows per pool block (PAGE_ROWS)
constexpr int kMaxSplits = 64;
constexpr int kMaxMmaRows = 64;   // query rows a bf16 CTA holds
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a CTA may have

__host__ __device__ constexpr size_t r16(size_t x) { return (x + 15) & ~size_t(15); }
__host__ __device__ constexpr size_t smax(size_t a, size_t b) { return a > b ? a : b; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Element offset of element d of row r in a bf16 tile of DMAX-element rows
// whose 16-byte chunks are XOR-swizzled by r & 7: ldmatrix's eight row
// addresses of one chunk column then fall in distinct banks, with no
// padding.
template <int DMAX>
__host__ __device__ __forceinline__ int dswz(int r, int d) {
  return r * DMAX + ((((d >> 3) ^ r) & 7) | ((d >> 3) & ~7)) * 8 + (d & 7);
}

struct DecodeArgs {
  const void* q;           // [b, h, steps, hd], T
  const void* k;           // K7: [b, kvh, S, hd] T; K1: [nb, kvh, 128, hd] P
  const void* v;
  const int32_t* index;    // [b] (per_row) or [1]
  const int32_t* table;    // K1: [b, nlog]; K7: null
  const void* k_new;       // K1: [b, kvh, steps, hd] T fresh rows, or null
  const void* v_new;
  const float* k_scales;   // K1: [nb, kvh, 128] f32, or null
  const float* v_scales;
  float* m_part;           // [b, kvh, nsplit, rows]
  float* l_part;           // [b, kvh, nsplit, rows]
  float* acc_part;         // [b, kvh, nsplit, rows, hd]
  void* out;               // [b, h, steps, hd], T
  int* tickets;            // bf16 arms: [b, kvh, nchunk] zeros, or null
  int b, h, kvh, steps, hd;
  int S;                   // key positions of a cell: K7 the cache length,
                           // K1 nlog * 128
  int nlog;                // K1's table width
  int per_row;
  int chunk;               // query rows per CTA
  float scale;
};

// Where this CTA's work lies.
struct Cell {
  int b, kh, nchunk, r0, rows, rows_all, g, split, nsplit, t0, t1;
  long long idx;
};

__device__ __forceinline__ Cell cell_of(const DecodeArgs& a, int keys) {
  Cell c;
  c.nchunk = gridDim.y / a.kvh;
  c.b = blockIdx.x;
  c.kh = blockIdx.y / c.nchunk;
  c.g = a.h / a.kvh;
  c.rows_all = c.g * a.steps;
  c.r0 = (blockIdx.y % c.nchunk) * a.chunk;
  c.rows = min(a.chunk, c.rows_all - c.r0);
  c.split = blockIdx.z;
  c.nsplit = gridDim.z;
  c.idx = a.index[a.per_row ? c.b : 0];
  const long long top = c.idx + a.steps - 1;  // highest query position
  const long long ntiles = (a.S + keys - 1) / keys;
  long long nvis = top / keys + 1;
  if (nvis > ntiles) nvis = ntiles;
  c.t0 = static_cast<int>(nvis * c.split / c.nsplit);
  c.t1 = static_cast<int>(nvis * (c.split + 1) / c.nsplit);
  return c;
}

// The pool blocks of tiles [t0, t1) (K1): first block and count.
__device__ __forceinline__ int first_block(const Cell& c, int keys) {
  return c.t0 * keys / kPageRows;
}
__device__ __forceinline__ int block_count(const Cell& c, int keys) {
  return c.t1 > c.t0 ? (c.t1 * keys - 1) / kPageRows + 1 - first_block(c, keys)
                     : 0;
}

// Element offset of key position pos in this cell's K (or V) rows; for K1
// also the offset of its scale (*soff).
template <bool kPaged>
__device__ __forceinline__ size_t row_off(const DecodeArgs& a, const Cell& c,
                                          const int* tbl_s, int blk0, int pos,
                                          size_t* soff) {
  if constexpr (kPaged) {
    const size_t base =
        (static_cast<size_t>(tbl_s[pos / kPageRows - blk0]) * a.kvh + c.kh) *
            kPageRows + (pos % kPageRows);
    *soff = base;
    return base * a.hd;
  } else {
    *soff = 0;
    return ((static_cast<size_t>(c.b) * a.kvh + c.kh) * a.S + pos) * a.hd;
  }
}

// Issues the copies of tile j (KT keys, KT dividing 128, so a tile lies in
// one pool block) into one ring stage: K rows, V rows (row stride RS
// elements of P) and, for a scaled pool, the tile's K and V scale columns.
// kSwz: a bf16 tile of kSwz-element rows, chunks swizzled (dswz).
// kVec: 16-byte cp.async of the cpr chunks of a row that lie below hd
// (hd * sizeof(P) a multiple of 16, rows 16-byte aligned), positions past
// S zero-filled; else element by element, synchronously, columns hd ..
// ncols - 1 written as zeros. A pool in q's type takes the step's fresh
// rows (k_new / v_new) at positions index .. index + steps - 1 straight
// from them; an int8 pool's fresh rows are put in place by the compute.
template <typename T, typename P, bool kPaged, bool kVec, int kSwz>
__device__ __forceinline__ void issue_tile(const DecodeArgs& a, const Cell& c,
                                           const int* tbl_s, int blk0, int j,
                                           int KT, int RS, int cpr, int ncols,
                                           P* stK, P* stV, float* scK,
                                           float* scV) {
  const int pos0 = j * KT;
  size_t soff;
  const size_t tbase = row_off<kPaged>(a, c, tbl_s, blk0, pos0, &soff);
  const P* kb = static_cast<const P*>(a.k) + tbase;
  const P* vb = static_cast<const P*>(a.v) + tbase;
  if constexpr (kVec) {
    constexpr int kEpc = 16 / sizeof(P);
    const bool inject = std::is_same<P, T>::value && a.k_new != nullptr;
    const long long t_lo = c.idx - pos0;  // tile row of the first fresh row
    for (int i = threadIdx.x; i < KT * cpr; i += kDecThreads) {
      const int r = i / cpr;
      const int ch = i - r * cpr;
      if (ch * kEpc >= a.hd) continue;
      const bool ok = pos0 + r < a.S;
      const P* sk = kb + static_cast<size_t>(r) * a.hd + ch * kEpc;
      const P* sv = vb + static_cast<size_t>(r) * a.hd + ch * kEpc;
      if (inject && r - t_lo >= 0 && r - t_lo < a.steps) {
        const size_t o =
            ((static_cast<size_t>(c.b) * a.kvh + c.kh) * a.steps + (r - t_lo)) *
                a.hd + ch * kEpc;
        sk = static_cast<const P*>(a.k_new) + o;
        sv = static_cast<const P*>(a.v_new) + o;
      }
      const int o = kSwz ? dswz<kSwz>(r, ch * kEpc) : r * RS + ch * kEpc;
      cp_async16(smem_addr(stK + o), ok ? sk : kb, ok ? 16 : 0);
      cp_async16(smem_addr(stV + o), ok ? sv : vb, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < KT * ncols; i += kDecThreads) {
      const int r = i / ncols;
      const int d = i - r * ncols;
      P kx = static_cast<P>(0.f), vx = kx;
      if (pos0 + r < a.S && d < a.hd) {
        kx = kb[static_cast<size_t>(r) * a.hd + d];
        vx = vb[static_cast<size_t>(r) * a.hd + d];
      }
      const int o = kSwz ? dswz<kSwz>(r, d) : r * RS + d;
      stK[o] = kx;
      stV[o] = vx;
    }
  }
  if constexpr (kPaged) {
    if (a.k_scales != nullptr) {
      const int n4 = KT / 4;
      for (int i = threadIdx.x; i < 2 * n4; i += kDecThreads) {
        const int which = i / n4;
        const int r = (i - which * n4) * 4;
        cp_async16(smem_addr((which ? scV : scK) + r),
                   (which ? a.v_scales : a.k_scales) + soff + r, 16);
      }
    }
  }
}

// Loads the table entries of this CTA's tiles (K1).
template <bool kPaged>
__device__ __forceinline__ void load_table(const DecodeArgs& a, const Cell& c,
                                           int keys, int* tbl_s) {
  if constexpr (kPaged) {
    const int blk0 = first_block(c, keys);
    const int n = block_count(c, keys);
    const int32_t* trow = a.table + static_cast<size_t>(c.b) * a.nlog;
    for (int i = threadIdx.x; i < n; i += kDecThreads) tbl_s[i] = trow[blk0 + i];
  }
}

// Row r (of the chunk) of this split's partials.
__device__ __forceinline__ size_t part_row(const DecodeArgs& a, const Cell& c,
                                           int r) {
  return ((static_cast<size_t>(c.b) * a.kvh + c.kh) * c.nsplit + c.split) *
             c.rows_all + c.r0 + r;
}

// Combines the splits of rows r0 .. r0 + rows - 1 of cell (batch row b,
// kv head kh) in split order, with all of the CTA's threads: the (m, l) of
// each (row, split) into shared memory, then each row's weights, then the
// outputs, four columns a thread where hd allows, every split's
// accumulator loaded at once. A split that saw no visible position for a
// row (m = -1e30, l = 0, accumulator 0) weighs exactly 0. Partials are
// read from L2 (__ldcg): other SMs wrote them. w_s: rows * (2 * nsplit +
// 1) floats.
template <typename T>
__device__ __forceinline__ void combine(const DecodeArgs& a, int b, int kh, int r0,
                                        int rows, int nsplit, float* w_s) {
  const int g = a.h / a.kvh;
  const int rows_all = g * a.steps;
  const size_t cell0 = (static_cast<size_t>(b) * a.kvh + kh) * nsplit;
  float* l_s = w_s + rows * nsplit;
  float* lsum = l_s + rows * nsplit;
  for (int i = threadIdx.x; i < rows * nsplit; i += kDecThreads) {
    const int r = i / nsplit;
    const size_t p = (cell0 + (i - r * nsplit)) * rows_all + r0 + r;
    w_s[i] = __ldcg(a.m_part + p);
    l_s[i] = __ldcg(a.l_part + p);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kDecThreads) {
    float* w = w_s + r * nsplit;
    float m = kNegInf;
    for (int s = 0; s < nsplit; ++s) m = fmaxf(m, w[s]);
    float l = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      w[s] = w[s] <= kNegInf ? 0.f : expf(w[s] - m);
      l += l_s[r * nsplit + s] * w[s];
    }
    lsum[r] = l;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) +
           ((static_cast<size_t>(b) * a.h + static_cast<size_t>(kh) * g) * a.steps +
            r0) * a.hd;
  const size_t step = static_cast<size_t>(rows_all) * a.hd;  // split to split
  const float* base = a.acc_part + (cell0 * rows_all + r0) * a.hd;
  if (a.hd % 4 == 0) {
    const int per_row = a.hd / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += kDecThreads) {
      const int r = i / per_row;
      const int d = (i - r * per_row) * 4;
      const float* w = w_s + r * nsplit;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int s = 0; s < nsplit; ++s) {
        const float4 x =
            __ldcg(reinterpret_cast<const float4*>(base + s * step + r * a.hd + d));
        acc.x += x.x * w[s];
        acc.y += x.y * w[s];
        acc.z += x.z * w[s];
        acc.w += x.w * w[s];
      }
      T* o = out + r * a.hd + d;
      o[0] = from_f<T>(acc.x / lsum[r]);
      o[1] = from_f<T>(acc.y / lsum[r]);
      o[2] = from_f<T>(acc.z / lsum[r]);
      o[3] = from_f<T>(acc.w / lsum[r]);
    }
  } else {
    for (int i = threadIdx.x; i < rows * a.hd; i += kDecThreads) {
      const int r = i / a.hd;
      const int d = i - r * a.hd;
      const float* w = w_s + r * nsplit;
      float acc = 0.f;
#pragma unroll 8
      for (int s = 0; s < nsplit; ++s) acc += __ldcg(base + s * step + r * a.hd + d) * w[s];
      out[r * a.hd + d] = from_f<T>(acc / lsum[r]);
    }
  }
}

// Rows a combine CTA takes: about 512 outputs.
__host__ __device__ inline int combine_rows(int hd) {
  return min(64, max(1, 4 * kDecThreads / hd));
}

// The second kernel: grid (b, kv heads * chunks, row groups of
// combine_rows(hd) rows).
template <typename T>
__global__ void __launch_bounds__(kDecThreads) decode_combine_kernel(
    const DecodeArgs a, int nsplit) {
  extern __shared__ float w_s[];
  const int nchunk = gridDim.y / a.kvh;
  const int R = combine_rows(a.hd);
  const int cr0 = (blockIdx.y % nchunk) * a.chunk;
  const int rows = min(R, min(a.chunk, (a.h / a.kvh) * a.steps - cr0) -
                              static_cast<int>(blockIdx.z) * R);
  if (rows > 0)
    combine<T>(a, blockIdx.x, blockIdx.y / nchunk, cr0 + blockIdx.z * R, rows, nsplit,
               w_s);
}

// With tickets, after this CTA's partials are written: the cell's last CTA
// to arrive combines all its splits (in split order) and resets the
// ticket, which only decides who combines.
template <typename T>
__device__ __forceinline__ void finish_cell(const DecodeArgs& a, const Cell& c,
                                            float* w_s) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (static_cast<size_t>(c.b) * a.kvh + c.kh) * c.nchunk +
                blockIdx.y % c.nchunk;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == c.nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  combine<T>(a, c.b, c.kh, c.r0, c.rows, c.nsplit, w_s);
  if (threadIdx.x == 0) *ticket = 0;
}

// ---------------------------------------------------------------------------
// Tensor-core pieces of the bf16 arms.

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32 C fragment) += a (16 x 16 bf16 A fragment) b (16 x 8 bf16).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stages of the bf16 arms' ring: bf16 tiles of 64 x DMAX, chunks swizzled
// (dswz), or int8 tiles of 64 x DMAX.
template <typename P> struct MmaRing { static constexpr int kStages = 3; };
template <> struct MmaRing<int8_t> { static constexpr int kStages = 4; };

template <typename P, int DMAX>
__host__ __device__ constexpr int mma_rs() {
  return DMAX;
}

template <typename P, int DMAX, bool kPaged>
__host__ __device__ constexpr size_t mma_stage_bytes() {
  return 2 * kKeys * mma_rs<P, DMAX>() * sizeof(P) + (kPaged ? 2 * kKeys * 4 : 0);
}

// Shared memory of a bf16-arm CTA: the ring (later the warps' merge), the
// Q tile, the per-warp int8 widening buffers, the table entries.
struct MmaLayout {
  size_t q, widen, table, total;
};

template <typename P, int DMAX, bool kPaged>
__host__ __device__ MmaLayout mma_layout(int chunk, int nlog) {
  constexpr int kLds = DMAX + 8;
  const size_t ring = MmaRing<P>::kStages * mma_stage_bytes<P, DMAX, kPaged>();
  const size_t merge = kDecWarps * 16 * (DMAX + 2) * 4;
  MmaLayout L;
  L.q = r16(smax(ring, merge));
  L.widen = L.q + r16(static_cast<size_t>(16) * ((chunk + 15) / 16) * kLds * 2);
  L.table = L.widen +
            (std::is_same<P, int8_t>::value ? kDecWarps * 2 * 16 * DMAX * 2 : 0);
  L.total = L.table + (kPaged ? r16(static_cast<size_t>(nlog) * 4) : 0);
  return L;
}

// One warp's fold of 16 keys (rows kr / vr of a swizzled bf16 tile)
// into its 16 query rows' (m, l, o). qa: the Q fragments (kQReg), else read
// from shared memory at q_addr. pos0: the keys' first position; lim[i]: the
// last position query row g + 8i sees; ksc / vsc: the tile's scale columns
// at these keys (null for an unscaled pool); positions fresh_lo ..
// fresh_hi - 1 take scale 1.
template <int DMAX, bool kQReg>
__device__ __forceinline__ void fold16(
    const bf16* kr, const bf16* vr, const uint32_t (&qa)[kQReg ? DMAX / 16 : 1][4],
    uint32_t q_addr, float (&o)[DMAX / 8][4], float (&m)[2], float (&l)[2],
    int pos0, const long long (&lim)[2], int slim, const float* ksc,
    const float* vsc, long long fresh_lo, long long fresh_hi, float scale) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int x7 = lane & 7;  // the row's swizzle (rows start at multiples of 8)
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const uint32_t kaddr = smem_addr(kr + (x7 + ((lane >> 4) << 3)) * DMAX);
  const int khi = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, kaddr + ((((2 * kk + khi) ^ x7) & 7) | ((2 * kk) & ~7)) * 16);
    if constexpr (kQReg) {
      mma16816(s[0], qa[kk], b[0], b[1]);
      mma16816(s[1], qa[kk], b[2], b[3]);
    } else {
      uint32_t aq[4];
      ldsm_x4(aq, q_addr + kk * 32);
      mma16816(s[0], aq, b[0], b[1]);
      mma16816(s[1], aq, b[2], b[3]);
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = n * 8 + 2 * t + (i & 1);
      const int pos = pos0 + col;
      float x = s[n][i] * scale;
      if (ksc != nullptr) x *= (pos >= fresh_lo && pos < fresh_hi) ? 1.f : ksc[col];
      if (pos > lim[i >> 1] || pos >= slim) x = kNegInf;
      s[n][i] = x;
      mx[i >> 1] = fmaxf(mx[i >> 1], x);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = expf(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // A masked score contributes exactly 0, also while every position
      // this warp has seen is masked for the row.
      const float p = s[n][i] <= kNegInf ? 0.f : expf(s[n][i] - m[i >> 1]);
      sum[i >> 1] += p;
      float pv = p;
      if (vsc != nullptr) {
        const int col = n * 8 + 2 * t + (i & 1);
        const int pos = pos0 + col;
        pv = p * ((pos >= fresh_lo && pos < fresh_hi) ? 1.f : vsc[col]);
      }
      s[n][i] = pv;
    }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
  // P (rounded to bf16) as the A operand: keys 0-7 are n-tile 0, 8-15 n-tile 1.
  const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                          pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
  const uint32_t vaddr = smem_addr(vr + (x7 + ((lane >> 3) & 1) * 8) * DMAX);
  const int vhi = lane >> 4;
#pragma unroll
  for (int dn = 0; dn < DMAX / 16; ++dn) {
    uint32_t b[4];
    ldsm_x4_t(b, vaddr + ((((2 * dn + vhi) ^ x7) & 7) | ((2 * dn) & ~7)) * 16);
    mma16816(o[2 * dn], pa, b[0], b[1]);
    mma16816(o[2 * dn + 1], pa, b[2], b[3]);
  }
}

// One warp widens 16 keys of an int8 stage (rows of DMAX bytes) to swizzled
// bf16 tiles wk / wv, taking fresh rows from k_new / v_new.
template <int DMAX>
__device__ __forceinline__ void widen16(const DecodeArgs& a, const Cell& c,
                                        const int8_t* sk, const int8_t* sv,
                                        bf16* wk, bf16* wv, int pos0,
                                        bool inject) {
  constexpr int kCpr = DMAX / 16;  // 16-byte int8 chunks a row
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the previous sub-chunk's ldmatrix reads are done
  for (int i = lane; i < 2 * 16 * kCpr; i += 32) {
    const int which = i / (16 * kCpr);
    const int rem = i - which * 16 * kCpr;
    const int r = rem / kCpr;
    const int ch = rem - r * kCpr;
    bf16* w = which ? wv : wk;
    uint4* dst0 = reinterpret_cast<uint4*>(w + dswz<DMAX>(r, ch * 16));
    uint4* dst1 = reinterpret_cast<uint4*>(w + dswz<DMAX>(r, ch * 16 + 8));
    if (ch * 16 >= a.hd) {
      *dst0 = *dst1 = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const long long t = pos0 + r - c.idx;
    if (inject && t >= 0 && t < a.steps) {
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(which ? a.v_new : a.k_new) +
          ((static_cast<size_t>(c.b) * a.kvh + c.kh) * a.steps + t) * a.hd +
          ch * 16);
      *dst0 = src[0];
      *dst1 = src[1];
    } else {
      const int4 raw = *reinterpret_cast<const int4*>((which ? sv : sk) +
                                                      r * DMAX + ch * 16);
      const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
      uint32_t u[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        u[e] = pack_bf16(static_cast<float>(x[2 * e]), static_cast<float>(x[2 * e + 1]));
      *dst0 = make_uint4(u[0], u[1], u[2], u[3]);
      *dst1 = make_uint4(u[4], u[5], u[6], u[7]);
    }
  }
  __syncwarp();
}

// The bf16 arms (q bf16; pool bf16, or int8 with scales).
template <typename P, int DMAX, bool kPaged, bool kVec>
__global__ void __launch_bounds__(kDecThreads) decode_mma_kernel(const DecodeArgs a) {
  constexpr bool kI8 = std::is_same<P, int8_t>::value;
  constexpr int kLds = DMAX + 8;
  constexpr int kRs = mma_rs<P, DMAX>();
  constexpr int kNst = MmaRing<P>::kStages;
  constexpr bool kQReg = DMAX <= 128;
  constexpr size_t kStage = mma_stage_bytes<P, DMAX, kPaged>();
  extern __shared__ __align__(16) unsigned char smem[];

  const Cell c = cell_of(a, kKeys);
  const MmaLayout L = mma_layout<P, DMAX, kPaged>(a.chunk, a.nlog);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L.q);
  int* tbl_s = reinterpret_cast<int*>(smem + L.table);
  const int blk0 = kPaged ? first_block(c, kKeys) : 0;
  const int M = (c.rows + 15) / 16;
  const int mp = M <= 1 ? 1 : M <= 2 ? 2 : 4;
  const int nkg = kDecWarps / mp;  // warps sharing one m-tile's keys
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mt = warp / nkg;
  const int kg = warp % nkg;
  const bool active = mt < M;

  // Q rows of the chunk first (they do not wait for the index), zero past
  // the rows and past hd: 16-byte cp.async where q allows it, its own
  // commit group ahead of the tiles'.
  const bf16* qg = static_cast<const bf16*>(a.q) +
                   ((static_cast<size_t>(c.b) * a.h + static_cast<size_t>(c.kh) * c.g) *
                        a.steps + c.r0) * a.hd;
  if (a.hd % 8 == 0 && (reinterpret_cast<uintptr_t>(a.q) & 15) == 0) {
    for (int i = threadIdx.x; i < 16 * M * (DMAX / 8); i += kDecThreads) {
      const int r = i / (DMAX / 8);
      const int ch = i - r * (DMAX / 8);
      const bool ok = r < c.rows && ch * 8 < a.hd;
      cp_async16(smem_addr(q_s + r * kLds + ch * 8), ok ? qg + r * a.hd + ch * 8 : qg,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < 16 * M * DMAX; e += kDecThreads) {
      const int r = e / DMAX;
      const int d = e - r * DMAX;
      q_s[r * kLds + d] =
          (r < c.rows && d < a.hd) ? qg[r * a.hd + d] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
  if constexpr (!kI8 && kVec) {
    // Columns hd .. DMAX - 1 of every stage row stay zero (cp.async never
    // writes them).
    const int c0 = a.hd / 8;
    const int nc = DMAX / 8 - c0;
    if (nc > 0)
      for (int i = threadIdx.x; i < kNst * 2 * kKeys * nc; i += kDecThreads) {
        const int st = i / (2 * kKeys * nc);
        const int rem = i - st * 2 * kKeys * nc;
        *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(smem + st * kStage) +
                                  dswz<DMAX>(rem / nc, (c0 + rem % nc) * 8)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
  }

  auto stage_k = [&](int st) { return reinterpret_cast<P*>(smem + st * kStage); };
  auto stage_sc = [&](int st) {
    return reinterpret_cast<float*>(smem + st * kStage + 2 * kKeys * kRs * sizeof(P));
  };
  auto issue = [&](int j, int st) {
    P* sk = stage_k(st);
    float* sc = stage_sc(st);
    issue_tile<bf16, P, kPaged, kVec, kI8 ? 0 : DMAX>(a, c, tbl_s, blk0, j, kKeys, kRs,
                                      DMAX * sizeof(P) / 16, DMAX, sk,
                                      sk + kKeys * kRs, sc, sc + kKeys);
  };
  if constexpr (kPaged) {
    load_table<kPaged>(a, c, kKeys, tbl_s);
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < kNst - 1; ++p) {
    if (c.t0 + p < c.t1) issue(c.t0 + p, p);
    cp_async_commit();
  }

  uint32_t qa[kQReg ? DMAX / 16 : 1][4];
  const uint32_t q_addr = smem_addr(
      q_s + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLds + (lane >> 4) * 8);
  float o[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  long long lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = c.r0 + mt * 16 + (lane >> 2) + 8 * h;
    lim[h] = c.idx + r % a.steps;
  }
  const bool inject = a.k_new != nullptr;
  const long long fresh_lo = inject ? c.idx : (1LL << 62);
  const long long fresh_hi = c.idx + a.steps;
  const bool scaled = a.k_scales != nullptr;
  bf16* wk = reinterpret_cast<bf16*>(smem + L.widen) + warp * 2 * 16 * DMAX;
  bf16* wv = wk + 16 * DMAX;

  for (int j = c.t0; j < c.t1; ++j) {
    cp_async_wait<kNst - 2>();
    __syncthreads();  // tile j (and Q) landed; every warp is done with tile j - 1
    if (j + kNst - 1 < c.t1) issue(j + kNst - 1, (j - c.t0 + kNst - 1) % kNst);
    cp_async_commit();
    if (!active) continue;
    if constexpr (kQReg) {
      if (j == c.t0)  // the Q tile landed with the first tile's group
#pragma unroll
        for (int kk = 0; kk < DMAX / 16; ++kk) ldsm_x4(qa[kk], q_addr + kk * 32);
    }
    const int st = (j - c.t0) % kNst;
    const P* sk = stage_k(st);
    const P* sv = sk + kKeys * kRs;
    const float* sc = stage_sc(st);
    for (int sub = kg; sub < kKeys / 16; sub += nkg) {
      const int pos0 = j * kKeys + sub * 16;
      const bf16* kr;
      const bf16* vr;
      if constexpr (kI8) {
        widen16<DMAX>(a, c, sk + sub * 16 * kRs, sv + sub * 16 * kRs, wk, wv, pos0,
                      inject);
        kr = wk;
        vr = wv;
      } else {
        kr = reinterpret_cast<const bf16*>(sk) + sub * 16 * kRs;
        vr = reinterpret_cast<const bf16*>(sv) + sub * 16 * kRs;
      }
      fold16<DMAX, kQReg>(kr, vr, qa, q_addr, o, m, l, pos0, lim, a.S,
                          scaled ? sc + sub * 16 : nullptr,
                          scaled ? sc + kKeys + sub * 16 : nullptr, fresh_lo,
                          fresh_hi, a.scale);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' merge now

  float* o_w = reinterpret_cast<float*>(smem);           // [warps][16][DMAX]
  float* m_w = o_w + kDecWarps * 16 * DMAX;              // [warps][16]
  float* l_w = m_w + kDecWarps * 16;                     // [warps][16]
  if (active) {
    const int g4 = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    float* ow = o_w + warp * 16 * DMAX;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      *reinterpret_cast<float2*>(ow + g4 * DMAX + n * 8 + 2 * t) =
          make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(ow + (g4 + 8) * DMAX + n * 8 + 2 * t) =
          make_float2(o[n][2], o[n][3]);
    }
    if (t == 0) {
      m_w[warp * 16 + g4] = m[0];
      m_w[warp * 16 + g4 + 8] = m[1];
      l_w[warp * 16 + g4] = l[0];
      l_w[warp * 16 + g4 + 8] = l[1];
    }
  }
  __syncthreads();
  // The warps of an m-tile merge in warp order.
  for (int e = threadIdx.x; e < c.rows * a.hd; e += kDecThreads) {
    const int r = e / a.hd;
    const int d = e - r * a.hd;
    const int w0 = (r >> 4) * nkg;
    const int rr = r & 15;
    float mm = kNegInf;
    for (int k = 0; k < nkg; ++k) mm = fmaxf(mm, m_w[(w0 + k) * 16 + rr]);
    float ll = 0.f, acc = 0.f;
    for (int k = 0; k < nkg; ++k) {
      const float mk = m_w[(w0 + k) * 16 + rr];
      const float w = mk <= kNegInf ? 0.f : expf(mk - mm);
      ll += l_w[(w0 + k) * 16 + rr] * w;
      acc += o_w[((w0 + k) * 16 + rr) * DMAX + d] * w;
    }
    const size_t pr = part_row(a, c, r);
    a.acc_part[pr * a.hd + d] = acc;
    if (d == 0) {
      a.m_part[pr] = mm;
      a.l_part[pr] = ll;
    }
  }
  if (a.tickets != nullptr) {
    __syncthreads();  // the merge's reads are done before the combine reuses smem
    finish_cell<bf16>(a, c, reinterpret_cast<float*>(smem));
  }
}

// ---------------------------------------------------------------------------
// The f32 arms (q f32; pool f32, or int8 with scales): CUDA cores.

constexpr int kFmaStages = 2;

template <typename P>
__host__ __device__ inline int fma_rs(int hd) {
  return std::is_same<P, int8_t>::value ? (hd + 15) / 16 * 16 : (hd + 3) / 4 * 4 + 4;
}

struct FmaLayout {
  size_t stage, q, acc, s, m, table, total;
};

template <typename P, int KT, bool kPaged>
__host__ __device__ FmaLayout fma_layout(int hd, int chunk, int nlog) {
  FmaLayout L;
  L.stage = r16(2 * KT * static_cast<size_t>(fma_rs<P>(hd)) * sizeof(P) +
                (kPaged ? 2 * KT * 4 : 0));
  L.q = kFmaStages * L.stage;
  L.acc = L.q + static_cast<size_t>(chunk) * hd * 4;
  L.s = L.acc + static_cast<size_t>(chunk) * hd * 4;
  L.m = L.s + static_cast<size_t>(chunk) * KT * 4;
  L.table = r16(L.m + static_cast<size_t>(chunk) * 3 * 4);
  L.total = L.table + (kPaged ? r16(static_cast<size_t>(nlog) * 4) : 0);
  return L;
}

template <typename P, int KT, bool kPaged, bool kVec>
__global__ void __launch_bounds__(kDecThreads) decode_fma_kernel(const DecodeArgs a) {
  constexpr bool kI8 = std::is_same<P, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Cell c = cell_of(a, KT);
  const int hd = a.hd;
  const int rs = fma_rs<P>(hd);
  const FmaLayout L = fma_layout<P, KT, kPaged>(hd, a.chunk, a.nlog);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = m_s + a.chunk;
  float* a_s = l_s + a.chunk;
  int* tbl_s = reinterpret_cast<int*>(smem + L.table);
  const int blk0 = kPaged ? first_block(c, KT) : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float* qg = static_cast<const float*>(a.q) +
                    ((static_cast<size_t>(c.b) * a.h + static_cast<size_t>(c.kh) * c.g) *
                         a.steps + c.r0) * hd;
  for (int e = threadIdx.x; e < c.rows * hd; e += kDecThreads) {
    q_s[e] = qg[e];
    acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < c.rows; r += kDecThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  load_table<kPaged>(a, c, KT, tbl_s);
  __syncthreads();

  auto stage_k = [&](int st) { return reinterpret_cast<P*>(smem + st * L.stage); };
  auto stage_sc = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L.stage + 2 * KT * rs * sizeof(P));
  };
  auto issue = [&](int j, int st) {
    P* sk = stage_k(st);
    float* sc = stage_sc(st);
    issue_tile<float, P, kPaged, kVec, 0>(a, c, tbl_s, blk0, j, KT, rs,
                                       hd * static_cast<int>(sizeof(P)) / 16, hd, sk,
                                       sk + KT * rs, sc, sc + KT);
  };
  if (c.t0 < c.t1) issue(c.t0, 0);
  cp_async_commit();
  // An int8 pool's fresh rows come from k_new / v_new (a pool in q's type
  // had them copied into the tile).
  const bool fresh_rows = kI8 && a.k_new != nullptr;
  const bool scaled = a.k_scales != nullptr;
  const float* kn = static_cast<const float*>(a.k_new) +
                    (static_cast<size_t>(c.b) * a.kvh + c.kh) * a.steps * hd;
  const float* vn = static_cast<const float*>(a.v_new) +
                    (static_cast<size_t>(c.b) * a.kvh + c.kh) * a.steps * hd;
  const bool injected = a.k_new != nullptr;

  for (int j = c.t0; j < c.t1; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; the previous tile's readers are done
    if (j + 1 < c.t1) issue(j + 1, (j + 1 - c.t0) & 1);
    cp_async_commit();
    const int st = (j - c.t0) & 1;
    const P* sk = stage_k(st);
    const P* sv = sk + KT * rs;
    const float* sck = stage_sc(st);
    const float* scv = sck + KT;
    const int pos0 = j * KT;
    for (int e = threadIdx.x; e < c.rows * KT; e += kDecThreads) {
      const int r = e / KT;
      const int cc = e - r * KT;
      const int pos = pos0 + cc;
      float s = kNegInf;
      // The mask is per (row, step): (r0 + r) % steps is the query's step.
      if (pos < a.S && pos <= c.idx + (c.r0 + r) % a.steps) {
        const long long t = pos - c.idx;
        const bool fresh = injected && t >= 0 && t < a.steps;
        const float* qr = q_s + r * hd;
        float dot = 0.f;
        if (fresh_rows && fresh) {
          for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kn[t * hd + d], dot);
        } else {
          const P* kr = sk + cc * rs;
          for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], to_f(kr[d]), dot);
        }
        s = dot * a.scale;
        if (scaled) s *= fresh ? 1.f : sck[cc];  // K dequant on the f32 score
      }
      s_s[e] = s;
    }
    __syncthreads();
    for (int r = warp; r < c.rows; r += kDecWarps) {
      float* sr = s_s + r * KT;
      float mx = kNegInf;
      for (int cc = lane; cc < KT; cc += 32) mx = fmaxf(mx, sr[cc]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int cc = lane; cc < KT; cc += 32) {
        const float p = sr[cc] <= kNegInf ? 0.f : expf(sr[cc] - m_new);
        sum += p;
        if (scaled) {
          const long long t = pos0 + cc - c.idx;
          sr[cc] = p * ((injected && t >= 0 && t < a.steps) ? 1.f : scv[cc]);
        } else {
          sr[cc] = p;
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    const long long t_lo = c.idx - pos0;  // tile column of the first fresh row
    for (int e = threadIdx.x; e < c.rows * hd; e += kDecThreads) {
      const int r = e / hd;
      const int d = e - r * hd;
      const float* pr = s_s + r * KT;
      float pv = 0.f;
      for (int cc = 0; cc < KT; ++cc) {
        const long long t = cc - t_lo;
        const float vx = (fresh_rows && t >= 0 && t < a.steps)
                             ? vn[t * hd + d]
                             : to_f(sv[cc * rs + d]);
        pv = fmaf(pr[cc], vx, pv);
      }
      acc[e] = acc[e] * a_s[r] + pv;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < c.rows * hd; e += kDecThreads) {
    const int r = e / hd;
    const size_t pr = part_row(a, c, r);
    a.acc_part[pr * hd + (e - r * hd)] = acc[e];
    if (e - r * hd == 0) {
      a.m_part[pr] = m_s[r];
      a.l_part[pr] = l_s[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Launch side.

// Raises a kernel's dynamic shared-memory cap when a larger shape needs it,
// so repeated launches (and CUDA graph capture) make no attribute call.
// Single device, single host thread per process. A failure is cleared so
// that it does not leak into the next launch's cudaGetLastError().
template <typename K>
int raise_smem(K kernel, size_t bytes, size_t* cap) {
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= *cap) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  *cap = bytes;
  return 0;
}

template <typename P, int DMAX, bool kPaged, bool kVec>
int launch_mma(const DecodeArgs& a, dim3 grid, cudaStream_t st) {
  if (a.chunk > kMaxMmaRows) return static_cast<int>(cudaErrorInvalidValue);
  static size_t cap = 0;
  const size_t smem = mma_layout<P, DMAX, kPaged>(a.chunk, a.nlog).total;
  const int err = raise_smem(decode_mma_kernel<P, DMAX, kPaged, kVec>, smem, &cap);
  if (err != 0) return err;
  decode_mma_kernel<P, DMAX, kPaged, kVec><<<grid, kDecThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, int KT, bool kPaged, bool kVec>
int launch_fma(const DecodeArgs& a, dim3 grid, cudaStream_t st) {
  static size_t cap = 0;
  const size_t smem = fma_layout<P, KT, kPaged>(a.hd, a.chunk, a.nlog).total;
  const int err = raise_smem(decode_fma_kernel<P, KT, kPaged, kVec>, smem, &cap);
  if (err != 0) return err;
  decode_fma_kernel<P, KT, kPaged, kVec><<<grid, kDecThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launches one decode call: the split kernel of q's type T over a pool of
// type P, then, without tickets, the combine kernel. kFmaKeys: the f32
// arm's keys per tile.
template <typename T, typename P, bool kPaged, bool kVec, int kFmaKeys>
int launch_decode(const DecodeArgs& a, int nsplit, void* stream) {
  const int rows = (a.h / a.kvh) * a.steps;
  if (a.hd < 1 || a.hd > 256 || a.chunk < 1 || a.kvh < 1 || a.h % a.kvh != 0 ||
      nsplit < 1 || nsplit > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  // The last CTA of a cell combines (tickets) only in the bf16 arms and for
  // cells of at most 512 outputs, whose combine fits the ring's memory.
  if (a.tickets != nullptr &&
      (!std::is_same<T, bf16>::value || a.hd < 8 || a.chunk * a.hd > 4 * kDecThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunk = (rows + a.chunk - 1) / a.chunk;
  const dim3 grid(a.b, a.kvh * nchunk, nsplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if constexpr (std::is_same<T, bf16>::value) {
    err = a.hd <= 64    ? launch_mma<P, 64, kPaged, kVec>(a, grid, st)
          : a.hd <= 128 ? launch_mma<P, 128, kPaged, kVec>(a, grid, st)
                        : launch_mma<P, 256, kPaged, kVec>(a, grid, st);
  } else {
    err = launch_fma<P, kFmaKeys, kPaged, kVec>(a, grid, st);
  }
  if (err != 0 || a.tickets != nullptr) return err;
  const int R = combine_rows(a.hd);
  decode_combine_kernel<T><<<dim3(a.b, a.kvh * nchunk, (a.chunk + R - 1) / R),
                             kDecThreads,
                             static_cast<size_t>(R) * (2 * nsplit + 1) * 4, st>>>(a, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
