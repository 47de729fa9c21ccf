// Fused QKV projection + bias + rotary embedding for the decode step (K2).
//
// Replaces: the projection half of
// walkai_nos_tpu/ops/decode_attention.py:_fused_qkv_pallas (:1006), i.e.
// the `_project` stage of _fused_stream_kernel (decode_attention.py:935-963):
// qkv = (x @ w) in f32, x the per-channel scale ws, + bias in f32, cast
// to x's dtype, then RoPE in the HF half-split layout with f32 angles
// (column i pairs with column i + hd/2), then split into q [b, h, steps,
// hd] and the fresh k_new / v_new [b, kvh, steps, hd] rows. The attention
// half is paged_attention.cu with fresh-row injection.
//
// The int8-weight arm (the `_i8_` entry points; the TPU kernel's w_ref /
// ws_ref at decode_attention.py:942-946): w holds int8 values with a
// per-output-channel f32 scale row ws; qkv = (x @ w) in f32 * ws[n] +
// bias[n], rounded once to x's type. The weight lands in shared memory as
// int8 and is widened to bf16 there, as the TPU kernel's
// `w_ref[...].astype(xv.dtype)` (exact: |w| <= 127). A full-precision
// weight with ws all ones (the "sim" arm) matches the unquantized arm bit
// for bit: v * 1.0 is exact, and the multiply and the add are separate
// roundings.
//
// What bounds it on an H100: bytes. A decode step has b * steps <= 64
// rows, so the product does ~2 * rows FLOPs per weight element, far below
// the ~295 FLOP/byte where the tensor cores would limit, and the floor is
// the weight read: dm * (dm + 2 * kv_dim) elements (10.5 MB in bf16 at
// TinyLlama width, 5.2 MB in int8), 3.1 us (1.6 us) at 3.35 TB/s.
//
// What the design does about it:
// - ONE launch a call. A CTA owns one head's hd columns, up to 64 rows
//   (every row of a decode step: the weight is read from device memory
//   once for any M <= 64) and one split of the k dimension: the split
//   count comes from the shapes and the SM count alone
//   (`_qkv_geometry` in ops/decode_attention.py), enough CTAs that every
//   SM streams weight at once. With more than one split each CTA writes an
//   f32 partial and takes a ticket (one thread, acquire-release); the last
//   CTA of each (row block, head) to finish resets it, stages every
//   split's partial into shared memory with bulk copies, adds them in
//   split order, then scales, adds the bias, rounds, rotates (a head's
//   rotary pairs meet in its tile) and scatters. No second kernel.
// - The weight streams through a ring of four stages of 64 k rows by the
//   TMA unit (a 2D tensor map; 8 KB of bf16 weight a stage at hd 64, in
//   64-column panels under the 128-byte swizzle), completing on an
//   mbarrier a stage: one instruction a stage instead of 16-byte copies
//   from every thread, which the steps-8 and int8 calls felt most. x (L2
//   resident) still comes by cp.async. Every slot of the ring is issued
//   before anything waits (a TinyLlama split is four stages: all of it);
//   the index, scale and bias are read while they fly and used only by
//   the epilogue.
// - Products on tensor cores (bf16 x and bf16 or widened int8 weight):
//   mma.sync.m16n8k16 with an f32 accumulator, x tiles through ldmatrix
//   as the A operand, the weight tile (k rows, n contiguous) through
//   ldmatrix.trans as the B operand; tile rows XOR-swizzled by row, so
//   ldmatrix reads without bank conflicts. An int8 stage lands as int8
//   and each warp widens its own columns to bf16 once a stage, exactly and
//   without the conversion unit. Warps split the head's columns, so each
//   output is summed by one warp over its split's k in increasing order: a
//   row's result never depends on the other rows of the launch, and two
//   calls give the same bits.
// - The f32 arm (f32 x: the tests' and the f32 checks' arm) keeps
//   CUDA-core FMAs (tensor cores would take f32 as TF32) and cp.async in
//   the same one-launch structure and epilogue.

#include <cuda.h>

#include "decode_mma.cuh"

namespace {

constexpr int kQkvThreads = 128;  // 4 warps
constexpr int kQkvWarps = kQkvThreads / 32;
constexpr int kQkvK = 64;         // k rows per stage
constexpr int kQkvRows = 64;      // rows a CTA holds (4 m16 tiles)
constexpr int kQkvMaxSplits = 32;
constexpr int kQkvMaxHd = 128;
constexpr int kQkvMmaStages = 4;  // ring stages of the bf16 arms
constexpr int kQkvFmaStages = 3;  // and of the f32 arm

struct QkvArgs {
  const void* x;           // [M, K], T
  const void* w;           // [K, N], W; N = (h + 2 * kvh) * hd
  const void* bias;        // [N], T, or null
  const float* wscale;     // [N] f32, or null
  const int32_t* index;    // [b] position of step 0
  float theta;             // rotary base; <= 0: no rope
  float* partial;          // [cells, ksplit, rcap, hd] f32 (ksplit > 1)
  int* tickets;            // [cells] zeros (ksplit > 1)
  void* q_out;             // [b, h, steps, hd]
  void* k_out;             // [b, kvh, steps, hd]
  void* v_out;             // [b, kvh, steps, hd]
  int M, K, h, kvh, steps, hd, ksplit, k_per;
  int x_vec;               // x rows start on 16 bytes: cp.async them
};

// Where this CTA's work lies: head (column block), rows m0 .. m0 + rows,
// k in [kb, ke) in nk stages.
struct QkvCell {
  int head, heads, cell, m0, rows, rcap, kb, ke, nk;
};

__device__ __forceinline__ QkvCell qkv_cell(const QkvArgs& a) {
  QkvCell c;
  c.head = blockIdx.x;
  c.heads = gridDim.x;
  c.cell = blockIdx.y * gridDim.x + blockIdx.x;
  c.m0 = blockIdx.y * kQkvRows;
  c.rows = min(kQkvRows, a.M - c.m0);
  c.rcap = min(kQkvRows, a.M);
  c.kb = blockIdx.z * a.k_per;
  c.ke = min(a.K, c.kb + a.k_per);
  c.nk = (c.ke - c.kb + kQkvK - 1) / kQkvK;
  return c;
}

// Shared memory of a CTA: a ring of stages, each the weight tile [64 k
// rows][DMAX] then the x tile [xrows][64 k] (a bf16 arm's stage starts on
// 1024 bytes, for its swizzled weight panels); then (int8 weights) one
// widening buffer a warp. After the loop all of it holds the epilogue's
// f32 sums: the CTA's own [rcap][hd] (one split), or the partials of every
// split, staged a chunk of rows at a time.
struct QkvLayout {
  size_t w_bytes, stage, widen, total;
};

template <typename T, typename W, int DMAX, int kStages>
__host__ __device__ QkvLayout qkv_layout(int rcap) {
  constexpr bool kMma = !std::is_same<T, float>::value;
  constexpr bool kI8 = std::is_same<W, int8_t>::value;
  const int xrows = kMma ? (rcap + 15) / 16 * 16 : rcap;
  QkvLayout L;
  L.w_bytes = r16(static_cast<size_t>(kQkvK) * DMAX * sizeof(W));
  L.stage = L.w_bytes + r16(static_cast<size_t>(xrows) * kQkvK * sizeof(T));
  if (kMma) L.stage = (L.stage + 1023) & ~static_cast<size_t>(1023);
  const size_t ring = kStages * L.stage;
  L.widen = r16(smax(ring, static_cast<size_t>(rcap) * DMAX * 4));
  L.total = L.widen + (kMma && kI8 ? kQkvWarps * kQkvK * (DMAX / 4) * 2 : 0);
  return L;
}

// Copies stage j of this CTA's split into ring slot `stage` with cp.async:
// the x tile (zero past the rows and ke; bf16 rows swizzled by dswz), and
// for the f32 arm the weight tile too (zero past ke and hd; the bf16 arms'
// weight comes by TMA, qkv_issue_weight).
template <typename T, typename W, int DMAX>
__device__ __forceinline__ void qkv_issue(const QkvArgs& a, const QkvCell& c,
                                          unsigned char* stage, size_t w_bytes,
                                          int j, int N, int xrows) {
  const int k0 = c.kb + j * kQkvK;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int kWv = 16 / sizeof(W);  // weights a 16-byte chunk
    constexpr int kCw = DMAX / kWv;      // chunks a weight row
    const W* w = static_cast<const W*>(a.w);
    W* ws = reinterpret_cast<W*>(stage);
    for (int i = threadIdx.x; i < kQkvK * kCw; i += kQkvThreads) {
      const int r = i / kCw;
      const int ch = i - r * kCw;
      const bool ok = k0 + r < c.ke && ch * kWv < a.hd;
      cp_async16(smem_addr(ws + r * DMAX + ch * kWv),
                 ok ? w + static_cast<size_t>(k0 + r) * N + c.head * a.hd + ch * kWv : w,
                 ok ? 16 : 0);
    }
  }
  constexpr bool kXSwz = std::is_same<T, bf16>::value;
  constexpr int kXv = 16 / sizeof(T);
  const T* x = static_cast<const T*>(a.x);
  T* xs = reinterpret_cast<T*>(stage + w_bytes);
  if (a.x_vec) {
    for (int i = threadIdx.x; i < xrows * (kQkvK / kXv); i += kQkvThreads) {
      const int r = i / (kQkvK / kXv);
      const int ch = i - r * (kQkvK / kXv);
      const bool ok = r < c.rows && k0 + ch * kXv < c.ke;
      const int off = kXSwz ? dswz<kQkvK>(r, ch * kXv) : r * kQkvK + ch * kXv;
      cp_async16(smem_addr(xs + off),
                 ok ? x + static_cast<size_t>(c.m0 + r) * a.K + k0 + ch * kXv : x,
                 ok ? 16 : 0);
    }
  } else {  // x rows not on 16 bytes (d_model not a multiple of 16 bytes)
    for (int e = threadIdx.x; e < xrows * kQkvK; e += kQkvThreads) {
      const int r = e / kQkvK;
      const int kk = e - r * kQkvK;
      const int off = kXSwz ? dswz<kQkvK>(r, kk) : e;
      xs[off] = (r < c.rows && k0 + kk < c.ke)
                    ? x[static_cast<size_t>(c.m0 + r) * a.K + k0 + kk]
                    : from_f<T>(0.f);
    }
  }
}

// Bulk copies (the TMA unit; no per-thread requests) completing on an
// mbarrier, and the mbarrier itself.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One box of a 2D tensor map (coordinates: column, row) into shared memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int col, int row,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

// The weight of stage j into ring slot `stage` by the tensor map `wmap`
// (one thread): bf16, DMAX / 64 boxes of 64 k rows x 64 columns, each a
// panel whose 16-byte chunks the TMA unit swizzles by row (dswz<64>);
// int8, one box of 64 k rows x DMAX columns, unswizzled. Rows past d_model
// and columns past the weight arrive as zeros.
template <typename W, int DMAX>
__device__ __forceinline__ void qkv_issue_weight(const QkvCell& c, int hd, unsigned char* stage,
                                                 int j, const CUtensorMap* wmap,
                                                 uint64_t* bar) {
  constexpr bool kI8 = std::is_same<W, int8_t>::value;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(bar, kQkvK * DMAX * sizeof(W));
  const int k0 = c.kb + j * kQkvK;
  if constexpr (kI8) {
    tma_load_2d(stage, wmap, c.head * hd, k0, bar);
  } else {
#pragma unroll
    for (int p = 0; p < DMAX / 64; ++p)
      tma_load_2d(stage + p * kQkvK * 64 * 2, wmap, c.head * hd + 64 * p, k0, bar);
  }
}

// What the epilogue reads besides the sums, loaded into shared memory while
// the first stages are in flight: this head's scale and bias columns, the
// rotary inverse frequencies, and each row's position (index + step).
struct QkvEpilogue {
  float scale[kQkvMaxHd], bias[kQkvMaxHd], inv_freq[kQkvMaxHd / 2], pos[kQkvRows];
};

template <typename T>
__device__ __forceinline__ void qkv_prefetch(const QkvArgs& a, const QkvCell& c,
                                             QkvEpilogue& ep) {
  const int n0 = c.head * a.hd;
  for (int i = threadIdx.x; i < a.hd; i += kQkvThreads) {
    if (a.wscale != nullptr) ep.scale[i] = a.wscale[n0 + i];
    if (a.bias != nullptr) ep.bias[i] = to_f(static_cast<const T*>(a.bias)[n0 + i]);
    if (a.theta > 0.f && 2 * i < a.hd)
      ep.inv_freq[i] =
          __fdiv_rn(1.f, powf(a.theta, __fdiv_rn(2.f * i, static_cast<float>(a.hd))));
  }
  for (int r = threadIdx.x; r < c.rows; r += kQkvThreads) {
    const int bi = (c.m0 + r) / a.steps;
    ep.pos[r] = __fadd_rn(static_cast<float>(a.index[bi]),
                          static_cast<float>(c.m0 + r - bi * a.steps));
  }
}

// v (the f32 sum of output column col of the head) x the channel scale, +
// bias, rounded to the storage type (the TPU kernel's `.astype(x.dtype)`
// before rotary).
template <typename T>
__device__ __forceinline__ float qkv_round(const QkvArgs& a, const QkvEpilogue& ep,
                                           float v, int col) {
  if (a.wscale != nullptr) v = __fmul_rn(v, ep.scale[col]);
  if (a.bias != nullptr) v = __fadd_rn(v, ep.bias[col]);
  return to_f(from_f<T>(v));
}

// Two adjacent outputs of a row (4-byte aligned in bf16, 8 in f32).
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The rounded sum of columns i, i + 1 of a staged row `y` over nz splits
// zs floats apart, added in split order.
template <typename T>
__device__ __forceinline__ float2 qkv_sum2(const QkvArgs& a, const QkvEpilogue& ep,
                                           const float* y, int i, int nz, int zs) {
  float2 s = *reinterpret_cast<const float2*>(y + i);
#pragma unroll 4
  for (int z = 1; z < nz; ++z) {
    const float2 p = *reinterpret_cast<const float2*>(y + z * zs + i);
    s.x += p.x;
    s.y += p.y;
  }
  return make_float2(qkv_round<T>(a, ep, s.x, i), qkv_round<T>(a, ep, s.y, i + 1));
}

// After this CTA's sums are in `st` ([rows][hd] f32 shared memory; one
// split) or in its partial (several): the cell's last CTA to finish stages
// the partials of every split into shared memory with bulk copies (one a
// split, all in flight at once, a chunk of rows at a time, within `cap`
// bytes), then each thread takes two adjacent columns of a row (with
// rotary: two adjacent pairs), adds them over the splits in split order,
// scales, adds the bias, rounds, rotates in f32 and stores into q / k_new
// / v_new. The rotary angles are those of the TPU path's `_rope_tables`
// (f32: inv_freq = 1 / theta^(2i/hd), angle = (index + t) * inv_freq),
// computed here instead of read from precomputed tables.
template <typename T>
__device__ __forceinline__ void qkv_finish(const QkvArgs& a, const QkvCell& c,
                                           const QkvEpilogue& ep, float* st, size_t cap) {
  const int half = a.hd / 2;
  const bool rope = a.theta > 0.f && c.head < a.h + a.kvh;
  __shared__ __align__(8) uint64_t staged;
  if (a.ksplit > 1) {
    __shared__ int last;
    __syncthreads();  // every thread's partial is written
    if (threadIdx.x == 0) {
      // Releases this CTA's partial and, for the last CTA, acquires the
      // others'.
      int old;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
                   : "=r"(old)
                   : "l"(a.tickets + c.cell), "r"(1)
                   : "memory");
      last = old == a.ksplit - 1;
      if (last) mbar_init(&staged);
    }
    __syncthreads();
    if (!last) return;
  }
  __syncthreads();
  T* dst;
  int nh, hh;  // the destination's heads, and this head's index there
  if (c.head < a.h) {
    dst = static_cast<T*>(a.q_out);
    nh = a.h;
    hh = c.head;
  } else if (c.head < a.h + a.kvh) {
    dst = static_cast<T*>(a.k_out);
    nh = a.kvh;
    hh = c.head - a.h;
  } else {
    dst = static_cast<T*>(a.v_out);
    nh = a.kvh;
    hh = c.head - a.h - a.kvh;
  }
  const float* part = a.partial + static_cast<size_t>(c.cell) * a.ksplit * c.rcap * a.hd;
  const int chunk = a.ksplit > 1
                        ? min(c.rows, static_cast<int>(cap / (static_cast<size_t>(a.ksplit) *
                                                              a.hd * 4)))
                        : c.rows;
  const int per_row = (rope ? half : a.hd) / 2;  // column pairs a row
  for (int r0 = 0; r0 < c.rows; r0 += chunk) {
    const int nr = min(chunk, c.rows - r0);
    const int zs = nr * a.hd;  // floats between two splits' rows
    if (a.ksplit > 1) {
      if (r0 > 0) __syncthreads();  // the previous chunk's reads are done
      if (threadIdx.x == 0) {
        // The partials were written by other CTAs' generic stores.
        asm volatile("fence.proxy.async;\n" ::: "memory");
        mbar_expect(&staged, static_cast<uint32_t>(a.ksplit) * zs * 4);
        for (int z = 0; z < a.ksplit; ++z)
          bulk_copy(st + z * zs, part + (static_cast<size_t>(z) * c.rcap + r0) * a.hd,
                    zs * 4, &staged);
      }
      mbar_wait(&staged, (r0 / chunk) & 1);
    }
    for (int e = threadIdx.x; e < nr * per_row; e += kQkvThreads) {
      const int rr = e / per_row;
      const int i = (e - rr * per_row) * 2;
      const int row = c.m0 + r0 + rr;
      const int bi = row / a.steps;
      const int t = row - bi * a.steps;
      T* out = dst + ((static_cast<size_t>(bi) * nh + hh) * a.steps + t) * a.hd;
      const float* y = st + rr * a.hd;
      const float2 lo = qkv_sum2<T>(a, ep, y, i, a.ksplit, zs);
      if (rope) {
        const float2 hi = qkv_sum2<T>(a, ep, y, i + half, a.ksplit, zs);
        float s0, c0, s1, c1;
        sincosf(__fmul_rn(ep.pos[r0 + rr], ep.inv_freq[i]), &s0, &c0);
        sincosf(__fmul_rn(ep.pos[r0 + rr], ep.inv_freq[i + 1]), &s1, &c1);
        store2(out + i, __fadd_rn(__fmul_rn(lo.x, c0), __fmul_rn(-hi.x, s0)),
               __fadd_rn(__fmul_rn(lo.y, c1), __fmul_rn(-hi.y, s1)));
        store2(out + i + half, __fadd_rn(__fmul_rn(hi.x, c0), __fmul_rn(lo.x, s0)),
               __fadd_rn(__fmul_rn(hi.y, c1), __fmul_rn(lo.y, s1)));
      } else {
        store2(out + i, lo.x, lo.y);
      }
    }
  }
  if (a.ksplit > 1 && threadIdx.x == 0) a.tickets[c.cell] = 0;
}

// Four int8 weights (the bytes of w) as two bf16 pairs, exactly, without
// the conversion unit: each byte + 128 becomes the low byte of the f32
// 2^23 + u, less 2^23 + 128 gives the weight, and an integer of at most 8
// bits keeps its f32 value in the upper 16 bits (its bf16).
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// Element offset of bf16 chunk ch of row r in a warp's widened int8 stage:
// 64 k rows of the warp's DMAX / 4 columns, chunks XOR-swizzled so that
// ldmatrix's eight rows of one chunk fall in distinct banks.
template <int DMAX>
__device__ __forceinline__ int wide_off(int r, int ch) {
  constexpr int kNc = DMAX / 32;  // chunks a row: 2 or 4
  return r * (DMAX / 4) + ((ch ^ ((r / (8 / kNc)) % kNc)) << 3);
}

// The bf16 arms (x bf16; weight bf16, or int8 widened to bf16). Warp w
// owns columns [w * DMAX / 4, (w + 1) * DMAX / 4) of the head for every
// row and every k of the split: DMAX / 64 column groups of 16 (two n8
// tiles), up to four m16 tiles.
template <typename W, int DMAX>
__global__ void __launch_bounds__(kQkvThreads)
    qkv_mma_kernel(const QkvArgs a, const __grid_constant__ CUtensorMap wmap) {
  constexpr bool kI8 = std::is_same<W, int8_t>::value;
  constexpr int kStages = kQkvMmaStages;
  constexpr int kGroups = DMAX / 64;  // 16-column groups a warp
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  // The swizzled weight panels need 1024-byte alignment; the launch adds
  // 1024 bytes of slack.
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const QkvCell c = qkv_cell(a);
  const QkvLayout L = qkv_layout<bf16, W, DMAX, kStages>(c.rcap);
  const int N = c.heads * a.hd;
  const int mt_n = (c.rows + 15) / 16;
  const int xrows = (c.rcap + 15) / 16 * 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int x7 = lane & 7;
  const bool active = warp * (DMAX / 4) < a.hd;

  // Every slot of the ring is filled before anything waits.
  if (threadIdx.x == 0) {
    for (int p = 0; p < kStages; ++p) mbar_init(&full[p]);
    for (int p = 0; p < kStages && p < c.nk; ++p)
      qkv_issue_weight<W, DMAX>(c, a.hd, smem + p * L.stage, p, &wmap, &full[p]);
  }
#pragma unroll
  for (int p = 0; p < kStages; ++p) {
    if (p < c.nk) qkv_issue<bf16, W, DMAX>(a, c, smem + p * L.stage, L.w_bytes, p, N, xrows);
    cp_async_commit();
  }
  __shared__ QkvEpilogue ep;
  qkv_prefetch<bf16>(a, c, ep);
  __syncthreads();  // the barriers are initialized before anyone waits

  float acc[4][2 * kGroups][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int n = 0; n < 2 * kGroups; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  bf16* wb = reinterpret_cast<bf16*>(smem + L.widen) + warp * kQkvK * (DMAX / 4);

  for (int j = 0; j < c.nk; ++j) {
    // x of stage j: its group is the j-th, or (from stage kStages on, issued
    // one iteration after the empty group of iteration 0) the (j + 1)-th.
    cp_async_wait<kStages - 2>();
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    __syncthreads();  // stage j landed; every warp is done with stage j - 1
    // Stage j - 1's slot is free: stage j + kStages - 1 goes there.
    if (j > 0 && j + kStages - 1 < c.nk) {
      const int st = (j - 1) % kStages;
      if (threadIdx.x == 0)
        qkv_issue_weight<W, DMAX>(c, a.hd, smem + st * L.stage, j + kStages - 1, &wmap,
                                  &full[st]);
      qkv_issue<bf16, W, DMAX>(a, c, smem + st * L.stage, L.w_bytes, j + kStages - 1, N,
                               xrows);
    }
    cp_async_commit();
    if (!active) continue;
    const unsigned char* stage = smem + j % kStages * L.stage;
    const bf16* xs = reinterpret_cast<const bf16*>(stage + L.w_bytes);
    if constexpr (kI8) {
      // Widen this warp's columns of the stage (16 int8 a chunk) into its
      // own bf16 tile.
      const int8_t* w8 = reinterpret_cast<const int8_t*>(stage);
      __syncwarp();  // the previous stage's ldmatrix reads are done
      for (int i = lane; i < kQkvK * kGroups; i += 32) {
        const int r = i / kGroups;
        const int gi = i - r * kGroups;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(w8 + r * DMAX + (warp * kGroups + gi) * 16);
        uint32_t u[8];
        widen4(raw.x, u[0], u[1]);
        widen4(raw.y, u[2], u[3]);
        widen4(raw.z, u[4], u[5]);
        widen4(raw.w, u[6], u[7]);
        *reinterpret_cast<uint4*>(wb + wide_off<DMAX>(r, 2 * gi)) =
            make_uint4(u[0], u[1], u[2], u[3]);
        *reinterpret_cast<uint4*>(wb + wide_off<DMAX>(r, 2 * gi + 1)) =
            make_uint4(u[4], u[5], u[6], u[7]);
      }
      __syncwarp();
    }
#pragma unroll
    for (int kk = 0; kk < kQkvK / 16; ++kk) {
      // B fragments of this warp's column groups at k rows kk * 16 ..
      uint32_t b[kGroups][4];
      const int wrow = kk * 16 + x7 + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if constexpr (kI8) {
          ldsm_x4_t(b[g], smem_addr(wb + wide_off<DMAX>(wrow, 2 * g + (lane >> 4))));
        } else {
          const int ch = 2 * (warp * kGroups + g) + (lane >> 4);
          ldsm_x4_t(b[g], smem_addr(reinterpret_cast<const bf16*>(stage) +
                                    (ch >> 3) * kQkvK * 64 + dswz<64>(wrow, (ch & 7) * 8)));
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < mt_n) {
          uint32_t xa[4];
          ldsm_x4(xa, smem_addr(xs + dswz<kQkvK>(mt * 16 + x7 + ((lane >> 3) & 1) * 8,
                                                 (2 * kk + (lane >> 4)) * 8)));
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            mma16816(acc[mt][2 * g], xa, b[g][0], b[g][1]);
            mma16816(acc[mt][2 * g + 1], xa, b[g][2], b[g][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the epilogue's rows now

  // Accumulator element i of n8 tile n of m-tile mt: row mt * 16 + g4 + 8 *
  // (i >> 1), column (warp * kGroups + n / 2) * 16 + (n & 1) * 8 + 2t + (i & 1).
  float* st = reinterpret_cast<float*>(smem);
  if (active) {
    const int g4 = lane >> 2;
    const int t = lane & 3;
    float* part = a.partial + (static_cast<size_t>(c.cell) * a.ksplit + blockIdx.z) *
                                  c.rcap * a.hd;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int n = 0; n < 2 * kGroups; ++n)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = mt * 16 + g4 + 8 * h2;
          const int col = (warp * kGroups + n / 2) * 16 + (n & 1) * 8 + 2 * t;
          if (mt < mt_n && r < c.rows && col < a.hd) {
            const float v0 = acc[mt][n][2 * h2], v1 = acc[mt][n][2 * h2 + 1];
            *reinterpret_cast<float2*>((a.ksplit > 1 ? part : st) + r * a.hd + col) =
                make_float2(v0, v1);
          }
        }
  }
  qkv_finish<bf16>(a, c, ep, st, L.total);
}

// The f32 arm (x f32; weight f32 or int8): thread owns column tid % DMAX
// of rows tid / DMAX + i * (128 / DMAX), summed over k in increasing order.
template <typename W, int DMAX>
__global__ void __launch_bounds__(kQkvThreads) qkv_fma_kernel(const QkvArgs a) {
  constexpr int kStages = kQkvFmaStages;
  constexpr int kStep = kQkvThreads / DMAX;  // rows between a thread's outputs
  constexpr int kAcc = kQkvRows / kStep;
  extern __shared__ __align__(16) unsigned char smem[];

  const QkvCell c = qkv_cell(a);
  const QkvLayout L = qkv_layout<float, W, DMAX, kStages>(c.rcap);
  const int N = c.heads * a.hd;
  const int col = threadIdx.x % DMAX;
  const int r0 = threadIdx.x / DMAX;

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < c.nk) qkv_issue<float, W, DMAX>(a, c, smem + p * L.stage, L.w_bytes, p, N, c.rcap);
    cp_async_commit();
  }
  __shared__ QkvEpilogue ep;
  qkv_prefetch<float>(a, c, ep);
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int j = 0; j < c.nk; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < c.nk)
      qkv_issue<float, W, DMAX>(a, c, smem + (j + kStages - 1) % kStages * L.stage,
                                L.w_bytes, j + kStages - 1, N, c.rcap);
    cp_async_commit();
    if (col >= a.hd) continue;
    const unsigned char* stage = smem + j % kStages * L.stage;
    const W* ws = reinterpret_cast<const W*>(stage);
    const float* xs = reinterpret_cast<const float*>(stage + L.w_bytes);
    const int kn = min(kQkvK, c.ke - (c.kb + j * kQkvK));
    for (int kk = 0; kk < kn; ++kk) {
      const float wv = to_f(ws[kk * DMAX + col]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int r = r0 + i * kStep;
        if (r < c.rows) acc[i] = fmaf(xs[r * kQkvK + kk], wv, acc[i]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* st = reinterpret_cast<float*>(smem);
  if (col < a.hd) {
    float* part = a.partial + (static_cast<size_t>(c.cell) * a.ksplit + blockIdx.z) *
                                  c.rcap * a.hd;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = r0 + i * kStep;
      if (r < c.rows) {
        (a.ksplit > 1 ? part : st)[r * a.hd + col] = acc[i];
      }
    }
  }
  qkv_finish<float>(a, c, ep, st, L.total);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda), or null.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The weight [K, N] as a 2D tensor map with 64-row boxes: bf16 boxes of 64
// columns under the 128-byte swizzle, int8 boxes of DMAX columns.
template <typename W, int DMAX>
int weight_map(const QkvArgs& a, CUtensorMap* map) {
  constexpr bool kI8 = std::is_same<W, int8_t>::value;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t n = static_cast<cuuint64_t>(a.h + 2 * a.kvh) * a.hd;
  const cuuint64_t dims[2] = {n, static_cast<cuuint64_t>(a.K)};
  const cuuint64_t strides[1] = {n * sizeof(W)};
  const cuuint32_t box[2] = {kI8 ? DMAX : 64, kQkvK};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, kI8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(a.w), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      kI8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename W, int DMAX>
int launch_qkv(const QkvArgs& a, dim3 grid, cudaStream_t st) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  static size_t cap = 0;
  constexpr int kStages = kMma ? kQkvMmaStages : kQkvFmaStages;
  const size_t smem = qkv_layout<T, W, DMAX, kStages>(min(kQkvRows, a.M)).total;
  if (smem < static_cast<size_t>(a.ksplit) * a.hd * 4)  // a row of every split
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kMma) {
    CUtensorMap wmap;
    int err = weight_map<W, DMAX>(a, &wmap);
    if (err == 0) err = raise_smem(qkv_mma_kernel<W, DMAX>, smem + 1024, &cap);
    if (err != 0) return err;
    qkv_mma_kernel<W, DMAX><<<grid, kQkvThreads, smem + 1024, st>>>(a, wmap);
  } else {
    const int err = raise_smem(qkv_fma_kernel<W, DMAX>, smem, &cap);
    if (err != 0) return err;
    qkv_fma_kernel<W, DMAX><<<grid, kQkvThreads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch(QkvArgs a, void* stream) {
  const int heads = a.h + 2 * a.kvh;
  const int wv = 16 / static_cast<int>(sizeof(W));
  if (a.M < 1 || a.K < 1 || a.h < 1 || a.kvh < 1 || a.steps < 1 || a.M % a.steps != 0 ||
      a.hd < wv || a.hd > kQkvMaxHd || a.hd % wv != 0 || a.hd % 4 != 0 || a.ksplit < 1 ||
      a.ksplit > kQkvMaxSplits || a.k_per < 1 || a.k_per % kQkvK != 0 ||
      static_cast<long long>(a.ksplit - 1) * a.k_per >= a.K ||
      static_cast<long long>(a.ksplit) * a.k_per < a.K ||
      (a.ksplit > 1 && (a.partial == nullptr || a.tickets == nullptr)) ||
      (reinterpret_cast<uintptr_t>(a.w) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.x_vec = a.K % (16 / static_cast<int>(sizeof(T))) == 0 &&
            (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  const dim3 grid(heads, (a.M + kQkvRows - 1) / kQkvRows, a.ksplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.hd <= 64 ? launch_qkv<T, W, 64>(a, grid, st) : launch_qkv<T, W, 128>(a, grid, st);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 = ok).
// Split z covers k in [z * k_per, min(K, (z + 1) * k_per)); k_per is a
// multiple of 64 and the last split is not empty. With ksplit > 1,
// `partial` is [cells, ksplit, min(M, 64), hd] f32 scratch and `tickets`
// [cells] int32 zeros (cells = (h + 2 * kvh) * ceil(M / 64)), left zero.
// `index` [b] int32 is each slot's first position; `theta` <= 0 skips the
// rotary. `wscale` is the weight's [N] f32 channel scale row, or null. The
// `_i8_` entry points take an int8 weight; the others a weight in x's type.
#define QKV_ROPE_ENTRY(NAME, T, W)                                                   \
  int NAME(const void* x, const void* w, const void* bias, const void* wscale,       \
           const void* index, float theta, void* partial, void* tickets, void* q_out, \
           void* k_out, void* v_out, int M, int K, int h, int kvh, int steps, int hd, \
           int ksplit, int k_per, void* stream) {                                    \
    QkvArgs a{x,       w,       bias,   static_cast<const float*>(wscale),            \
              static_cast<const int32_t*>(index), theta,                              \
              static_cast<float*>(partial), static_cast<int*>(tickets),               \
              q_out,   k_out,   v_out,  M, K, h, kvh, steps, hd, ksplit, k_per, 0};    \
    return launch<T, W>(a, stream);                                                   \
  }

QKV_ROPE_ENTRY(qkv_rope_bf16, bf16, bf16)
QKV_ROPE_ENTRY(qkv_rope_f32, float, float)
QKV_ROPE_ENTRY(qkv_rope_i8_bf16, bf16, int8_t)
QKV_ROPE_ENTRY(qkv_rope_i8_f32, float, int8_t)

}  // extern "C"
