// Paged decode attention over a shared pool of 128-row K/V blocks (K1).
//
// Replaces: walkai_nos_tpu/ops/decode_attention.py:_paged_pallas and its
// body _paged_stream_kernel -> _stream_fold (the TPU kernel), and the
// attention half of _fused_qkv_pallas / _fused_stream_kernel (the fresh-
// row injection, decode_attention.py:965-994).
//
// What it computes: for each slot and each kv head, the g*steps query
// rows of that kv head (row order (group, step), g = heads / kv_heads)
// attend over the slot's cache positions, read THROUGH the block table:
// logical block j of slot b lives in pool block table[b, j]. Query row of
// step t sees positions <= index[b] + t. Logical blocks past
// (index + steps - 1) / 128 are never read, and no table entry past that
// bound is ever loaded, so idle slots (index past capacity, table parked
// on block 0) stay inside the pool. With k_new / v_new given
// ([b, kvh, steps, hd]), positions index .. index+steps-1 take the fresh
// rows instead of the pool rows: the pool is left untouched and the
// caller scatters afterwards, as the TPU kernel's caller does.
//
// Numerics follow _stream_fold (see decode_mma.cuh): f32 running max / sum
// / accumulator, masked scores -1e30, the softmax scale on the f32 score,
// p rounded to q's type before the PV product.
//
// Quantized pools (_stream_fold's `ks` / `vs` seam, and _fused_stream_kernel
// at decode_attention.py:965-1000): with k_scales / v_scales given
// ([nb, kvh, 128] f32, indexed by the same table entry as the block), the
// score of column c is dot(q, k_c) * hd^-0.5 * ks[c], the running sum takes
// the unscaled p, and the PV product takes p * vs[c], rounded to q's type.
// An int8 pool (the `_i8_` entry points) lands in shared memory as int8 and
// widens to q's type losslessly (|k| <= 127); injected fresh rows stay in
// q's type and their scale columns are exactly 1.0, so whatever the scale
// pools hold at the write positions never reaches the output. A "sim" pool
// (q's type, unit scales) runs the same code: x * 1.0 is exact and nothing
// else changes order, so it matches the unquantized arm bit for bit.
//
// What bounds it on an H100: bytes. A decode step reads each resident
// K/V byte once for g*steps query rows and does ~2*g*steps FLOPs per
// byte, far below the ~295 FLOP/byte where the tensor cores would limit;
// the floor is resident K/V bytes over 3.35 TB/s (8.4 MB, 2.5 us at
// TinyLlama's serving step). An int8 pool halves those bytes (plus 4 scale
// bytes per row and head). At that size the latency of each CTA's chain
// (index, table entries, tiles, products, merge, combine) weighs as much
// as the bytes. The design (decode_mma.cuh, shared with K7):
// - one CTA per (slot, kv head, row chunk, split): each K/V byte of a
//   64-row tile (half a block) is loaded once, through a cp.async ring
//   (three stages, four for int8 tiles), and serves every query row of the
//   GQA group (the TPU kernel's KV-head packing); the CTA reads the table
//   entries of its tiles before its copies, and a tile's scale columns
//   travel with it;
// - products on tensor cores (mma.sync m16n8k16 through ldmatrix), warps
//   splitting each tile's keys, P kept in registers; the f32 arms keep
//   CUDA-core FMAs (TF32 cannot meet the f32 tolerance) on the same ring
//   and split;
// - the split covers only the slot's visible tiles: nsplit comes from the
//   shapes (slots, kv heads, table width) and the card, rounded up to
//   fill two CTAs an SM, and each CTA takes its share of the tiles from
//   its own slot's index, so a slot's result never depends on other slots
//   and no CTA idles at the steady index (a split of the table width, the
//   first design, left half its CTAs without a block);
// - the last CTA of each cell combines the splits of a one-step call (a
//   ticket), a second kernel those of a multi-step one.
// Tried and dropped: wgmma (8 query rows a kv head at the serving step,
// and wgmma computes 64); rounding the split count down (K7's choice),
// 3% slower here at the steady index.

#include "decode_mma.cuh"

namespace {

template <typename T, typename P>
int launch_k1(const void* q, const void* k_pool, const void* v_pool,
              const void* table, const void* index, const void* k_new,
              const void* v_new, const void* k_scales, const void* v_scales,
              void* m_part, void* l_part, void* acc_part, void* out,
              void* tickets, int b, int h, int kvh, int steps, int hd,
              int nlog, int nsplit, int chunk, float scale, void* stream) {
  if (hd % (16 / static_cast<int>(sizeof(P))) != 0 ||
      (std::is_same<P, int8_t>::value && k_scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{};
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.index = static_cast<const int32_t*>(index);
  a.table = static_cast<const int32_t*>(table);
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.m_part = static_cast<float*>(m_part);
  a.l_part = static_cast<float*>(l_part);
  a.acc_part = static_cast<float*>(acc_part);
  a.out = out;
  a.tickets = static_cast<int*>(tickets);
  a.b = b;
  a.h = h;
  a.kvh = kvh;
  a.steps = steps;
  a.hd = hd;
  a.S = nlog * kPageRows;
  a.nlog = nlog;
  a.per_row = 1;
  a.chunk = chunk;
  a.scale = scale;
  return launch_decode<T, P, true, true, 64>(a, nsplit, stream);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launches (0 = ok).
// m_part / l_part: [b, kvh, nsplit, rows] f32 and acc_part: [b, kvh,
// nsplit, rows, hd] f32 are scratch the caller allocates; a CTA holds
// `chunk` of the rows = group * steps query rows of a kv head. tickets as
// in decode_attention.cu. k_scales /
// v_scales: the f32 [nb, kvh, 128] scale pools of a quantized pool, or
// null. The `_i8_` entry points take int8 pools (scales required); the
// others pools in q's type.
#define PAGED_ATTENTION_ENTRY(NAME, T, P)                                      \
  int NAME(const void* q, const void* k_pool, const void* v_pool,              \
           const void* table, const void* index, const void* k_new,            \
           const void* v_new, const void* k_scales, const void* v_scales,      \
           void* m_part, void* l_part, void* acc_part, void* out,              \
           void* tickets, int b, int h, int kvh, int steps, int hd, int nlog,  \
           int nsplit, int chunk, float scale, void* stream) {                 \
    return launch_k1<T, P>(q, k_pool, v_pool, table, index, k_new, v_new,      \
                           k_scales, v_scales, m_part, l_part, acc_part, out,  \
                           tickets, b, h, kvh, steps, hd, nlog, nsplit, chunk, \
                           scale, stream);                                     \
  }

PAGED_ATTENTION_ENTRY(paged_attention_bf16, bf16, bf16)
PAGED_ATTENTION_ENTRY(paged_attention_f32, float, float)
PAGED_ATTENTION_ENTRY(paged_attention_i8_bf16, bf16, int8_t)
PAGED_ATTENTION_ENTRY(paged_attention_i8_f32, float, int8_t)

}  // extern "C"
