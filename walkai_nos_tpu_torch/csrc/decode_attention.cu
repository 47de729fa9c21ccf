// Decode attention over a dense per-sequence KV cache (K7).
//
// Replaces: walkai_nos_tpu/ops/decode_attention.py:_gqa_pallas and its
// body _gqa_stream_kernel -> _stream_fold (the TPU kernel of the dense
// decode step: one-shot generation, speculative verify, and the dense
// serving engine).
//
// What it computes: for each batch row b and each kv head, the g*steps
// query rows of that kv head (row order (group, step), g = heads /
// kv_heads) attend over the cache k/v[b, kv head, 0:S, :]. Any group, any
// steps and any head_dim up to 256, as _gqa_pallas takes them. Query row of
// step t sees positions p <= index + t, where index is one scalar shared
// by every row or one value per row (ragged decoding), read on the device.
// Tiles wholly past index + steps - 1 are never read; the visible range is
// clamped to the cache, so a row whose index runs past S (a freed serving
// slot that keeps stepping) reads the whole cache and never past it. S
// need not be a multiple of the tile: the partial last tile is masked.
// Numerics follow _stream_fold (see decode_mma.cuh): probabilities round to
// the cache's type before the PV product, the running sum keeps them f32.
//
// What bounds it on an H100: bytes. A step reads each visible K/V byte
// once for g*steps query rows, ~2*g*steps FLOPs per byte, far below the
// ~295 FLOP/byte where the tensor cores would set the pace; the floor is
// the visible K/V bytes over 3.35 TB/s (8.3 MB, 2.5 us at TinyLlama's
// generate step). At that size the latency of each CTA's chain weighs as
// much as the bytes, and so does the load of the busiest SM. The design:
// - the body of decode_mma.cuh (shared with K1, paged_attention.cu):
//   products on tensor cores (mma.sync m16n8k16, ldmatrix), 64-key tiles
//   through a three-stage cp.async ring, warps splitting each tile's keys
//   and merging once at the end; up to 64 query rows a CTA, a wider group
//   (a wide verify) in more row chunks, each re-reading the tiles;
// - the split covers only the row's visible tiles (nsplit from the
//   shapes, each CTA's share from its own row's index on the device), so
//   every CTA of a half-full cache has work; nsplit is rounded down to at
//   most two CTAs an SM, so that no SM carries a third CTA of two tiles
//   (rounding up, K1's choice, was 8% slower at the generate step);
// - the last CTA of each cell combines the splits of a one-step call (a
//   ticket), a second kernel those of a verify;
// - a row whose bytes are not a multiple of 16 (head_dim 36 in bf16) or a
//   cache not 16-byte aligned loads element by element (a template
//   switch); the f32 arm keeps CUDA-core FMAs (TF32 cannot meet the f32
//   tolerance) on 32-key tiles and a two-stage ring.
// Tried and dropped: the TPU kernel's block-diagonal two-dot formulation
// (it only fed the MXU); wgmma (a kv head has 8 query rows at every main
// path shape, and wgmma computes 64); more splits (three or four CTAs an
// SM: more partials, no gain).

#include "decode_mma.cuh"

namespace {

template <typename T>
int launch_k7(const void* q, const void* k, const void* v, const void* index,
              void* m_part, void* l_part, void* acc_part, void* out,
              void* tickets, int b, int h, int kvh, int steps, int hd, int S,
              int nsplit, int per_row, int chunk, float scale, void* stream) {
  DecodeArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.index = static_cast<const int32_t*>(index);
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
  a.S = S;
  a.per_row = per_row;
  a.chunk = chunk;
  a.scale = scale;
  const bool vec = (hd * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  return vec ? launch_decode<T, T, false, true, 32>(a, nsplit, stream)
             : launch_decode<T, T, false, false, 32>(a, nsplit, stream);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launches (0 = ok).
// m_part / l_part: [b, kvh, nsplit, rows] f32 and acc_part: [b, kvh,
// nsplit, rows, hd] f32 are scratch the caller allocates; a CTA holds
// `chunk` of the rows = group * steps query rows of a kv head. tickets
// (bf16, a chunk of at most 512 outputs): [b, kvh, nchunk] int32 zeros the
// call leaves zero, the last CTA of each cell combining; or null, a second
// kernel combining. index holds b values when per_row is set, else one.
int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* index, void* m_part, void* l_part,
                          void* acc_part, void* out, void* tickets, int b,
                          int h, int kvh, int steps, int hd, int S, int nsplit,
                          int per_row, int chunk, float scale, void* stream) {
  return launch_k7<bf16>(q, k, v, index, m_part, l_part, acc_part, out,
                         tickets, b, h, kvh, steps, hd, S, nsplit, per_row,
                         chunk, scale, stream);
}

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* index, void* m_part, void* l_part,
                         void* acc_part, void* out, void* tickets, int b, int h,
                         int kvh, int steps, int hd, int S, int nsplit,
                         int per_row, int chunk, float scale, void* stream) {
  return launch_k7<float>(q, k, v, index, m_part, l_part, acc_part, out,
                          tickets, b, h, kvh, steps, hd, S, nsplit, per_row,
                          chunk, scale, stream);
}

}  // extern "C"
