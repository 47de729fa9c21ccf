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
// by every row or one value per row (ragged decoding). Tiles wholly past
// index + steps - 1 are never read; the visible range is clamped to the
// cache, so a row whose index runs past S (a freed serving slot that
// keeps stepping) reads the whole cache and never past it. S need not be
// a multiple of the tile: the partial last tile is masked.
//
// Numerics follow _stream_fold: f32 scores, running max / sum and
// accumulator; masked scores are -1e30 (not -inf); the softmax scale
// multiplies the f32 scores (q is never pre-scaled in the storage type);
// probabilities round to the cache's type before the PV product, while
// the running sum keeps them in f32.
//
// What bounds it on an H100: bytes. A step reads each visible K/V byte
// once for g*steps query rows, ~2*g*steps FLOPs per byte, far below the
// ~295 FLOP/byte where the tensor cores would set the pace; the floor is
// the visible K/V bytes over 3.35 TB/s.
//
// What the design does about it (the design of K1, paged_attention.cu,
// with direct strided addressing in place of the block table):
// - one CTA per (batch row, kv head, row chunk, split): each K/V tile is
//   loaded from device memory once, with 16-byte loads, into shared
//   memory and serves up to 64 query rows of the GQA group. A group of
//   more rows (a wide group at a multi-step verify) takes more chunks, in
//   the grid's y dimension, each re-reading the tiles; the caller sizes
//   a chunk so that its tiles fit shared memory. A head_dim whose row is
//   not a multiple of 16 bytes loads element by element (a template
//   switch);
// - the tile loop is split across `nsplit` CTAs of `tps` consecutive
//   64-row tiles (flash-decoding): rows * kv heads CTAs alone (32 at
//   TinyLlama's generate shape) would leave most of the 132 SMs idle. A
//   second kernel combines the splits' (max, sum, accumulator) in split
//   order. The split comes from the shapes alone, never from the index,
//   so a row's result does not depend on the other rows;
// - the index stays on the device: every CTA reads it and exits its tile
//   loop at once when its tiles lie past the visible range (such a split
//   reports l = 0, m = -1e30 and weighs exactly 0 in the combine);
// - K/V tile rows are padded so the score loop's strided shared-memory
//   reads do not collide on one bank.
// The TPU kernel's block-diagonal two-dot formulation only fed the MXU
// and is not carried over: CUDA-core FMAs here, no mma/wgmma and no
// cp.async/TMA pipelining (later work if the time stays far above the
// byte bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // cache rows per streamed tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <typename T> struct Pad;  // shared-memory row padding, elements
template <> struct Pad<float> { static constexpr int value = 1; };
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 2; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Partial results of one (row chunk, split): running max and sum per query
// row and the unnormalised accumulator, f32. kVec: 16-byte K/V loads (hd a
// multiple of 16 bytes), else element by element.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) decode_attention_split_kernel(
    const T* __restrict__ q,             // [b, h, steps, hd]
    const T* __restrict__ k,             // [b, kvh, S, hd]
    const T* __restrict__ v,             // [b, kvh, S, hd]
    const int32_t* __restrict__ index,   // [b] (per_row) or [1]
    float* __restrict__ m_part,          // [b, kvh, nsplit, rows]
    float* __restrict__ l_part,          // [b, kvh, nsplit, rows]
    float* __restrict__ acc_part,        // [b, kvh, nsplit, rows, hd]
    int h, int kvh, int steps, int hd, int S, int tps, int per_row,
    int chunk, float scale) {
  constexpr int kPad = Pad<T>::value;
  const int nchunk = gridDim.y / kvh;
  const int row_b = blockIdx.x;
  const int kh = blockIdx.y / nchunk;
  const int r0 = (blockIdx.y % nchunk) * chunk;  // the chunk's first row
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int g = h / kvh;
  const int rows_all = g * steps;
  const int rows = min(chunk, rows_all - r0);
  const int ks = hd + kPad;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  extern __shared__ float smem[];
  // Indexed by the chunk's rows, r = 0 .. rows - 1 (query row r0 + r).
  float* q_s = smem;                    // [rows, hd]
  float* s_s = q_s + rows * hd;         // [rows, kTile] scores, then p
  float* acc = s_s + rows * kTile;      // [rows, hd]
  float* m_s = acc + rows * hd;         // [rows] running max
  float* l_s = m_s + rows;              // [rows] running sum
  float* a_s = l_s + rows;              // [rows] this tile's rescale
  T* k_s = reinterpret_cast<T*>(a_s + rows);  // [kTile, ks]
  T* v_s = k_s + kTile * ks;                  // [kTile, ks]

  // The rows of one kv head are contiguous in q: heads kh*g .. kh*g+g-1,
  // each `steps` rows, i.e. (group, step) order.
  const size_t qbase = ((static_cast<size_t>(row_b) * h +
                         static_cast<size_t>(kh) * g) * steps + r0) * hd;
  for (int e = tid; e < rows * hd; e += blockDim.x) {
    q_s[e] = to_f(q[qbase + e]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < rows; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const long long idx = index[per_row ? row_b : 0];
  const long long top = idx + steps - 1;  // highest query position
  const long long ntiles = (S + kTile - 1) / kTile;
  const int nvis = static_cast<int>(
      top / kTile + 1 < ntiles ? top / kTile + 1 : ntiles);
  const int j0 = split * tps;
  const int j1 = min(j0 + tps, nvis);
  const size_t cbase = (static_cast<size_t>(row_b) * kvh + kh) *
                       static_cast<size_t>(S) * hd;
  constexpr int kElems = 16 / sizeof(T);  // elements per 16-byte load

  for (int j = j0; j < j1; ++j) {
    const int row0 = j * kTile;
    const int nrows = min(kTile, S - row0);
    __syncthreads();  // the previous tile's readers are done
    if constexpr (kVec) {
      for (int e = tid * kElems; e < kTile * hd; e += blockDim.x * kElems) {
        const int c = e / hd;  // hd % kElems == 0: one row per vector
        const int d0 = e - c * hd;
        uint4 ku = make_uint4(0u, 0u, 0u, 0u);
        uint4 vu = ku;
        if (c < nrows) {
          const size_t off = cbase + static_cast<size_t>(row0 + c) * hd + d0;
          ku = *reinterpret_cast<const uint4*>(k + off);
          vu = *reinterpret_cast<const uint4*>(v + off);
        }
        const T* kv = reinterpret_cast<const T*>(&ku);
        const T* vv = reinterpret_cast<const T*>(&vu);
#pragma unroll
        for (int u = 0; u < kElems; ++u) {
          k_s[c * ks + d0 + u] = kv[u];
          v_s[c * ks + d0 + u] = vv[u];
        }
      }
    } else {
      for (int e = tid; e < kTile * hd; e += blockDim.x) {
        const int c = e / hd;
        const int d = e - c * hd;
        T kx = from_f<T>(0.f), vx = kx;
        if (c < nrows) {
          const size_t off = cbase + static_cast<size_t>(row0 + c) * hd + d;
          kx = k[off];
          vx = v[off];
        }
        k_s[c * ks + d] = kx;
        v_s[c * ks + d] = vx;
      }
    }
    __syncthreads();
    for (int e = tid; e < rows * kTile; e += blockDim.x) {
      const int r = e / kTile;
      const int c = e - r * kTile;
      const long long pos = static_cast<long long>(row0) + c;
      float s = kNegInf;
      // The mask is per (row, step): (r0 + r) % steps is the query's step.
      if (c < nrows && pos <= idx + ((r0 + r) % steps)) {
        const float* qr = q_s + r * hd;
        const T* kr = k_s + c * ks;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], to_f(kr[d]), dot);
        s = dot * scale;
      }
      s_s[e] = s;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += nwarps) {
      float* sr = s_s + r * kTile;
      float mx = kNegInf;
      for (int c = lane; c < kTile; c += 32) mx = fmaxf(mx, sr[c]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < kTile; c += 32) {
        // A masked score contributes exactly 0, also while every
        // position this split has seen is masked for the row.
        const float p = sr[c] <= kNegInf ? 0.f : expf(sr[c] - m_new);
        sum += p;
        sr[c] = to_f(from_f<T>(p));  // the PV product's operand type
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
    for (int e = tid; e < rows * hd; e += blockDim.x) {
      const int r = e / hd;
      const int d = e - r * hd;
      const float* pr = s_s + r * kTile;
      float pv = 0.f;
      for (int c = 0; c < kTile; ++c)
        pv = fmaf(pr[c], to_f(v_s[c * ks + d]), pv);
      acc[e] = acc[e] * a_s[r] + pv;
    }
  }
  __syncthreads();
  const size_t cell =
      (static_cast<size_t>(row_b) * kvh + kh) * nsplit + split;
  for (int e = tid; e < rows * hd; e += blockDim.x) {
    acc_part[(cell * rows_all + r0) * hd + e] = acc[e];
  }
  for (int r = tid; r < rows; r += blockDim.x) {
    m_part[cell * rows_all + r0 + r] = m_s[r];
    l_part[cell * rows_all + r0 + r] = l_s[r];
  }
}

// Combine the splits of each (batch row, kv head) in split order, one
// thread per output element (grid z covers a cell's rows * hd outputs, so
// a cell of many query rows, as the speculative verify has, does not
// serialise its outputs over few threads). A split that saw no visible
// position for a row (m = -1e30, l = 0) is skipped: its weight is exactly
// 0, never exp(NaN).
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_combine_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, T* __restrict__ out,
    int h, int kvh, int steps, int hd, int nsplit) {
  const int row_b = blockIdx.x;
  const int kh = blockIdx.y;
  const int rows = (h / kvh) * steps;
  const int e = blockIdx.z * blockDim.x + threadIdx.x;
  if (e >= rows * hd) return;
  const int r = e / hd;
  const size_t cell0 = (static_cast<size_t>(row_b) * kvh + kh) * nsplit;
  const size_t obase = (static_cast<size_t>(row_b) * h +
                        static_cast<size_t>(kh) * (h / kvh)) * steps * hd;
  float m = kNegInf;
#pragma unroll 4
  for (int s = 0; s < nsplit; ++s)
    m = fmaxf(m, m_part[(cell0 + s) * rows + r]);
  float l = 0.f;
  float a = 0.f;
#pragma unroll 4
  for (int s = 0; s < nsplit; ++s) {
    const float ms = m_part[(cell0 + s) * rows + r];
    if (ms <= kNegInf) continue;  // no visible position in this split
    const float w = expf(ms - m);
    l += l_part[(cell0 + s) * rows + r] * w;
    a += acc_part[(cell0 + s) * rows * hd + e] * w;
  }
  out[obase + e] = from_f<T>(a / l);
}

// Shared memory of a CTA holding `rows` query rows; the caller
// (ops/decode_attention.py, _k7_smem_bytes) sizes a chunk by the same sum.
template <typename T>
size_t smem_bytes(int rows, int hd) {
  return static_cast<size_t>(2 * rows * hd + rows * kTile + 3 * rows) *
             sizeof(float) +
         static_cast<size_t>(2 * kTile * (hd + Pad<T>::value)) * sizeof(T);
}

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a CTA may have

template <typename T, bool kVec>
int launch_split(const void* q, const void* k, const void* v,
                 const void* index, void* m_part, void* l_part,
                 void* acc_part, int b, int h, int kvh, int steps, int hd,
                 int S, int tps, int nsplit, int per_row, int chunk,
                 float scale, cudaStream_t st) {
  const size_t smem = smem_bytes<T>(chunk, hd);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // Raise the kernel's shared-memory cap only when a larger shape needs
  // it, so repeated launches (and CUDA graph capture) make no attribute
  // call. Single device, single host thread per process. A failure is
  // cleared so that it does not leak into the next launch's
  // cudaGetLastError().
  static size_t smem_cap = 0;
  if (smem > smem_cap) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_split_kernel<T, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    smem_cap = smem;
  }
  const int nchunk = ((h / kvh) * steps + chunk - 1) / chunk;
  decode_attention_split_kernel<T, kVec>
      <<<dim3(b, kvh * nchunk, nsplit), kThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int32_t*>(index),
          static_cast<float*>(m_part), static_cast<float*>(l_part),
          static_cast<float*>(acc_part), h, kvh, steps, hd, S, tps, per_row,
          chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* index,
           void* m_part, void* l_part, void* acc_part, void* out, int b,
           int h, int kvh, int steps, int hd, int S, int tps, int nsplit,
           int per_row, int chunk, float scale, void* stream) {
  if (hd < 1 || hd > 256 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (hd * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  const int err =
      vec ? launch_split<T, true>(q, k, v, index, m_part, l_part, acc_part, b,
                                  h, kvh, steps, hd, S, tps, nsplit, per_row,
                                  chunk, scale, st)
          : launch_split<T, false>(q, k, v, index, m_part, l_part, acc_part,
                                   b, h, kvh, steps, hd, S, tps, nsplit,
                                   per_row, chunk, scale, st);
  if (err != 0) return err;
  const int rows = (h / kvh) * steps;
  const int zblocks = (rows * hd + kThreads - 1) / kThreads;
  decode_attention_combine_kernel<T>
      <<<dim3(b, kvh, zblocks), kThreads, 0, st>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out), h, kvh,
      steps, hd, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launches (0 = ok).
// m_part / l_part: [b, kvh, nsplit, rows] f32 and acc_part: [b, kvh,
// nsplit, rows, hd] f32 are scratch the caller allocates; split z covers
// 64-row tiles [z * tps, (z + 1) * tps); a CTA holds `chunk` of the rows
// = group * steps query rows of a kv head. index holds b values when
// per_row is set, else one.
int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* index, void* m_part, void* l_part,
                          void* acc_part, void* out, int b, int h, int kvh,
                          int steps, int hd, int S, int tps, int nsplit,
                          int per_row, int chunk, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, index, m_part, l_part, acc_part, out,
                               b, h, kvh, steps, hd, S, tps, nsplit, per_row,
                               chunk, scale, stream);
}

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* index, void* m_part, void* l_part,
                         void* acc_part, void* out, int b, int h, int kvh,
                         int steps, int hd, int S, int tps, int nsplit,
                         int per_row, int chunk, float scale, void* stream) {
  return launch<float>(q, k, v, index, m_part, l_part, acc_part, out, b, h,
                       kvh, steps, hd, S, tps, nsplit, per_row, chunk, scale,
                       stream);
}

}  // extern "C"
