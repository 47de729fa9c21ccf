// Paged decode attention over a shared pool of 128-row K/V blocks.
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
// Numerics follow _stream_fold: f32 running max / sum / accumulator,
// masked scores are -1e30 (not -inf), the softmax scale multiplies the
// f32 scores (q is never pre-scaled in the storage type).
//
// Quantized pools (_stream_fold's `ks` / `vs` seam, and _fused_stream_kernel
// at decode_attention.py:965-1000): with k_scales / v_scales given
// ([nb, kvh, 128] f32, indexed by the same table entry as the block), the
// score of column c is dot(q, k_c) * hd^-0.5 * ks[c], the running sum takes
// the unscaled p, and the PV product takes p * vs[c]. An int8 pool
// (the `_i8_` entry points) converts each tile to q's type in shared
// memory, losslessly (|k| <= 127); injected fresh rows stay in q's type and
// their scale columns are exactly 1.0, so whatever the scale pools hold at
// the write positions never reaches the output. A "sim" pool (q's type,
// unit scales) runs the same code: x * 1.0 is exact and nothing else
// changes order, so it matches the unquantized arm bit for bit.
//
// What bounds it on an H100: bytes. A decode step reads each resident
// K/V byte once for g*steps query rows and does ~2*g*steps FLOPs per
// byte, far below the ~295 FLOP/byte where the tensor cores would limit;
// the floor is resident K/V bytes over 3.35 TB/s. An int8 pool halves
// those bytes (plus 4 scale bytes per row and head), and its 16-byte loads
// carry 16 elements instead of 8.
//
// What the design does about it:
// - one CTA per (slot, kv head, split): each K/V byte of a block tile is
//   loaded from device memory once, with 16-byte loads, into shared
//   memory and serves every query row of the GQA group (the TPU kernel's
//   KV-head packing);
// - the TPU grid walked a slot's blocks one after another; on Hopper that
//   leaves slots * kv_heads CTAs (32 at TinyLlama width) for 132 SMs, so
//   the block loop is split across `nsplit` CTAs of `bps` consecutive
//   logical blocks each (flash-decoding), and a second kernel combines
//   the per-split (max, sum, accumulator) in split order. The split is
//   chosen from the shapes alone (slots, kv heads, table width), so a
//   slot's result never depends on other slots;
// - K/V tile rows are padded by two elements so the score loop's strided
//   shared-memory reads do not collide on one bank.
// Still CUDA-core FMAs, and no cp.async/TMA double buffering: the next
// steps if the measured time stays far above the byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPage = 128;     // rows per physical block (PAGE_ROWS)
constexpr int kThreads = 128;
constexpr int kPad = 2;        // shared-memory row padding of K/V tiles
constexpr float kNegInf = -1e30f;

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
// A pool element in the compute type T: the identity for a T pool, a
// lossless conversion for an int8 one.
template <typename T> __device__ __forceinline__ T to_t(T x) { return x; }
template <typename T> __device__ __forceinline__ T to_t(int8_t x) {
  return from_f<T>(static_cast<float>(x));
}

// Partial results of one split: running max and sum per query row and
// the unnormalised accumulator, f32. T: q's type; P: the pool's (T or
// int8_t).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) paged_attention_split_kernel(
    const T* __restrict__ q,        // [b, h, steps, hd]
    const P* __restrict__ k_pool,   // [nb, kvh, kPage, hd]
    const P* __restrict__ v_pool,   // [nb, kvh, kPage, hd]
    const int32_t* __restrict__ table,  // [b, nlog]
    const int32_t* __restrict__ index,  // [b]
    const T* __restrict__ k_new,    // [b, kvh, steps, hd] or nullptr
    const T* __restrict__ v_new,    // [b, kvh, steps, hd] or nullptr
    const float* __restrict__ k_scales,  // [nb, kvh, kPage] or nullptr
    const float* __restrict__ v_scales,  // [nb, kvh, kPage] or nullptr
    float* __restrict__ m_part,     // [b, kvh, nsplit, rows]
    float* __restrict__ l_part,     // [b, kvh, nsplit, rows]
    float* __restrict__ acc_part,   // [b, kvh, nsplit, rows, hd]
    int h, int kvh, int steps, int hd, int nlog, int bps, float scale) {
  const int slot = blockIdx.x;
  const int kh = blockIdx.y;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int g = h / kvh;
  const int rows = g * steps;
  const int ks = hd + kPad;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                    // [rows, hd]
  float* s_s = q_s + rows * hd;         // [rows, kPage] scores, then p
  float* acc = s_s + rows * kPage;      // [rows, hd]
  float* m_s = acc + rows * hd;         // [rows] running max
  float* l_s = m_s + rows;              // [rows] running sum
  float* a_s = l_s + rows;              // [rows] this block's rescale
  float* ksc = a_s + rows;              // [kPage] this block's K scales
  float* vsc = ksc + kPage;             // [kPage] this block's V scales
  T* k_s = reinterpret_cast<T*>(vsc + kPage);  // [kPage, ks]
  T* v_s = k_s + kPage * ks;                  // [kPage, ks]

  // The rows of one kv head are contiguous: heads kh*g .. kh*g+g-1, each
  // `steps` rows, i.e. (group, step) order.
  const size_t qbase = (static_cast<size_t>(slot) * h +
                        static_cast<size_t>(kh) * g) * steps * hd;
  for (int e = tid; e < rows * hd; e += blockDim.x) {
    q_s[e] = to_f(q[qbase + e]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < rows; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const long long idx = index[slot];
  const long long top = idx + steps - 1;  // highest query position
  const int nblk = static_cast<int>(
      top / kPage + 1 < nlog ? top / kPage + 1 : nlog);
  const int j0 = split * bps;
  const int j1 = min(j0 + bps, nblk);
  const int32_t* trow = table + static_cast<size_t>(slot) * nlog;
  const bool inject = k_new != nullptr;
  const bool scaled = k_scales != nullptr;
  constexpr int kVec = 16 / sizeof(P);  // pool elements per 16-byte load

  for (int j = j0; j < j1; ++j) {
    const size_t sbase = (static_cast<size_t>(trow[j]) * kvh + kh) * kPage;
    const size_t pbase = sbase * hd;
    __syncthreads();  // the previous block's readers are done
    if (scaled) {
      for (int c = tid; c < kPage; c += blockDim.x) {
        const long long t = static_cast<long long>(j) * kPage + c - idx;
        const bool fresh = inject && t >= 0 && t < steps;
        ksc[c] = fresh ? 1.f : k_scales[sbase + c];
        vsc[c] = fresh ? 1.f : v_scales[sbase + c];
      }
    }
    for (int e = tid * kVec; e < kPage * hd; e += blockDim.x * kVec) {
      const uint4 ku = *reinterpret_cast<const uint4*>(k_pool + pbase + e);
      const uint4 vu = *reinterpret_cast<const uint4*>(v_pool + pbase + e);
      const P* kv = reinterpret_cast<const P*>(&ku);
      const P* vv = reinterpret_cast<const P*>(&vu);
      // hd % kVec == 0 (16 int8, 8 bf16 or 4 f32 elements): one row per
      // vector.
      const int c = e / hd;
      const int d0 = e - c * hd;
      const long long t = static_cast<long long>(j) * kPage + c - idx;
      if (inject && t >= 0 && t < steps) {
        const size_t o = ((static_cast<size_t>(slot) * kvh + kh) * steps +
                          static_cast<size_t>(t)) * hd + d0;
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          k_s[c * ks + d0 + u] = k_new[o + u];
          v_s[c * ks + d0 + u] = v_new[o + u];
        }
      } else {
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          k_s[c * ks + d0 + u] = to_t<T>(kv[u]);
          v_s[c * ks + d0 + u] = to_t<T>(vv[u]);
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < rows * kPage; e += blockDim.x) {
      const int r = e / kPage;
      const int c = e - r * kPage;
      const long long pos = static_cast<long long>(j) * kPage + c;
      float s = kNegInf;
      if (pos <= idx + (r % steps)) {
        const float* qr = q_s + r * hd;
        const T* kr = k_s + c * ks;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], to_f(kr[d]), dot);
        s = dot * scale;
        if (scaled) s *= ksc[c];  // per-row K dequant on the f32 score
      }
      s_s[e] = s;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += nwarps) {
      float* sr = s_s + r * kPage;
      float mx = kNegInf;
      for (int c = lane; c < kPage; c += 32) mx = fmaxf(mx, sr[c]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < kPage; c += 32) {
        // A masked score contributes exactly 0, also while every
        // position this split has seen is masked for the row.
        const float p = sr[c] <= kNegInf ? 0.f : expf(sr[c] - m_new);
        sr[c] = scaled ? p * vsc[c] : p;  // the sum takes p unscaled
        sum += p;
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
      const float* pr = s_s + r * kPage;
      float pv = 0.f;
      for (int c = 0; c < kPage; ++c) pv = fmaf(pr[c], to_f(v_s[c * ks + d]), pv);
      acc[e] = acc[e] * a_s[r] + pv;
    }
  }
  __syncthreads();
  const size_t cell = (static_cast<size_t>(slot) * kvh + kh) * nsplit + split;
  for (int e = tid; e < rows * hd; e += blockDim.x) {
    acc_part[cell * rows * hd + e] = acc[e];
  }
  for (int r = tid; r < rows; r += blockDim.x) {
    m_part[cell * rows + r] = m_s[r];
    l_part[cell * rows + r] = l_s[r];
  }
}

// Combine the splits of each (slot, kv head) in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_combine_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, T* __restrict__ out,
    int h, int kvh, int steps, int hd, int nsplit) {
  const int slot = blockIdx.x;
  const int kh = blockIdx.y;
  const int rows = (h / kvh) * steps;
  const size_t cell0 = (static_cast<size_t>(slot) * kvh + kh) * nsplit;
  const size_t obase = (static_cast<size_t>(slot) * h +
                        static_cast<size_t>(kh) * (h / kvh)) * steps * hd;
  for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
    const int r = e / hd;
    float m = kNegInf;
    for (int s = 0; s < nsplit; ++s)
      m = fmaxf(m, m_part[(cell0 + s) * rows + r]);
    float l = 0.f;
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float ms = m_part[(cell0 + s) * rows + r];
      if (ms <= kNegInf) continue;  // no visible position in this split
      const float w = expf(ms - m);
      l += l_part[(cell0 + s) * rows + r] * w;
      a += acc_part[(cell0 + s) * rows * hd + e] * w;
    }
    out[obase + e] = from_f<T>(a / l);
  }
}

template <typename T>
size_t smem_bytes(int rows, int hd) {
  return static_cast<size_t>(2 * rows * hd + rows * kPage + 3 * rows +
                             2 * kPage) *
             sizeof(float) +
         static_cast<size_t>(2 * kPage * (hd + kPad)) * sizeof(T);
}

template <typename T, typename P>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* index, const void* k_new,
           const void* v_new, const void* k_scales, const void* v_scales,
           void* m_part, void* l_part, void* acc_part, void* out, int b,
           int h, int kvh, int steps, int hd, int nlog, int bps, int nsplit,
           float scale, void* stream) {
  const size_t smem = smem_bytes<T>((h / kvh) * steps, hd);
  // Raise the kernel's shared-memory cap only when a larger shape needs
  // it, so repeated launches (and CUDA graph capture) make no attribute
  // call. Single device, single host thread per process. A shape past
  // the card's per-block cap (too many query rows per kv head) fails
  // here; the error is cleared so that it does not leak into the next
  // launch's cudaGetLastError().
  static size_t smem_cap = 0;
  cudaError_t err = cudaSuccess;
  if (smem > smem_cap) {
    err = cudaFuncSetAttribute(paged_attention_split_kernel<T, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    smem_cap = smem;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  paged_attention_split_kernel<T, P><<<dim3(b, kvh, nsplit), kThreads, smem,
                                       st>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(index), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part), h, kvh,
      steps, hd, nlog, bps, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attention_combine_kernel<T><<<dim3(b, kvh), kThreads, 0, st>>>(
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
// logical blocks [z * bps, (z + 1) * bps). k_scales / v_scales: the f32
// [nb, kvh, 128] scale pools of a quantized pool, or null. The `_i8_`
// entry points take int8 pools (scales required); the others pools in
// q's type.
#define PAGED_ATTENTION_ENTRY(NAME, T, P)                                     \
  int NAME(const void* q, const void* k_pool, const void* v_pool,             \
           const void* table, const void* index, const void* k_new,           \
           const void* v_new, const void* k_scales, const void* v_scales,     \
           void* m_part, void* l_part, void* acc_part, void* out, int b,      \
           int h, int kvh, int steps, int hd, int nlog, int bps, int nsplit,  \
           float scale, void* stream) {                                       \
    return launch<T, P>(q, k_pool, v_pool, table, index, k_new, v_new,       \
                        k_scales, v_scales, m_part, l_part, acc_part, out, b, \
                        h, kvh, steps, hd, nlog, bps, nsplit, scale, stream); \
  }

PAGED_ATTENTION_ENTRY(paged_attention_bf16, __nv_bfloat16, __nv_bfloat16)
PAGED_ATTENTION_ENTRY(paged_attention_f32, float, float)
PAGED_ATTENTION_ENTRY(paged_attention_i8_bf16, __nv_bfloat16, int8_t)
PAGED_ATTENTION_ENTRY(paged_attention_i8_f32, float, int8_t)

}  // extern "C"
