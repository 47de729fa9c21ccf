// Fused QKV projection + bias + rotary embedding for the decode step.
//
// Replaces: the projection half of
// walkai_nos_tpu/ops/decode_attention.py:_fused_qkv_pallas, i.e. the
// `_project` stage of _fused_stream_kernel (decode_attention.py:935-963):
// qkv = (x @ w) in f32, + bias in f32, cast to x's dtype, then RoPE in
// the HF half-split layout with f32 angles (column i pairs with column
// i + hd/2), then split into q [b, h, steps, hd] and the fresh
// k_new / v_new [b, kvh, steps, hd] rows. The attention half is
// paged_attention.cu with fresh-row injection.
//
// The int8-weight arm (the `_i8_` entry points; the TPU kernel's w_ref /
// ws_ref at decode_attention.py:942-946): w holds int8 values with a
// per-output-channel f32 scale row ws; qkv = (x @ w) in f32 * ws[n] +
// bias[n], rounded once to x's type. Each 16-byte load brings 16 weights,
// converted to f32 losslessly. A full-precision weight with ws all ones
// (the "sim" arm) matches the unquantized arm bit for bit: v * 1.0 is
// exact, and the multiply and the add are separate roundings.
//
// What bounds it on an H100: bytes. A decode step has only
// b * steps <= 64 rows, so the product does ~2 * rows FLOPs per weight
// element, and the floor is the weight read: dm * (dm + 2 * kv_dim)
// elements (10.5 MB in bf16 at TinyLlama width, 5.2 MB in int8) over
// 3.35 TB/s.
//
// What the design does about it: the TPU grid ran slots one after
// another with the weight resident in VMEM; on Hopper blocks run in
// parallel, so one block per slot would re-read the weight once per
// slot. Instead ONE launch covers all b * steps rows: a CTA owns 16 rows
// x one head's hd columns, so every weight element is read from device
// memory once per 16-row tile (once in all for decode), with 16-byte
// loads. One head's columns alone give only (h + 2 kvh) CTAs (40 at
// TinyLlama width), each streaming a long weight slab serially, so the
// k dimension is also split across `ksplit` CTAs: each writes an f32
// partial sum, and the epilogue kernel adds the partials in split order,
// applies the bias, rounds, and rotates (a head's rotary pairs meet
// inside its tile). Every output is summed in a fixed order that depends
// on the shapes alone, so a row's result never depends on which other
// rows share the launch. Still CUDA-core FMAs: wgmma / TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 16;      // output rows per CTA
constexpr int kBK = 32;      // k depth per shared-memory stage
constexpr int kMaxHd = 128;  // largest head_dim a CTA's tile holds
constexpr int kPerThread = kBM * kMaxHd / kThreads;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// partial[z, row, n] = sum over k in split z of x[row, k] * w[k, n],
// summed in increasing k. W: the weight's type (T or int8_t).
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) qkv_partial_kernel(
    const T* __restrict__ x,      // [M, K], M = b * steps
    const W* __restrict__ w,      // [K, N], N = (h + 2 * kvh) * hd
    float* __restrict__ partial,  // [ksplit, M, N]
    int M, int K, int N, int hd, int k_per_split) {
  __shared__ float xs[kBM][kBK];
  __shared__ float ws[kBK * kMaxHd];
  const int n0 = blockIdx.x * hd;
  const int m0 = blockIdx.y * kBM;
  const int z = blockIdx.z;
  const int k_begin = z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int tid = threadIdx.x;
  const int outs = kBM * hd;
  constexpr int kVec = 16 / sizeof(W);  // weights per 16-byte load

  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK;
      const int kk = e - r * kBK;
      const int row = m0 + r;
      const int col = k0 + kk;
      xs[r][kk] = (row < M && col < k_end)
                      ? to_f(x[static_cast<size_t>(row) * K + col])
                      : 0.f;
    }
    // 16-byte loads of the weight tile: rows of hd contiguous elements.
    for (int e = tid * kVec; e < kBK * hd; e += kThreads * kVec) {
      const int kk = e / hd;
      const int c = e - kk * hd;
      if (k0 + kk < k_end) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(k0 + kk) * N + n0 + c);
        const W* v = reinterpret_cast<const W*>(&u);
#pragma unroll
        for (int t = 0; t < kVec; ++t) ws[e + t] = to_f(v[t]);
      } else {
#pragma unroll
        for (int t = 0; t < kVec; ++t) ws[e + t] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < outs) {
        const int r = e / hd;
        const int c = e - r * hd;
        float a = acc[i];
        for (int kk = 0; kk < kBK; ++kk) a = fmaf(xs[r][kk], ws[kk * hd + c], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / hd;
    if (e < outs && m0 + r < M) {
      const int c = e - r * hd;
      partial[(static_cast<size_t>(z) * M + m0 + r) * N + n0 + c] = acc[i];
    }
  }
}

// Sum the partials in split order, x the weight's channel scale (int8
// weights), + bias in f32, round to the storage type (the TPU kernel's
// `.astype(x.dtype)` before rotary), rotate in
// f32, and scatter into q / k_new / v_new. The rotary angles are those of
// the TPU path's `_rope_tables` (f32: inv_freq = 1 / theta^(2i/hd),
// angle = (index + t) * inv_freq), computed here instead of read from
// precomputed tables.
template <typename T>
__global__ void __launch_bounds__(kThreads) qkv_epilogue_kernel(
    const float* __restrict__ partial,  // [ksplit, M, N]
    const T* __restrict__ bias,         // [N] or nullptr
    const float* __restrict__ wscale,   // [N] or nullptr
    const int32_t* __restrict__ index,  // [b] position of step 0
    float theta,                        // rotary base; <= 0: no rope
    T* __restrict__ q_out,              // [b, h, steps, hd]
    T* __restrict__ k_out,              // [b, kvh, steps, hd]
    T* __restrict__ v_out,              // [b, kvh, steps, hd]
    int M, int h, int kvh, int steps, int hd, int ksplit) {
  __shared__ float ys[kBM * kMaxHd];
  const int head = blockIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int N = (h + 2 * kvh) * hd;
  const int n0 = head * hd;
  const int outs = kBM * hd;
  for (int e = threadIdx.x; e < outs; e += kThreads) {
    const int r = e / hd;
    const int c = e - r * hd;
    const int row = m0 + r;
    float v = 0.f;
    if (row < M) {
      for (int z = 0; z < ksplit; ++z)
        v += partial[(static_cast<size_t>(z) * M + row) * N + n0 + c];
      if (wscale != nullptr) v = __fmul_rn(v, wscale[n0 + c]);
      if (bias != nullptr) v = __fadd_rn(v, to_f(bias[n0 + c]));
    }
    ys[e] = to_f(from_f<T>(v));
  }
  __syncthreads();
  const bool rope = theta > 0.f && head < h + kvh;
  const int half = hd / 2;
  for (int e = threadIdx.x; e < outs; e += kThreads) {
    const int r = e / hd;
    const int c = e - r * hd;
    const int row = m0 + r;
    if (row >= M) continue;
    float v = ys[e];
    const int bi = row / steps;
    const int t = row - bi * steps;
    if (rope) {
      const float rot = c < half ? -ys[e + half] : ys[e - half];
      const int i = c < half ? c : c - half;
      const float expo = __fdiv_rn(2.f * i, static_cast<float>(hd));
      const float inv_freq = __fdiv_rn(1.f, powf(theta, expo));
      const float angle = __fmul_rn(
          __fadd_rn(static_cast<float>(index[bi]), static_cast<float>(t)),
          inv_freq);
      v = __fadd_rn(__fmul_rn(v, cosf(angle)), __fmul_rn(rot, sinf(angle)));
    }
    T* dst;
    size_t o;
    if (head < h) {
      dst = q_out;
      o = ((static_cast<size_t>(bi) * h + head) * steps + t) * hd + c;
    } else if (head < h + kvh) {
      dst = k_out;
      o = ((static_cast<size_t>(bi) * kvh + (head - h)) * steps + t) * hd + c;
    } else {
      dst = v_out;
      o = ((static_cast<size_t>(bi) * kvh + (head - h - kvh)) * steps + t) *
              hd + c;
    }
    dst[o] = from_f<T>(v);
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* bias,
           const void* wscale, const void* index, float theta, void* partial,
           void* q_out, void* k_out, void* v_out, int M, int K, int h,
           int kvh, int steps, int hd, int ksplit, int k_per_split,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int heads = h + 2 * kvh;
  const int mtiles = (M + kBM - 1) / kBM;
  qkv_partial_kernel<T, W><<<dim3(heads, mtiles, ksplit), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<float*>(partial), M, K, heads * hd, hd, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  qkv_epilogue_kernel<T><<<dim3(heads, mtiles), kThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const T*>(bias),
      static_cast<const float*>(wscale), static_cast<const int32_t*>(index),
      theta,
      static_cast<T*>(q_out), static_cast<T*>(k_out), static_cast<T*>(v_out),
      M, h, kvh, steps, hd, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launches (0 = ok).
// `partial` is [ksplit, M, N] f32 scratch the caller allocates; split z
// covers k in [z * k_per_split, (z + 1) * k_per_split). `index` [b] int32
// is each slot's first position; `theta` <= 0 skips the rotary. `wscale`
// is the weight's [N] f32 channel scale row, or null. The `_i8_` entry
// points take an int8 weight (scale row required); the others a weight in
// x's type.
#define QKV_ROPE_ENTRY(NAME, T, W)                                            \
  int NAME(const void* x, const void* w, const void* bias,                    \
           const void* wscale, const void* index, float theta, void* partial, \
           void* q_out, void* k_out, void* v_out, int M, int K, int h,        \
           int kvh, int steps, int hd, int ksplit, int k_per_split,           \
           void* stream) {                                                    \
    return launch<T, W>(x, w, bias, wscale, index, theta, partial, q_out,     \
                        k_out, v_out, M, K, h, kvh, steps, hd, ksplit,        \
                        k_per_split, stream);                                 \
  }

QKV_ROPE_ENTRY(qkv_rope_bf16, __nv_bfloat16, __nv_bfloat16)
QKV_ROPE_ENTRY(qkv_rope_f32, float, float)
QKV_ROPE_ENTRY(qkv_rope_i8_bf16, __nv_bfloat16, int8_t)
QKV_ROPE_ENTRY(qkv_rope_i8_f32, float, int8_t)

}  // extern "C"
