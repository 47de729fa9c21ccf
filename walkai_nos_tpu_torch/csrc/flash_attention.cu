// Full-sequence attention forward: K3 (packed ViT attention) and K4 (flash
// forward with logsumexp), one templated body.
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
// Semantics (the JAX kernel's, plus the edge the JAX wrapper leaves to its
// reference):
// - scores in f32: q is cast to f32 and scaled by head_dim^-0.5, then
//   dotted with the f32 keys; f32 running max, sum and accumulator; the
//   probabilities stay f32 in the PV product;
// - bottom-right causal mask: query row q sees key k iff k <= q + sk - sq;
//   keys at or past kv_len are masked too; a masked score is -1e30, not
//   -inf, as in the reference;
// - key tiles no row of a query tile can see (past the causal diagonal or
//   past kv_len) are skipped, not just masked;
// - causal with sq > sk leaves rows that see no key. The reference's
//   softmax over equal -1e30 logits gives them the mean of V over all sk
//   keys; a query tile holding such a row therefore scans every key tile,
//   and the online softmax yields exactly that mean (every masked key
//   weighs exp(0) = 1 while the row's max stays -1e30).
//
// What bounds it on an H100, at the ViT's shape (b 32, s 296, h 6, d 64,
// bf16, per layer call): K3 reads 21.8 MB and writes 7.3 MB, 8.7 us at
// 3.35 TB/s; its 4.3 GFLOP take 4.4 us of bf16 tensor-core time. So on
// paper the bytes bound it, barely; the scores never leave the chip.
//
// What the design does about it: one CTA per (batch*head, 64-row query
// tile): 960 CTAs at the ViT shape for 132 SMs, where the TPU ran one grid
// cell per image (32). K and V stream through shared memory in 64-row
// tiles, converted to f32 once per tile; each of the 256 threads computes
// a 4x4 block of scores and a 4 x (head_dim/16) block of the output, so
// every shared-memory read feeds 2-4 FMAs. Rows of shared tiles are padded
// by one float, so the strided key reads do not collide on one bank. This
// is a CUDA-core kernel: tensor cores (mma/wgmma) and cp.async/TMA
// pipelining are the next steps if its time stays far above the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;     // query rows and key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
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

// Element strides of one [batch, head, row, column] view (column stride 1).
struct Layout {
  long long sb, sh, ss;
};

struct Shape {
  int heads, sq, sk, d, kv_len, causal;
  float scale;
};

// Loads rows [row0, row0 + kBlock) of one (batch, head) view into a
// [kBlock, ld] f32 tile, times `mul`; rows past `rows` and columns past d
// are zero.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          const Layout& L, int row0, int rows,
                                          int d, float mul) {
  for (int i = threadIdx.x; i < kBlock * DMAX; i += kThreads) {
    const int r = i / DMAX;
    const int e = i % DMAX;
    const int row = row0 + r;
    float x = 0.f;
    if (row < rows && e < d) x = to_f(src[row * L.ss + e]) * mul;
    dst[r * ld + e] = x;
  }
}

// Grid: (query tiles, batch * heads). Thread (ty, tx) = (tid / 16, tid % 16)
// owns query rows ty + 16*i (i < 4), key columns tx + 16*j (j < 4) of each
// score tile and output columns tx + 16*j (j < DMAX/16). The 16 threads of
// one ty are one half-warp, so a row's reductions are four shuffles.
template <typename T, int DMAX, bool kLse>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, Layout lq, Layout lk,
    Layout lv, Layout lo, Shape sh) {
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

  const T* qb = q + bi * lq.sb + hi * lq.sh;
  const T* kb = k + bi * lk.sb + hi * lk.sh;
  const T* vb = v + bi * lv.sb + hi * lv.sh;
  load_tile<T, DMAX>(q_s, kLd, qb, lq, q0, sh.sq, sh.d, sh.scale);

  // Key range this tile scans.
  int end;
  if (sh.causal && q0 + offset < 0) {
    end = sh.sk;  // a row that sees no key: mean of V over every key
  } else {
    end = sh.kv_len;
    if (sh.causal) {
      const int q_last = min(q0 + kBlock, sh.sq) - 1;
      end = min(end, q_last + offset + 1);
    }
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
    load_tile<T, DMAX>(k_s, kLd, kb, lk, k0, sh.sk, sh.d, 1.f);
    load_tile<T, DMAX>(v_s, kLd, vb, lv, k0, sh.sk, sh.d, 1.f);
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

  T* ob = o + bi * lo.sb + hi * lo.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sh.sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int e = tx + 16 * j;
      if (e < sh.d) ob[qp * lo.ss + e] = from_f<T>(acc[i][j] * inv);
    }
    if (kLse && tx == 0)
      lse[static_cast<long long>(bh) * sh.sq + qp] = m[i] + logf(l[i]);
  }
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * kBlock * (DMAX + 1) + kBlock * (kBlock + 1));
}

template <typename T, int DMAX, bool kLse>
int launch_dmax(const void* q, const void* k, const void* v, void* o,
                void* lse, const long long* strides, int b, const Shape& sh,
                void* stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  // Raised once per instantiation, before any launch (so never during
  // CUDA graph capture). One device per process.
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DMAX, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    ready = true;
  }
  const Layout lq{strides[0], strides[1], strides[2]};
  const Layout lk{strides[3], strides[4], strides[5]};
  const Layout lv{strides[6], strides[7], strides[8]};
  const Layout lo{strides[9], strides[10], strides[11]};
  const dim3 grid((sh.sq + kBlock - 1) / kBlock, b * sh.heads);
  flash_fwd_kernel<T, DMAX, kLse>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o),
          static_cast<float*>(lse), lq, lk, lv, lo, sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const long long* strides, int b, int h, int sq, int sk, int d,
           int kv_len, int causal, float scale, void* stream) {
  if (d < 1 || d > 128 || sq < 1 || sk < 1 || kv_len < 1 || kv_len > sk)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{h, sq, sk, d, kv_len, causal, scale};
  if (d <= 64)
    return launch_dmax<T, 64, kLse>(q, k, v, o, lse, strides, b, sh, stream);
  return launch_dmax<T, 128, kLse>(q, k, v, o, lse, strides, b, sh, stream);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 = ok).
// strides: 12 int64 element strides, (batch, head, row) of q, k, v, o in
// that order; every column stride is 1. lse: [b, h, sq] f32, contiguous.
// The packed entry points take the same views (cut from the fused qkv
// tensor by the caller's strides) and write no lse.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, const long long* strides, int b, int h, int sq,
                   int sk, int d, int kv_len, int causal, float scale,
                   void* stream) {
  return launch<__nv_bfloat16, true>(q, k, v, o, lse, strides, b, h, sq, sk,
                                     d, kv_len, causal, scale, stream);
}

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, const long long* strides, int b, int h, int sq,
                  int sk, int d, int kv_len, int causal, float scale,
                  void* stream) {
  return launch<float, true>(q, k, v, o, lse, strides, b, h, sq, sk, d,
                             kv_len, causal, scale, stream);
}

int packed_attention_bf16(const void* q, const void* k, const void* v,
                          void* o, const long long* strides, int b, int h,
                          int s, int d, float scale, void* stream) {
  return launch<__nv_bfloat16, false>(q, k, v, o, nullptr, strides, b, h, s,
                                      s, d, s, 0, scale, stream);
}

int packed_attention_f32(const void* q, const void* k, const void* v, void* o,
                         const long long* strides, int b, int h, int s, int d,
                         float scale, void* stream) {
  return launch<float, false>(q, k, v, o, nullptr, strides, b, h, s, s, d, s,
                              0, scale, stream);
}

}  // extern "C"
