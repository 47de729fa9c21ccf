// Attention backward: K5 (dq) and K6 (dk, dv).
//
// Replaces: walkai_nos_tpu/ops/attention.py:_flash_bwd_impl and its two
// TPU kernels, _flash_dq_kernel (K5) and _flash_dkv_kernel (K6). They run
// the backward of flash_attention, flash_attention_with_lse and, after a
// recompute of (out, lse) with K4, of flash_attention_packed (the ViT's
// training path).
//
// What they compute, per (batch, head), from q, k, v [s, d], the output's
// cotangent g = dO, the saved f32 logsumexp lse [sq] and the f32 row term
// D = rowsum(dO * O) - g_lse [sq] (the caller's PyTorch reduction):
//   S = (q k^T) * scale, P = exp(S - lse) on visible entries,
//   dP = g v^T, dS = P * (dP - D),
//   dq = dS k * scale (K5), dk = dS^T q * scale and dv = P^T g (K6).
// Visibility is the forward's: key k is visible to query row q iff
// k < kv_len and, when causal, k <= q + sk - sq. P is SELECTED to 0 off
// the visible set, never multiplied by a mask: a row with lse < ~-88 over
// a zero tail would give exp(0 - lse) = inf and inf * 0 = NaN. A row that
// sees no key (causal, sq > sk) took the mean of V over all sk keys in the
// forward; its scores were constants, so it adds 1/sk * g to every dv row
// and nothing to dq or dk, as autodiff of the reference gives.
//
// Both kernels are deterministic: every output element is summed by one
// thread in an order fixed by the shapes (tiles in order, rows in order),
// with no atomics, so gradients are bitwise identical from run to run.
//
// What bounds them on an H100, at the ViT's shape (b 32, s 296, h 6, d 64,
// bf16, per layer call): K5 moves ~36 MB and does ~6.5 GFLOP (~11 us of
// bytes, ~7 us of tensor-core time); K6 ~44 MB and ~8.6 GFLOP (~13 us and
// ~9 us). On paper, bytes.
//
// What the design does about it, and what it does not yet: as the TPU
// kernels, dq walks key tiles for one query tile (K5) and dk/dv walk query
// tiles for one key tile (K6), so no output needs a reduction across CTAs;
// K6 starts at the first query tile that can see its key tile. One CTA per
// (batch*head, 64-row tile), 256 threads, each owning a 4x4 score block and
// a 4 x (head_dim/16) output block, operands converted to f32 once in
// shared memory. CUDA-core FMAs; tensor cores and cp.async/TMA pipelining
// are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr int kThreads = 256;

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

struct Layout {
  long long sb, sh, ss;
};

struct Shape {
  int heads, sq, sk, d, kv_len, causal;
  float scale;
};

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

// K5. Grid: (query tiles, batch * heads).
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ dcap, T* __restrict__ dq, Layout lq, Layout lk,
    Layout lv, Layout lg, Layout ldq, Shape sh) {
  constexpr int kLd = DMAX + 1;
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* g_s = q_s + kBlock * kLd;
  float* k_s = g_s + kBlock * kLd;
  float* v_s = k_s + kBlock * kLd;
  float* ds_s = v_s + kBlock * kLd;  // [kBlock, kBlock + 1]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.y;
  const int bi = bh / sh.heads;
  const int hi = bh % sh.heads;
  const int q0 = blockIdx.x * kBlock;
  const int offset = sh.sk - sh.sq;

  load_tile<T, DMAX>(q_s, kLd, q + bi * lq.sb + hi * lq.sh, lq, q0, sh.sq,
                     sh.d);
  load_tile<T, DMAX>(g_s, kLd, g + bi * lg.sb + hi * lg.sh, lg, q0, sh.sq,
                     sh.d);
  float lse_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    const long long at = static_cast<long long>(bh) * sh.sq + qp;
    lse_r[i] = qp < sh.sq ? lse[at] : 0.f;
    d_r[i] = qp < sh.sq ? dcap[at] : 0.f;
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

// K6. Grid: (key tiles, batch * heads). The thread's score block is (query
// rows ty + 16*i, keys tx + 16*j); its output block is (keys ty + 16*i,
// columns tx + 16*j).
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
  return sizeof(float) * (4 * kBlock * (DMAX + 1) + kBlock * (kBlock + 1));
}

template <int DMAX>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kBlock * (DMAX + 1) + 2 * kBlock * (kBlock + 1));
}

// Raises a kernel's dynamic shared-memory cap once, before its first
// launch (never during CUDA graph capture).
template <typename K>
int allow_smem(K kernel, size_t bytes, bool* ready) {
  if (*ready) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  *ready = true;
  return 0;
}

Layout layout(const long long* s, int i) {
  return Layout{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

bool bad_shape(int d, int sq, int sk, int kv_len) {
  return d < 1 || d > 128 || sq < 1 || sk < 1 || kv_len < 1 || kv_len > sk;
}

template <typename T, int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const void* lse, const void* dcap, void* dq,
              const long long* st, int b, const Shape& sh, void* stream) {
  static bool ready = false;
  const int err = allow_smem(flash_dq_kernel<T, DMAX>, dq_smem<DMAX>(), &ready);
  if (err) return err;
  const dim3 grid((sh.sq + kBlock - 1) / kBlock, b * sh.heads);
  flash_dq_kernel<T, DMAX>
      <<<grid, kThreads, dq_smem<DMAX>(), static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(g),
          static_cast<const float*>(lse), static_cast<const float*>(dcap),
          static_cast<T*>(dq), layout(st, 0), layout(st, 1), layout(st, 2),
          layout(st, 3), layout(st, 4), sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* dcap, void* dk, void* dv,
               const long long* st, int b, const Shape& sh, void* stream) {
  static bool ready = false;
  const int err =
      allow_smem(flash_dkv_kernel<T, DMAX>, dkv_smem<DMAX>(), &ready);
  if (err) return err;
  const dim3 grid((sh.sk + kBlock - 1) / kBlock, b * sh.heads);
  flash_dkv_kernel<T, DMAX>
      <<<grid, kThreads, dkv_smem<DMAX>(), static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(g),
          static_cast<const float*>(lse), static_cast<const float*>(dcap),
          static_cast<T*>(dk), static_cast<T*>(dv), layout(st, 0),
          layout(st, 1), layout(st, 2), layout(st, 3), layout(st, 4),
          layout(st, 5), sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq_entry(const void* q, const void* k, const void* v, const void* g,
             const void* lse, const void* dcap, void* dq, const long long* st,
             int b, int h, int sq, int sk, int d, int kv_len, int causal,
             float scale, void* stream) {
  if (bad_shape(d, sq, sk, kv_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{h, sq, sk, d, kv_len, causal, scale};
  if (d <= 64)
    return launch_dq<T, 64>(q, k, v, g, lse, dcap, dq, st, b, sh, stream);
  return launch_dq<T, 128>(q, k, v, g, lse, dcap, dq, st, b, sh, stream);
}

template <typename T>
int dkv_entry(const void* q, const void* k, const void* v, const void* g,
              const void* lse, const void* dcap, void* dk, void* dv,
              const long long* st, int b, int h, int sq, int sk, int d,
              int kv_len, int causal, float scale, void* stream) {
  if (bad_shape(d, sq, sk, kv_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{h, sq, sk, d, kv_len, causal, scale};
  if (d <= 64)
    return launch_dkv<T, 64>(q, k, v, g, lse, dcap, dk, dv, st, b, sh, stream);
  return launch_dkv<T, 128>(q, k, v, g, lse, dcap, dk, dv, st, b, sh, stream);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 = ok).
// st: int64 element strides (batch, head, row) of each tensor view, in
// argument order: q, k, v, g, dq for K5 (15 values); q, k, v, g, dk, dv
// for K6 (18 values). Column strides are 1. lse and dcap: [b, h, sq] f32,
// contiguous.
int flash_dq_bf16(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* dcap, void* dq,
                  const long long* st, int b, int h, int sq, int sk, int d,
                  int kv_len, int causal, float scale, void* stream) {
  return dq_entry<__nv_bfloat16>(q, k, v, g, lse, dcap, dq, st, b, h, sq, sk,
                                 d, kv_len, causal, scale, stream);
}

int flash_dq_f32(const void* q, const void* k, const void* v, const void* g,
                 const void* lse, const void* dcap, void* dq,
                 const long long* st, int b, int h, int sq, int sk, int d,
                 int kv_len, int causal, float scale, void* stream) {
  return dq_entry<float>(q, k, v, g, lse, dcap, dq, st, b, h, sq, sk, d,
                         kv_len, causal, scale, stream);
}

int flash_dkv_bf16(const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* dcap, void* dk, void* dv,
                   const long long* st, int b, int h, int sq, int sk, int d,
                   int kv_len, int causal, float scale, void* stream) {
  return dkv_entry<__nv_bfloat16>(q, k, v, g, lse, dcap, dk, dv, st, b, h,
                                  sq, sk, d, kv_len, causal, scale, stream);
}

int flash_dkv_f32(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* dcap, void* dk, void* dv,
                  const long long* st, int b, int h, int sq, int sk, int d,
                  int kv_len, int causal, float scale, void* stream) {
  return dkv_entry<float>(q, k, v, g, lse, dcap, dk, dv, st, b, h, sq, sk, d,
                          kv_len, causal, scale, stream);
}

}  // extern "C"
