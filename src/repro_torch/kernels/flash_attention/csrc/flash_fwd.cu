// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_attn_fwd_kernel
// (launched by flash_attention_fwd_kernel through pl.pallas_call).
//
// It computes the same function: O = softmax(scale * Q K^T + mask) V and the
// per-row logsumexp L = m + log(max(l, 1e-30)), for q (B,Sq,H,hd) and k/v
// (B,Sk,Kh,hd) in f32 or bf16.  Q K^T is taken in f32, P is rounded to V's
// dtype before the P V product, which accumulates in f32.  The mask is built
// from absolute positions: kv padding (k < Sk), causal (k <= q, top-left
// aligned, both counted from 0) and sliding window (k > q - window).  Query
// head h reads kv head h / (H / Kh); K and V are never repeated in memory.
//
// What bounds it on this card.  At the prefill shapes of the serving path
// (hd = 64, S up to a few thousand) attention does ~4*hd = 256 operations per
// q/k pair against a few bytes of traffic per row, so it is bound by
// operations, and the H100 reaches its bf16 peak only through the tensor
// cores (wgmma).  This first version does its products with f32 FMAs on the
// CUDA cores, so it is bounded by the f32 rate (67 TFLOP/s) and in practice
// by shared-memory bandwidth: every FMA pair reads two operands from shared
// memory.
//
// What the design does about it.  The TPU kernel walks a sequential 3-D grid
// and carries its running statistics in VMEM scratch across grid steps; on
// the GPU blocks run in parallel and in no order, so one thread block owns
// one (batch*head, 64-row q tile) and loops over kv tiles itself, keeping
// the running max, normaliser and accumulator in registers.  K and V tiles
// (64 rows) are staged in shared memory as f32 and each is reused by all 64
// query rows.  The kv loop covers only the tiles the causal and window bounds
// can reach, so causal prefill does about half the work of a full square.
// Q/K/V are read through their (B,S,H,hd) strides: there is no
// pad-and-transpose copy as in the reference's ops.py::_layout, and the
// ragged edge is masked here.  Tensor cores (mma/wgmma), TMA and warp
// specialisation are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface (loaded with ctypes): flash_fwd(...) returns cudaGetLastError()
// after the launch; flash_fwd_error_string(code) names it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // q rows per block
constexpr int BN = 64;       // kv rows per tile
constexpr int NT = 256;      // threads per block: 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage `rows` rows of width HD (row stride `stride` elements) into shared
// memory as f32 with leading dimension `ld`; rows at or past `valid` are 0.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t stride, int valid, float mul) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = HD / V;
  for (int idx = threadIdx.x; idx < BM * VPR; idx += NT) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * V;
    float tmp[V];
    if (r < valid) {
      load16(src + (int64_t)r * stride + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * ld + c + e] = tmp[e] * mul;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Kh, int Sq, int Sk,
                 int64_t qsb, int64_t qss, int64_t qsh,
                 int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh,
                 int64_t osb, int64_t oss, int64_t osh,
                 int causal, int window, float scale) {
  constexpr int J = HD / 16;       // output columns per thread
  constexpr int LDQ = HD + 1;      // odd strides: no bank conflicts
  constexpr int LDV = HD;
  constexpr int LDP = BN + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                    // BM x LDQ, pre-scaled
  float* Ks = Qs + BM * LDQ;           // BN x LDQ
  float* Vs = Ks + BN * LDQ;           // BN x LDV
  float* Ps = Vs + BN * LDV;           // BM x LDP

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kh = h / (H / Kh);
  const int q0 = blockIdx.x * BM;

  const T* qb = q + b * qsb + h * qsh + (int64_t)q0 * qss;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  stage<T, HD>(Qs, LDQ, qb, qss, Sq - q0, scale);

  // kv range reachable by any row of this q tile
  const int q_last = min(q0 + BM, Sq) - 1;
  int hi = causal ? min(Sk, q_last + 1) : Sk;
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = lo / BN;
  const int t_hi = (hi + BN - 1) / BN;

  float m[4], l[4], acc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BN;
    __syncthreads();   // previous tile's Ks/Vs/Ps are no longer read
    stage<T, HD>(Ks, LDQ, kb + (int64_t)k0 * kss, kss, Sk - k0, 1.f);
    stage<T, HD>(Vs, LDV, vb + (int64_t)k0 * vss, vss, Sk - k0, 1.f);
    __syncthreads();

    // S = (scale Q) K^T for rows ty + 16i, columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = round_to(p, q);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty + 16i, columns tx + 16j
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[4], vv[J];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < J; ++j) vv[j] = Vs[c * LDV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    T* orow = o + b * osb + h * osh + (int64_t)qp * oss;
#pragma unroll
    for (int j = 0; j < J; ++j) store(orow + tx + 16 * j, acc[i][j] * inv);
    if (tx == 0) lse[(int64_t)bh * Sq + qp] = m[i] + logf(lc);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Kh, int Sq, int Sk,
                   const int64_t* st, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int smem_floats = BM * (HD + 1) + BN * (HD + 1) + BN * HD +
                              BM * (BN + 1);
  constexpr int smem = smem_floats * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Kh, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, float* lse, int B, int H, int Kh, int Sq,
                     int Sk, const int64_t* st, int causal, int window,
                     float scale, cudaStream_t stream) {
#define CASE(D)                                                            \
  case D:                                                                  \
    return launch<T, D>(q, k, v, o, lse, B, H, Kh, Sq, Sk, st, causal,    \
                        window, scale, stream);
  switch (hd) {
    CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112)
    CASE(128) CASE(144) CASE(160) CASE(176) CASE(192) CASE(208) CASE(224)
    CASE(240) CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 int64 element strides,
// (batch, seq, head) for q, k, v and o in that order; the head dim is
// contiguous.  window <= 0 means no window.  Returns a cudaError_t code.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int dtype, int B, int H, int Kh, int Sq, int Sk,
              int hd, const int64_t* strides, int causal, int window,
              float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, l, B, H, Kh, Sq, Sk, strides,
                           causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, l, B, H, Kh, Sq, Sk,
                                   strides, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
