// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++:
// two kernels, K2 (dQ) and K3 (dK, dV).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention/kernel.py::_attn_bwd_dq_kernel  (K2)
//   src/repro/kernels/flash_attention/kernel.py::_attn_bwd_dkv_kernel (K3)
// (both launched by flash_attention_bwd_kernel through pl.pallas_call).
//
// They compute the same function.  For q/dO (B,Sq,H,hd), k/v (B,Sk,Kh,hd)
// in f32 or bf16 and the forward's per-row logsumexp L and D = rowsum(dO*O),
// both (B*H, Sq) f32:
//   S  = (scale Q) K^T            in f32, masked from absolute positions:
//                                 kv padding (k < Sk), causal (k <= q,
//                                 top-left aligned), window (k > q - window)
//   P  = exp(S - L)               in f32 (not rounded to V's dtype)
//   dP = dO V^T                   in f32
//   dS = P * (dP - D)
//   dQ = scale * sum_kv dS K      (K2)
//   dV = sum_q P^T dO             (K3)
//   dK = scale * sum_q dS^T Q     (K3)
// All three outputs are f32 accumulators, contiguous: dq (B,Sq,H,hd) and
// dk/dv (B,Sk,Kh,hd).  Query head h reads kv head h / (H / Kh).
//
// What bounds them on this card.  At the training shape (hd = 64, S 2048)
// K2 does 6*hd and K3 8*hd operations per admitted (q, k) pair against a
// few bytes per row, so both are bound by operations, and the H100 reaches
// its bf16 peak only through the tensor cores (wgmma).  This first version
// does its products with f32 FMAs on the CUDA cores, so it is bounded by
// the f32 rate (67 TFLOP/s) and in practice by shared-memory bandwidth:
// every FMA pair reads two operands from shared memory.
//
// What the design does about it.  The TPU kernels walk a sequential 3-D
// grid and carry their accumulators in VMEM scratch across grid steps; on
// the GPU blocks run in parallel and in no order.  So each output tile has
// exactly one owner that loops over the other axis itself, and no atomics
// are used (the backward is deterministic):
//   K2: one block per (b*h, q tile), looping over the kv tiles the causal
//       and window bounds admit (as the forward does); the dQ tile stays in
//       registers.  Blocks are issued heaviest (last q tile) first.
//   K3: one block per (b, kv head, kv tile), looping over the query heads
//       of its GQA group and, for each, over the q tiles from the first one
//       that can see the kv tile to the last within k_end + window.  dK/dV
//       are summed per kv head in registers: there is no H-sized dk/dv and
//       no group sum as at the reference's ops.py:104-106.
// Tiles of 64 rows (32 for hd > 128, to fit shared memory) are staged in
// shared memory as f32 and reused by every row of the other operand.
// Q/K/V/dO are read through their (B,S,H,hd) strides: there is no
// pad-and-transpose copy as in the reference's ops.py::_layout, and the
// ragged edges are masked here.  Tensor cores (mma/wgmma), TMA and a fused
// single-pass dQ/dK/dV are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface (loaded with ctypes): flash_bwd_dq(...) and flash_bwd_dkv(...)
// each return cudaGetLastError() after their launch;
// flash_bwd_error_string(code) names it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block: 16 x 16

// rows per tile: 64, or 32 where four 64-row f32 tiles of width hd would
// not fit the 227 KB of shared memory a block may use
template <int HD>
struct Tile {
  static constexpr int M = HD <= 128 ? 64 : 32;
};

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

// Stage ROWS rows of width HD (row stride `stride` elements) into shared
// memory as f32 with leading dimension `ld`; rows at or past `valid` are 0.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t stride, int valid, float mul) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = HD / V;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
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

__device__ __forceinline__ bool admitted(int qp, int kp, int Sk, int causal,
                                         int window) {
  bool ok = kp < Sk;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

struct Strides {           // element strides (batch, seq, head) of each input
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// ---------------------------------------------------------------- K2: dQ
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Kh, int Sq, int Sk, Strides st, int causal,
                    int window, float scale) {
  constexpr int TM = Tile<HD>::M;  // q rows per block = kv rows per tile
  constexpr int R = TM / 16;       // tile rows (and columns) per thread
  constexpr int J = HD / 16;       // dQ columns per thread
  constexpr int LD = HD + 1;       // odd strides: no bank conflicts
  constexpr int LDS = TM + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                // TM x LD, pre-scaled
  float* dOs = Qs + TM * LD;       // TM x LD
  float* Ks = dOs + TM * LD;       // TM x LD
  float* Vs = Ks + TM * LD;        // TM x LD
  float* dSs = Vs + TM * LD;       // TM x LDS

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kh = h / (H / Kh);
  // under a causal mask the last q tiles see the most kv tiles: issue them
  // first so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TM;

  stage<T, HD, TM>(Qs, LD, q + b * st.qb + h * st.qh + (int64_t)q0 * st.qs,
                   st.qs, Sq - q0, scale);
  stage<T, HD, TM>(dOs, LD,
                   dout + b * st.ob + h * st.oh + (int64_t)q0 * st.os,
                   st.os, Sq - q0, 1.f);
  float Lr[R], Dr[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty + 16 * i;
    Lr[i] = qp < Sq ? lse[(int64_t)bh * Sq + qp] : 0.f;
    Dr[i] = qp < Sq ? delta[(int64_t)bh * Sq + qp] : 0.f;
  }

  const T* kb = k + b * st.kb + kh * st.kh;
  const T* vb = v + b * st.vb + kh * st.vh;
  // kv range reachable by any row of this q tile
  const int q_last = min(q0 + TM, Sq) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = lo / TM;
  const int t_hi = (hi + TM - 1) / TM;

  float acc[R][J];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * TM;
    __syncthreads();   // the previous tile's Ks/Vs/dSs are no longer read
    stage<T, HD, TM>(Ks, LD, kb + (int64_t)k0 * st.ks, st.ks, Sk - k0, 1.f);
    stage<T, HD, TM>(Vs, LD, vb + (int64_t)k0 * st.vs, st.vs, Sk - k0, 1.f);
    __syncthreads();

    // S = (scale Q) K^T and dP = dO V^T for rows ty + 16i, cols tx + 16j
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + d];
        ov[i] = dOs[(ty + 16 * i) * LD + d];
        kv[i] = Ks[(tx + 16 * i) * LD + d];
        vv[i] = Vs[(tx + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

    // dS = P (dP - D), P = exp(S - L) on admitted pairs, else 0
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p = admitted(qp, kp, Sk, causal, window)
                            ? expf(s[i][j] - Lr[i]) : 0.f;
        dSs[(ty + 16 * i) * LDS + tx + 16 * j] = p * (dp[i][j] - Dr[i]);
      }
    }
    __syncthreads();

    // acc += dS K for rows ty + 16i, columns tx + 16j
#pragma unroll 4
    for (int c = 0; c < TM; ++c) {
      float dsv[R], kv[J];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dSs[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < J; ++j) kv[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    float* row = dq + (((int64_t)b * Sq + qp) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < J; ++j) row[tx + 16 * j] = acc[i][j] * scale;
  }
}

// ----------------------------------------------------------- K3: dK, dV
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Kh, int Sq, int Sk,
                     Strides st, int causal, int window, float scale) {
  constexpr int TM = Tile<HD>::M;  // kv rows per block = q rows per tile
  constexpr int R = TM / 16;
  constexpr int J = HD / 16;       // dK/dV columns per thread
  constexpr int LD = HD + 1;
  constexpr int LDS = TM + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                // TM x LD
  float* Vs = Ks + TM * LD;        // TM x LD
  float* Qs = Vs + TM * LD;        // TM x LD, not scaled
  float* dOs = Qs + TM * LD;       // TM x LD
  float* Pt = dOs + TM * LD;       // TM x LDS: P^T, kv rows by q columns
  float* dSt = Pt + TM * LDS;      // TM x LDS: dS^T
  float* Ls = dSt + TM * LDS;      // TM
  float* Ds = Ls + TM;             // TM

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int b = blockIdx.y / Kh;
  const int kh = blockIdx.y % Kh;
  const int rep = H / Kh;
  const int k0 = blockIdx.x * TM;

  stage<T, HD, TM>(Ks, LD, k + b * st.kb + kh * st.kh + (int64_t)k0 * st.ks,
                   st.ks, Sk - k0, 1.f);
  stage<T, HD, TM>(Vs, LD, v + b * st.vb + kh * st.vh + (int64_t)k0 * st.vs,
                   st.vs, Sk - k0, 1.f);

  // q rows that can see some key of this tile: q >= k0 under the causal
  // mask, q < k_last + window under the window
  const int k_last = min(k0 + TM, Sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int t_lo = q_lo / TM;
  const int t_hi = q_hi > q_lo ? (q_hi + TM - 1) / TM : t_lo;

  float dka[R][J], dva[R][J];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int h = kh * rep; h < (kh + 1) * rep; ++h) {
    const int64_t bh = (int64_t)b * H + h;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * TM;
      __syncthreads();   // the previous tile's Qs/dOs/Pt/dSt are free
      stage<T, HD, TM>(Qs, LD, q + b * st.qb + h * st.qh
                                   + (int64_t)q0 * st.qs,
                       st.qs, Sq - q0, 1.f);
      stage<T, HD, TM>(dOs, LD, dout + b * st.ob + h * st.oh
                                    + (int64_t)q0 * st.os,
                       st.os, Sq - q0, 1.f);
      for (int r = threadIdx.x; r < TM; r += NT) {
        const bool in = q0 + r < Sq;
        Ls[r] = in ? lse[bh * Sq + q0 + r] : 0.f;
        Ds[r] = in ? delta[bh * Sq + q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for kv rows ty + 16i, q columns tx + 16j
      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float kr[R], vr[R], qc[R], oc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kr[i] = Ks[(ty + 16 * i) * LD + d];
          vr[i] = Vs[(ty + 16 * i) * LD + d];
          qc[i] = Qs[(tx + 16 * i) * LD + d] * scale;
          oc[i] = dOs[(tx + 16 * i) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(qc[j], kr[i], s[i][j]);
            dp[i][j] = fmaf(oc[j], vr[i], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kp = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = tx + 16 * j;
          const int qp = q0 + c;
          const float p = (qp < Sq && admitted(qp, kp, Sk, causal, window))
                              ? expf(s[i][j] - Ls[c]) : 0.f;
          Pt[(ty + 16 * i) * LDS + c] = p;
          dSt[(ty + 16 * i) * LDS + c] = p * (dp[i][j] - Ds[c]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q for kv rows ty + 16i, columns tx + 16j
#pragma unroll 2
      for (int c = 0; c < TM; ++c) {
        float pv[R], dsv[R], ov[J], qv[J];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = Pt[(ty + 16 * i) * LDS + c];
          dsv[i] = dSt[(ty + 16 * i) * LDS + c];
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          ov[j] = dOs[c * LD + tx + 16 * j];
          qv[j] = Qs[c * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < J; ++j) {
            dva[i][j] = fmaf(pv[i], ov[j], dva[i][j]);
            dka[i][j] = fmaf(dsv[i], qv[j], dka[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= Sk) continue;
    const int64_t off = (((int64_t)b * Sk + kp) * Kh + kh) * HD;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      dk[off + tx + 16 * j] = dka[i][j] * scale;
      dv[off + tx + 16 * j] = dva[i][j];
    }
  }
}

template <int HD>
constexpr int dq_smem_bytes() {
  constexpr int TM = Tile<HD>::M;
  return (4 * TM * (HD + 1) + TM * (TM + 1)) * (int)sizeof(float);
}

template <int HD>
constexpr int dkv_smem_bytes() {
  constexpr int TM = Tile<HD>::M;
  return (4 * TM * (HD + 1) + 2 * TM * (TM + 1) + 2 * TM) *
         (int)sizeof(float);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  float *dq, *dk, *dv;
  int B, H, Kh, Sq, Sk;
  Strides st;
  int causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch_dq(const Args& a) {
  constexpr int TM = Tile<HD>::M;
  constexpr int smem = dq_smem_bytes<HD>();
  auto kern = flash_bwd_dq_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + TM - 1) / TM, a.B * a.H);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.dq, a.H, a.Kh, a.Sq, a.Sk, a.st, a.causal, a.window,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const Args& a) {
  constexpr int TM = Tile<HD>::M;
  constexpr int smem = dkv_smem_bytes<HD>();
  auto kern = flash_bwd_dkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + TM - 1) / TM, a.B * a.Kh);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.dk, a.dv, a.H, a.Kh, a.Sq, a.Sk, a.st, a.causal, a.window,
      a.scale);
  return cudaGetLastError();
}

template <typename T, bool DQ>
cudaError_t dispatch(int hd, const Args& a) {
#define CASE(D)                                                    \
  case D:                                                          \
    return DQ ? launch_dq<T, D>(a) : launch_dkv<T, D>(a);
  switch (hd) {
    CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112)
    CASE(128) CASE(144) CASE(160) CASE(176) CASE(192) CASE(208) CASE(224)
    CASE(240) CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef CASE
}

template <bool DQ>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* o0, void* o1, int dtype,
        int B, int H, int Kh, int Sq, int Sk, int hd, const int64_t* s,
        int causal, int window, float scale, void* stream) {
  Args a{q, k, v, dout,
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         DQ ? static_cast<float*>(o0) : nullptr,
         DQ ? nullptr : static_cast<float*>(o0),
         DQ ? nullptr : static_cast<float*>(o1),
         B, H, Kh, Sq, Sk,
         Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
                 s[10], s[11]},
         causal, window, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float, DQ>(hd, a);
  if (dtype == 1) return dispatch<__nv_bfloat16, DQ>(hd, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and dout share it).  strides:
// 12 int64 element strides, (batch, seq, head) for q, k, v and dout in that
// order; the head dim is contiguous.  lse and delta are (B*H, Sq) f32,
// contiguous.  window <= 0 means no window.  Returns a cudaError_t code.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int dtype, int B, int H, int Kh, int Sq, int Sk,
                 int hd, const int64_t* strides, int causal, int window,
                 float scale, void* stream) {
  return run<true>(q, k, v, dout, lse, delta, dq, nullptr, dtype, B, H, Kh,
                   Sq, Sk, hd, strides, causal, window, scale, stream);
}

// As flash_bwd_dq; writes dk and dv, (B, Sk, Kh, hd) f32 contiguous, each
// summed over the query heads of its GQA group.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int dtype, int B, int H, int Kh,
                  int Sq, int Sk, int hd, const int64_t* strides, int causal,
                  int window, float scale, void* stream) {
  return run<false>(q, k, v, dout, lse, delta, dk, dv, dtype, B, H, Kh, Sq,
                    Sk, hd, strides, causal, window, scale, stream);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
