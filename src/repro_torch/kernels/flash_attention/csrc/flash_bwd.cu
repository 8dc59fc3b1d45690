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
// its bf16 peak only through the tensor cores (wgmma).
//
// What the design does about it.  The TPU kernels walk a sequential 3-D
// grid and carry their accumulators in VMEM scratch across grid steps; on
// the GPU blocks run in parallel and in no order.  So each output tile has
// exactly one owner that loops over the other axis itself, and no atomics
// are used: two launches on the same inputs are bitwise equal (the bitwise
// resume of training relies on it).  K2 owns q rows and loops over the kv
// tiles the causal and window bounds admit; K3 owns kv rows and loops over
// the query heads of its GQA group and, for each, over the q tiles from
// the first one that can see the kv rows to the last within k_end +
// window, so dK/dV are summed per kv head in registers: there is no
// H-sized dk/dv and no group sum as at the reference's ops.py:104-106.
// Q/K/V/dO are read through their (B,S,H,hd) strides: there is no
// pad-and-transpose copy as in the reference's ops.py::_layout, and the
// ragged edges are masked here.
//
// Two routes, chosen by an explicit table on (dtype, hd) (route_of below,
// the forward's table), never after a failure:
//
// * tensor cores, bf16 at hd 64 and 128 (tc::flash_bwd_dq_wgmma and
//   tc::flash_bwd_dkv_wgmma).  As the forward's: one persistent block per
//   SM walks the work items longest first, two consumer warpgroups of 64
//   rows and one producer warpgroup that keeps a 2-stage ring of tiles full
//   by TMA (4-D maps over the strided tensors, 128-byte swizzle) with
//   mbarrier completion; setmaxnreg moves registers from the producer (40)
//   to the consumers (232).  One staged tile serves both of its products:
//   K2 reads the K tile K-major for S = Q K^T and MN-major for dS K; K3
//   reads Q and dO K-major for S^T and dP^T, MN-major for dS^T Q and
//   P^T dO.  S and dP multiply bf16 inputs exactly; P and dS are f32 in the
//   accumulator registers and become the A operands of the next products
//   as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), both multiplied
//   and summed in the f32 accumulator.  Rounding them to bf16 alone (as
//   GPU flash backwards usually do) errs by ~5e-3 at S 2048, 13-18x the
//   backward's f32 tolerance (2e-4); the split keeps ~16 bits and errs by
//   ~1e-5, for 8 hd (K2) and 12 hd (K3) operations per pair instead of 6
//   and 8.  The tensor cores' f32 sums do not round to nearest, so K3, whose
//   chains are long (all q rows of a GQA group), makes each tile's dK and
//   dV product in a fresh accumulator and adds it to the running sums by
//   f32 adds.  At hd 128 K3 streams 32-row q tiles (64 at hd 64): dK and
//   dV take 128 registers there.  A tile is masked only where it crosses
//   Sk (Sq for K3), the diagonal or the window's edge, and skipped where no
//   pair of a warpgroup's rows is admitted.
//
// * CUDA cores, f32 at every hd and bf16 at hd other than 64 and 128
//   (flash_bwd_dq_kernel, flash_bwd_dkv_kernel).  One block per output tile
//   (K2: (b*h, q tile), heaviest first; K3: (b, kv head, kv tile)), f32
//   FMAs with operands staged in shared memory as f32, tiles of 64 rows (32
//   for hd > 128, to fit shared memory).  f32 stays here because TF32
//   tensor cores would break the f32 tolerance that the reduced f32 configs
//   and the bitwise-resume checks rely on.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no -lcuda: cuTensorMapEncodeTiled is fetched from the driver at run
// time).  C interface (loaded with ctypes): flash_bwd_dq(...) and
// flash_bwd_dkv(...) each return cudaGetLastError() after their launch, or
// a code >= 10000 if a tensor map could not be made;
// flash_bwd_error_string(code) names it; flash_bwd_route(dtype, hd) says
// which route a call takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// The route table: 1 = tensor cores, 0 = CUDA cores.
int route_of(int dtype, int hd) {
  return dtype == 1 && (hd == 64 || hd == 128);
}

// ---------------------------------------------------------------------------
// The CUDA-core route: f32, and bf16 at head dims other than 64 and 128.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The tensor-core route: bf16 at head dims 64 and 128.
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int NT = 384;        // consumer warpgroups 0 and 1, producer 2
constexpr int CONSUMERS = 256;
constexpr int ROWS = 128;      // rows a work item owns: 64 per consumer
constexpr int TILE = 64;       // rows of each streamed tile
constexpr int STAGES = 2;      // streamed tiles in flight

// Register fragments of one consumer thread (m64nN accumulator layout):
// element i of a 64 x N tile is row 16 warp + lane / 4 + 8 ((i % 4) / 2)
// of the warpgroup's 64, column 8 (i / 4) + 2 (lane % 4) + (i % 2).
__device__ __forceinline__ int frag_row(int i, int warp, int lane) {
  return 16 * warp + lane / 4 + 8 * ((i % 4) / 2);
}
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}

// x = hi + lo with hi = bf16(x) and lo = bf16(x - hi), packed pairwise as
// the A fragments of the next product: the sum of the two products keeps
// about 16 bits of x, where bf16 alone keeps 8 (and would break the f32
// tolerance of the backward).  Columns 16 kk .. 16 kk + 15 of the 64 x N
// accumulator are the fragments 4 kk .. 4 kk + 3.
template <int N>
__device__ __forceinline__ void split(const float (&x)[N],
                                      uint32_t (&hi)[N / 2],
                                      uint32_t (&lo)[N / 2]) {
#pragma unroll
  for (int m = 0; m < N / 2; ++m) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * m], x[2 * m + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[m] = *reinterpret_cast<const uint32_t*>(&h);
    lo[m] = pack_bf16(x[2 * m] - hf.x, x[2 * m + 1] - hf.y);
  }
}

// acc += (hi + lo) B over one tile: B the MN-major tile at `b` (QT rows x
// HD), hi and lo the A fragments of a 64 x QT operand.  Each 64 columns of
// the product are made in `tmp`, zeroed by the first wgmma, and added to
// acc by f32 adds.
template <int HD, int QT>
__device__ __forceinline__ void sum_product(float (&acc)[HD / 2],
                                            float (&tmp)[32],
                                            uint32_t (&hi)[QT / 4],
                                            uint32_t (&lo)[QT / 4],
                                            uint32_t b) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c) {
    pin(hi);
    pin(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint64_t db = desc_mn(b + c * QT * BOX, QT, kk);
      wgmma_rs_n64(tmp, &hi[4 * kk], db, kk > 0);
      wgmma_rs_n64(tmp, &lo[4 * kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(tmp);
    pin(hi);
    pin(lo);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * c + i] += tmp[i];
  }
}

// ------------------------------------------------------------------ K2: dQ
// Shared memory, from a 1024-byte aligned base: the item's Q and dO (ROWS
// rows each), then per stage a K and a V tile (TILE rows), barriers last.
template <int HD>
struct DqLayout {
  static constexpr int Q_BYTES = ROWS * HD * 2;
  static constexpr int KV_BYTES = TILE * HD * 2;
  static constexpr int O_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 2 + 4 * STAGES;
  static constexpr int ALLOC = BAR_OFF + 8 * N_BARS + 1024;
};

// A work item is ROWS q rows of one (batch, head).  Per kv tile of TILE
// rows, each consumer warpgroup (64 q rows):
//   S = Q K^T and dP = dO V^T   wgmma ss, Q/dO and K/V K-major
//   P = exp2(S scale log2e - L log2e), 0 where the mask refuses the pair
//                               (only on tiles that cross Sk, the diagonal
//                               or the window's edge: TMA's zero fill gives
//                               scores of 0, not refusals)
//   dS = P (dP - D)             in the accumulator registers
//   dQ += dS_hi K + dS_lo K     wgmma rs, K MN-major: the tile staged for S
// and dQ is scaled once, at the store.
template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int H, int Kh, int Sq, int Sk, int causal, int window,
                   float scale, float scale_log2, int n_bh) {
  using L = DqLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sO = base + L::O_OFF, sK = base + L::K_OFF,
                 sV = base + L::V_OFF;
  // barriers: Q/dO full, Q/dO empty, then per stage K full, K empty, V
  // full, V empty
  const uint32_t q_full = base + L::BAR_OFF, q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 8 * (2 + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (2 + STAGES + s); };
  auto v_full = [&](int s) { return q_full + 8 * (2 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (2 + 3 * STAGES + s); };
  const Walk walk{(Sq + ROWS - 1) / ROWS, n_bh, true};
  // the kv tiles that q rows q0 .. q0 + ROWS - 1 reach
  auto span = [&](int q0, int& t_lo, int& n) {
    const int q_last = min(q0 + ROWS, Sq) - 1;
    const int hi = causal ? min(Sk, q_last + 1) : Sk;
    const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
    t_lo = lo / TILE;
    n = (hi + TILE - 1) / TILE - t_lo;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread loads each item's Q and dO once the consumers
    // are done with the last one's, and keeps the ring of K/V tiles full
    // across items
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int t = 0;   // K/V tiles loaded so far: the ring position
      int n = 0;   // items so far
      for (int j = walk.of_round(0); j < walk.items(); j = walk.of_round(++n)) {
        int bh, qt, t_lo, nt;
        walk.at(j, bh, qt);
        const int b = bh / H, h = bh % H, kh = h / (H / Kh), q0 = qt * ROWS;
        span(q0, t_lo, nt);
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * L::Q_BYTES);
        for (int bx = 0; bx < HD / 64; ++bx) {
          tma_load(sQ + bx * ROWS * BOX, &qmap, q_full, 64 * bx, h, q0, b);
          tma_load(sO + bx * ROWS * BOX, &omap, q_full, 64 * bx, h, q0, b);
        }
        for (int i = 0; i < nt; ++i, ++t) {
          const int s = t % STAGES, parity = ((t / STAGES) & 1) ^ 1;
          const int k0 = (t_lo + i) * TILE;
          const uint32_t dk = sK + s * L::KV_BYTES;
          const uint32_t dv = sV + s * L::KV_BYTES;
          mbar_wait(k_empty(s), parity);
          mbar_expect_tx(k_full(s), L::KV_BYTES);
          for (int bx = 0; bx < HD / 64; ++bx)
            tma_load(dk + bx * TILE * BOX, &kmap, k_full(s), 64 * bx, kh, k0,
                     b);
          mbar_wait(v_empty(s), parity);
          mbar_expect_tx(v_full(s), L::KV_BYTES);
          for (int bx = 0; bx < HD / 64; ++bx)
            tma_load(dv + bx * TILE * BOX, &vmap, v_full(s), 64 * bx, kh, k0,
                     b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows q0 + 64 wg .. q0 + 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    float acc[HD / 2];   // dQ
    float sc[TILE / 2];  // S, then P, then dS
    float dp[TILE / 2];  // dP
    uint32_t hi[TILE / 4], lo[TILE / 4];
    int t = 0;     // K/V tiles consumed so far: the ring position
    int n = 0;     // items so far
    for (int j = walk.of_round(0); j < walk.items(); j = walk.of_round(++n)) {
      int bh, qt, t_lo, nt;
      walk.at(j, bh, qt);
      const int b = bh / H, h = bh % H, q0 = qt * ROWS;
      span(q0, t_lo, nt);
      const int r0 = q0 + 64 * wg;
      const int row = r0 + 16 * warp + lane / 4;   // and row + 8
      float nl[2], dr[2];   // -L log2(e) and D of the two rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = row + 8 * r;
        nl[r] = qp < Sq ? -lse[(int64_t)bh * Sq + qp] * LOG2E : 0.f;
        dr[r] = qp < Sq ? delta[(int64_t)bh * Sq + qp] : 0.f;
      }
      // a tile no row of this warpgroup may see, and one that needs the
      // mask for some row
      auto dead = [&](int k0) {
        return (causal && k0 > r0 + 63) ||
               (window > 0 && k0 + TILE - 1 <= r0 - window);
      };
      auto edge = [&](int k0) {
        return k0 + TILE > Sk || (causal && k0 + TILE - 1 > r0) ||
               (window > 0 && k0 <= r0 + 63 - window);
      };
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

      mbar_wait(q_full, n & 1);
      for (int i = 0; i < nt; ++i) {
        const int s = (t + i) % STAGES, ph = ((t + i) / STAGES) & 1;
        const int k0 = (t_lo + i) * TILE;
        const uint32_t kt = sK + s * L::KV_BYTES, vt = sV + s * L::KV_BYTES;
        mbar_wait(k_full(s), ph);
        mbar_wait(v_full(s), ph);
        if (dead(k0)) {
          mbar_arrive(v_empty(s));
          if (i == nt - 1) mbar_arrive(q_empty);
          mbar_arrive(k_empty(s));
          continue;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_n64(sc, desc_k(sQ, ROWS, 64 * wg, kk),
                       desc_k(kt, TILE, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_n64(dp, desc_k(sO, ROWS, 64 * wg, kk),
                       desc_k(vt, TILE, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        pin(sc);
#pragma unroll
        for (int i2 = 0; i2 < TILE / 2; ++i2)
          sc[i2] = exp2_ftz(fmaf(sc[i2], scale_log2, nl[(i2 % 4) / 2]));
        if (edge(k0)) {
#pragma unroll
          for (int i2 = 0; i2 < TILE / 2; ++i2) {
            const int qp = r0 + frag_row(i2, warp, lane);
            const int kp = k0 + frag_col(i2, lane);
            if (!admitted(qp, kp, Sk, causal, window)) sc[i2] = 0.f;
          }
        }
        wgmma_wait<0>();
        pin(dp);
        mbar_arrive(v_empty(s));
        // Q and dO are read by S and dP only: the next item's may load
        if (i == nt - 1) mbar_arrive(q_empty);
#pragma unroll
        for (int i2 = 0; i2 < TILE / 2; ++i2)
          sc[i2] *= dp[i2] - dr[(i2 % 4) / 2];
        split(sc, hi, lo);
        pin(acc);
        pin(hi);
        pin(lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          wgmma_rs<HD>(acc, &hi[4 * kk], desc_mn(kt, TILE, kk));
          wgmma_rs<HD>(acc, &lo[4 * kk], desc_mn(kt, TILE, kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
        pin(hi);
        pin(lo);
        mbar_arrive(k_empty(s));
      }
      t += nt;
      if (nt == 0) mbar_arrive(q_empty);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = row + 8 * r;
        if (qp >= Sq) continue;
        float* out = dq + (((int64_t)b * Sq + qp) * H + h) * HD;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj)
          *reinterpret_cast<float2*>(out + 8 * jj + 2 * (lane % 4)) =
              make_float2(acc[4 * jj + 2 * r] * scale,
                          acc[4 * jj + 2 * r + 1] * scale);
      }
    }
  }
}

// -------------------------------------------------------------- K3: dK, dV
// Shared memory, from a 1024-byte aligned base: the item's K and V (ROWS
// rows each), then per stage a Q and a dO tile (QT rows), then per stage
// the tile's L log2(e) and D (QT f32 each), barriers last.
template <int HD>
struct DkvLayout {
  // q rows per streamed tile: 32 at hd 128, where dK and dV take 128
  // registers and a 64-row tile's operands would spill
  static constexpr int QT = HD == 64 ? 64 : 32;
  static constexpr int KV_BYTES = ROWS * HD * 2;
  static constexpr int QO_BYTES = QT * HD * 2;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int O_OFF = Q_OFF + STAGES * QO_BYTES;
  static constexpr int LD_OFF = O_OFF + STAGES * QO_BYTES;
  static constexpr int BAR_OFF = LD_OFF + STAGES * 2 * QT * 4;
  static constexpr int N_BARS = 2 + 2 * STAGES;
  static constexpr int ALLOC = BAR_OFF + 8 * N_BARS + 1024;
};

// A work item is ROWS kv rows of one (batch, kv head).  The producer warp
// streams the Q and dO tiles (QT rows) of each query head of the GQA
// group in turn, over the q rows that can see the item's keys, with their
// L log2(e) and D.  Per tile, each consumer warpgroup (64 kv rows):
//   S^T = K Q^T and dP^T = V dO^T   wgmma ss, K/V and Q/dO K-major
//   P^T = exp2(S^T scale log2e - L log2e), dS^T = P^T (dP^T - D), with L
//                                    and D per column, masked as in K2
//   dV += P^T_hi dO + P^T_lo dO      wgmma rs, dO MN-major, by sum_product
//   dK += dS^T_hi Q + dS^T_lo Q      wgmma rs, Q MN-major, by sum_product
// dK and dV stay in registers across the whole group: no H-sized dk/dv
// and no atomics.  dK is scaled once, at the store.
template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int Kh, int Sq, int Sk,
                    int causal, int window, float scale, float scale_log2,
                    int n_bh) {
  using L = DkvLayout<HD>;
  constexpr int QT = L::QT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t sK = base, sV = base + L::V_OFF, sQ = base + L::Q_OFF,
                 sO = base + L::O_OFF;
  auto ld_tile = [&](int s) {   // L log2(e) at [0, QT), D at [QT, 2 QT)
    return reinterpret_cast<float*>(gbase + L::LD_OFF + s * 2 * QT * 4);
  };
  // barriers: K/V full, K/V empty, then per stage Q/dO full, Q/dO empty
  const uint32_t kv_full = base + L::BAR_OFF, kv_empty = kv_full + 8;
  auto t_full = [&](int s) { return kv_full + 8 * (2 + s); };
  auto t_empty = [&](int s) { return kv_full + 8 * (2 + STAGES + s); };
  const int rep = H / Kh;
  const Walk walk{(Sk + ROWS - 1) / ROWS, n_bh, false};
  // the q tiles that can see kv rows k0 .. k0 + ROWS - 1: q >= k0 under
  // the causal mask, q < k_last + window under the window
  auto span = [&](int k0, int& t_lo, int& n) {
    const int k_last = min(k0 + ROWS, Sk) - 1;
    const int q_lo = causal ? k0 : 0;
    const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;
    t_lo = q_lo / QT;
    n = q_hi > q_lo ? (q_hi + QT - 1) / QT - t_lo : 0;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(t_full(s), 1 + 32);   // the TMA's bytes, 32 lanes' L and D
      mbar_init(t_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer warp: lane 0 loads each item's K and V once the consumers
    // are done with the last one's and issues the Q/dO tiles; every lane
    // stages two rows of each tile's L log2(e) and D
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 == 8) {
      const int lane = threadIdx.x % 32;
      int t = 0;   // Q/dO tiles loaded so far: the ring position
      int n = 0;   // items so far
      for (int j = walk.of_round(0); j < walk.items(); j = walk.of_round(++n)) {
        int bkh, kt, t_lo, nq;
        walk.at(j, bkh, kt);
        const int b = bkh / Kh, kh = bkh % Kh, k0 = kt * ROWS;
        span(k0, t_lo, nq);
        if (lane == 0) {
          mbar_wait(kv_empty, (n & 1) ^ 1);
          mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
          for (int bx = 0; bx < HD / 64; ++bx) {
            tma_load(sK + bx * ROWS * BOX, &kmap, kv_full, 64 * bx, kh, k0, b);
            tma_load(sV + bx * ROWS * BOX, &vmap, kv_full, 64 * bx, kh, k0, b);
          }
        }
        for (int h = kh * rep; h < (kh + 1) * rep; ++h) {
          const int64_t bh = (int64_t)b * H + h;
          for (int i = 0; i < nq; ++i, ++t) {
            const int s = t % STAGES, parity = ((t / STAGES) & 1) ^ 1;
            const int q0 = (t_lo + i) * QT;
            mbar_wait(t_empty(s), parity);
            if (lane == 0) {
              mbar_expect_tx(t_full(s), 2 * L::QO_BYTES);
              for (int bx = 0; bx < HD / 64; ++bx) {
                tma_load(sQ + s * L::QO_BYTES + bx * QT * BOX, &qmap,
                         t_full(s), 64 * bx, h, q0, b);
                tma_load(sO + s * L::QO_BYTES + bx * QT * BOX, &omap,
                         t_full(s), 64 * bx, h, q0, b);
              }
            }
            float* ld = ld_tile(s);
            for (int r = lane; r < QT; r += 32) {
              const int qp = q0 + r;
              ld[r] = qp < Sq ? lse[bh * Sq + qp] * LOG2E : 0.f;
              ld[QT + r] = qp < Sq ? delta[bh * Sq + qp] : 0.f;
            }
            mbar_arrive(t_full(s));
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns kv rows k0 + 64 wg .. k0 + 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    float ka[HD / 2], va[HD / 2];   // dK, dV
    float st[QT / 2];             // S^T, then P^T
    float dp[QT / 2];             // dP^T, then dS^T
    float tmp[32];                  // one tile's product, 64 columns
    uint32_t p_hi[QT / 4], p_lo[QT / 4], s_hi[QT / 4], s_lo[QT / 4];
    int t = 0;     // Q/dO tiles consumed so far: the ring position
    int n = 0;     // items so far
    for (int j = walk.of_round(0); j < walk.items(); j = walk.of_round(++n)) {
      int bkh, kt, t_lo, nq;
      walk.at(j, bkh, kt);
      const int b = bkh / Kh, kh = bkh % Kh, k0 = kt * ROWS;
      span(k0, t_lo, nq);
      const int r0 = k0 + 64 * wg;
      // a tile no kv row of this warpgroup is seen by, and one that needs
      // the mask for some pair
      auto dead = [&](int q0) {
        return (causal && q0 + QT - 1 < r0) ||
               (window > 0 && q0 >= r0 + 63 + window);
      };
      auto edge = [&](int q0) {
        return q0 + QT > Sq || (causal && q0 < r0 + 63) ||
               (window > 0 && q0 + QT - 1 >= r0 + window);
      };
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) ka[i] = va[i] = 0.f;

      mbar_wait(kv_full, n & 1);
      const int total = rep * nq;
      for (int c = 0; c < total; ++c) {
        const int s = (t + c) % STAGES, ph = ((t + c) / STAGES) & 1;
        const int q0 = (t_lo + c % nq) * QT;
        const uint32_t qt = sQ + s * L::QO_BYTES, ot = sO + s * L::QO_BYTES;
        const float* ld = ld_tile(s);
        mbar_wait(t_full(s), ph);
        if (dead(q0)) {
          if (c == total - 1) mbar_arrive(kv_empty);
          mbar_arrive(t_empty(s));
          continue;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<QT>(st, desc_k(sK, ROWS, 64 * wg, kk),
                       desc_k(qt, QT, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<QT>(dp, desc_k(sV, ROWS, 64 * wg, kk),
                       desc_k(ot, QT, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        pin(st);
#pragma unroll
        for (int jj = 0; jj < QT / 8; ++jj) {
          const float2 l2 = *reinterpret_cast<const float2*>(
              ld + 8 * jj + 2 * (lane % 4));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[4 * jj + e] = exp2_ftz(
                fmaf(st[4 * jj + e], scale_log2, -(e % 2 ? l2.y : l2.x)));
        }
        if (edge(q0)) {
#pragma unroll
          for (int i2 = 0; i2 < QT / 2; ++i2) {
            const int kp = r0 + frag_row(i2, warp, lane);
            const int qp = q0 + frag_col(i2, lane);
            if (!(qp < Sq && admitted(qp, kp, Sk, causal, window)))
              st[i2] = 0.f;
          }
        }
        wgmma_wait<0>();
        pin(dp);
        // K and V are read by S^T and dP^T only: the next item's may load
        if (c == total - 1) mbar_arrive(kv_empty);
#pragma unroll
        for (int jj = 0; jj < QT / 8; ++jj) {
          const float2 d2 = *reinterpret_cast<const float2*>(
              ld + QT + 8 * jj + 2 * (lane % 4));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * jj + e] =
                st[4 * jj + e] * (dp[4 * jj + e] - (e % 2 ? d2.y : d2.x));
        }
        split(st, p_hi, p_lo);
        split(dp, s_hi, s_lo);
        // dV += P^T dO and dK += dS^T Q, 64 columns at a time: each tile's
        // product goes to a fresh accumulator and is added to the running
        // sum by f32 adds.  The tensor cores' f32 sums do not round to
        // nearest: over the q rows and heads a kv row sums (16 K products
        // at S 2048, GQA 4), one long chain in the accumulator would err
        // ~10x more than the split's own rounding.
        sum_product<HD, QT>(va, tmp, p_hi, p_lo, ot);
        sum_product<HD, QT>(ka, tmp, s_hi, s_lo, qt);
        mbar_arrive(t_empty(s));
      }
      t += total;
      if (total == 0) mbar_arrive(kv_empty);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kp = r0 + 16 * warp + lane / 4 + 8 * r;
        if (kp >= Sk) continue;
        const int64_t off = (((int64_t)b * Sk + kp) * Kh + kh) * HD;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj) {
          const int col = 8 * jj + 2 * (lane % 4);
          *reinterpret_cast<float2*>(dk + off + col) = make_float2(
              ka[4 * jj + 2 * r] * scale, ka[4 * jj + 2 * r + 1] * scale);
          *reinterpret_cast<float2*>(dv + off + col) =
              make_float2(va[4 * jj + 2 * r], va[4 * jj + 2 * r + 1]);
        }
      }
    }
  }
}

// Tensor maps of q and dout (boxes of q_rows rows) and k and v (kv_rows)
template <int HD>
int make_maps(const Args& a, int q_rows, int kv_rows, CUtensorMap* qm,
              CUtensorMap* km, CUtensorMap* vm, CUtensorMap* om) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODER_MISSING;
  const Strides& s = a.st;
  CUresult r = make_map(enc, qm, a.q, HD, a.H, a.Sq, a.B, s.qb, s.qs, s.qh,
                        q_rows);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, km, a.k, HD, a.Kh, a.Sk, a.B, s.kb, s.ks, s.kh,
                 kv_rows);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, vm, a.v, HD, a.Kh, a.Sk, a.B, s.vb, s.vs, s.vh,
                 kv_rows);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, om, a.dout, HD, a.H, a.Sq, a.B, s.ob, s.os, s.oh,
                 q_rows);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(r);
}

template <int HD>
int launch_dq(const Args& a) {
  CUtensorMap qm, km, vm, om;
  int code = make_maps<HD>(a, ROWS, TILE, &qm, &km, &vm, &om);
  if (code) return code;
  auto kern = flash_bwd_dq_wgmma<HD>;
  int grid = 0;
  code = persistent_grid(kern, DqLayout<HD>::ALLOC,
                         a.B * a.H * ((a.Sq + ROWS - 1) / ROWS), &grid);
  if (code) return code;
  kern<<<grid, NT, DqLayout<HD>::ALLOC, a.stream>>>(
      qm, km, vm, om, a.lse, a.delta, a.dq, a.H, a.Kh, a.Sq, a.Sk, a.causal,
      a.window, a.scale, a.scale * LOG2E, a.B * a.H);
  return cudaGetLastError();
}

template <int HD>
int launch_dkv(const Args& a) {
  CUtensorMap qm, km, vm, om;
  int code = make_maps<HD>(a, DkvLayout<HD>::QT, ROWS, &qm, &km, &vm, &om);
  if (code) return code;
  auto kern = flash_bwd_dkv_wgmma<HD>;
  int grid = 0;
  code = persistent_grid(kern, DkvLayout<HD>::ALLOC,
                         a.B * a.Kh * ((a.Sk + ROWS - 1) / ROWS), &grid);
  if (code) return code;
  kern<<<grid, NT, DkvLayout<HD>::ALLOC, a.stream>>>(
      qm, km, vm, om, a.lse, a.delta, a.dk, a.dv, a.H, a.Kh, a.Sq, a.Sk,
      a.causal, a.window, a.scale, a.scale * LOG2E, a.B * a.Kh);
  return cudaGetLastError();
}

template <bool DQ>
int launch(int hd, const Args& a) {
  if (hd == 64) return DQ ? launch_dq<64>(a) : launch_dkv<64>(a);
  return DQ ? launch_dq<128>(a) : launch_dkv<128>(a);
}

}  // namespace tc

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
  if (route_of(dtype, hd)) return tc::launch<DQ>(hd, a);
  if (dtype == 0) return dispatch<float, DQ>(hd, a);
  if (dtype == 1) return dispatch<__nv_bfloat16, DQ>(hd, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and dout share it).  strides:
// 12 int64 element strides, (batch, seq, head) for q, k, v and dout in that
// order; the head dim is contiguous.  lse and delta are (B*H, Sq) f32,
// contiguous.  window <= 0 means no window.  Returns a cudaError_t code, or
// hopper::ENCODER_MISSING / ENCODE_FAILED + CUresult.
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

// 1 if flash_bwd_dq and flash_bwd_dkv run (dtype, hd) on the tensor cores,
// 0 on the CUDA cores.
int flash_bwd_route(int dtype, int hd) { return route_of(dtype, hd); }

const char* flash_bwd_error_string(int code) {
  return hopper::error_string(code);
}

}  // extern "C"
