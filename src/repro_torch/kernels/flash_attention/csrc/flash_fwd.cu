// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_attn_fwd_kernel
// (launched by flash_attention_fwd_kernel through pl.pallas_call).
//
// It computes the same function: O = softmax(scale * Q K^T + mask) V and the
// per-row logsumexp L = m + log(max(l, 1e-30)) in natural log, for q
// (B,Sq,H,hd) and k/v (B,Sk,Kh,hd) in f32 or bf16.  Q K^T accumulates in
// f32 and the scale multiplies that f32 sum; P is rounded to V's dtype
// before the P V product, which accumulates in f32.  The mask is built from
// absolute positions: kv padding (k < Sk), causal (k <= q) and sliding
// window (k > q - window), where query row i sits at q = q_offset + i and
// key j at j (q_offset 0: top-left aligned; a sequence block of a
// sequence-parallel rank against the gathered keys: its first position).
// The kv loop covers only the tiles the offset rows reach.  Query
// head h reads kv head h / (H / Kh); K and V are never repeated in memory,
// and q/k/v are read through their (B,S,H,hd) strides.  No atomics and no
// split of kv across blocks: two launches on the same inputs are bitwise
// equal.
//
// What bounds it on this card.  At the prefill and training shapes (hd 64,
// S 2048) attention does 4 hd = 256 operations per admitted q/k pair
// against a few bytes per row: it is bound by operations at the bf16
// tensor-core peak (989 TFLOP/s), reachable only through wgmma.
//
// Two routes, chosen by an explicit table on (dtype, hd) (route_of below),
// never after a failure:
//
// * tensor cores, bf16 at hd 64, 80 and 128 (tc::flash_fwd_wgmma).  A work
//   item is 128 q rows of one (batch, head).  One persistent block per SM
//   walks the items, longest q tiles first (the causal diagonal's short
//   ones fill the tail) in bands of 8 q tiles whose heads' tiles are
//   adjacent (so blocks running together share K and V in L2), dealt to
//   the blocks back and forth so each gets about the same work.  No
//   atomics: the order is fixed.  A block is two consumer warpgroups of 64 rows
//   each and one producer warpgroup; setmaxnreg moves registers from the
//   producer (40) to the consumers (232).  One producer thread loads each
//   item's Q, once the consumers are done with the last one's, and keeps a
//   2-stage ring of 128-row K and V tiles full across items, with TMA
//   (cp.async.bulk.tensor, 4-D maps over the strided tensors, 128-byte
//   swizzle; a head of 80 or 128 is two 64-column boxes) and mbarrier
//   completion; consumers release each stage as soon as its product is
//   done, so the next item's loads run under this one's last tiles and
//   its output stores.  S = Q K^T is wgmma m64n128k16 with Q and K K-major
//   in shared memory; the scale multiplies the f32 accumulator inside the
//   exp2's FMA (log2(e) folded in), and the accumulator registers, rounded
//   pairwise to bf16, are the A fragments of O += P V (wgmma m64n{hd}k16,
//   V MN-major in shared memory): P never touches shared memory.  S of
//   tile i and P V of tile i - 1 are in flight together, so a warpgroup's
//   softmax runs under its own P V and the other warpgroup's products.
//   The row max and sum run as four partial chains each.  The mask is applied only on
//   tiles that cross Sk (TMA's zero fill gives scores of 0, not -inf), the
//   diagonal or the window's edge, in a branch of its own; interior tiles
//   skip it.  The kv loop covers only the tiles the causal and window
//   bounds reach.  hd 80 (hubert's heads) is staged as hd 128 is, two
//   64-column boxes a row, the maps' extent 80 so that TMA zero-fills
//   columns 80-127 (the mbarriers count whole boxes, zeros included): S
//   runs 5 k-steps of 16 and never reads the zeros, and P V is an m64n80
//   product whose B spans the first box and 16 columns of the second.
//
// * CUDA cores, f32 at every hd and bf16 at hd other than 64, 80 and 128
//   (flash_fwd_kernel).  One block per (batch*head, 64-row q tile), f32
//   FMAs with operands staged in shared memory as f32.  f32 stays here
//   because TF32 tensor cores would break the f32 tolerance (2e-5) that the
//   reduced f32 configs and bitwise-resume checks rely on; no model on a
//   main path uses another bf16 head dim.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no -lcuda: cuTensorMapEncodeTiled is fetched from the driver at run
// time).  C interface (loaded with ctypes): flash_fwd(...) returns
// cudaGetLastError() after the launch, or a code >= 10000 if a tensor map
// could not be made; flash_fwd_error_string(code) names it;
// flash_fwd_route(dtype, hd) says which route a call takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The route table of K1, and of K2 and K3 (flash_bwd.cu): 1 = tensor
// cores, 0 = CUDA cores.
int route_of(int dtype, int hd) {
  return dtype == 1 && (hd == 64 || hd == 80 || hd == 128);
}

// ---------------------------------------------------------------------------
// The CUDA-core route: f32, and bf16 at head dims other than 64, 80, 128.
// ---------------------------------------------------------------------------

constexpr int BM = 64;       // q rows per block
constexpr int BN = 64;       // kv rows per tile
constexpr int NT = 256;      // threads per block: 16 x 16

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
                 int causal, int window, int q_offset, float scale) {
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

  // kv range reachable by any row of this q tile (absolute positions)
  const int q_last = min(q0 + BM, Sq) - 1 + q_offset;
  int hi = causal ? min(Sk, q_last + 1) : Sk;
  int lo = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
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
      const int qp = q0 + ty + 16 * i + q_offset;
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
                   const int64_t* st, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
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
      st[9], st[10], st[11], causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, float* lse, int B, int H, int Kh, int Sq,
                     int Sk, const int64_t* st, int causal, int window,
                     int q_offset, float scale, cudaStream_t stream) {
#define CASE(D)                                                            \
  case D:                                                                  \
    return launch<T, D>(q, k, v, o, lse, B, H, Kh, Sq, Sk, st, causal,    \
                        window, q_offset, scale, stream);
  switch (hd) {
    CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112)
    CASE(128) CASE(144) CASE(160) CASE(176) CASE(192) CASE(208) CASE(224)
    CASE(240) CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef CASE
}

// ---------------------------------------------------------------------------
// The tensor-core route: bf16 at head dims 64, 80 and 128.
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BM = 128;      // q rows per work item: 64 per consumer warpgroup
constexpr int BN = 128;      // kv rows per tile
constexpr int STAGES = 2;    // K/V tiles in flight
constexpr int NT = 384;      // consumer warpgroups 0 and 1, producer 2
constexpr int CONSUMERS = 256;
constexpr float LN2 = 0.6931471805599453f;
// A masked score is -inf, so exp2 of it is exactly 0 whatever the running
// max: a finite sentinel times the scale, less the max, can be far from 0
// once the FMA rounds them apart.  The running max starts at NEG_INF
// (finite), so it never becomes -inf and exp2(m_old - m_new) is never NaN.
constexpr float MASKED = -__builtin_huge_valf();

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes).  Each operand is staged HP = HD
// rounded up to 64 columns wide, NB = HP / 64 boxes of rows x 64 columns,
// box after box (the columns past HD are TMA's zeros); barriers at the
// end.
template <int HD>
struct Layout {
  static constexpr int HP = (HD + 63) / 64 * 64;
  static constexpr int NB = HP / 64;
  static constexpr int Q_BYTES = BM * HP * 2;
  static constexpr int KV_BYTES = BN * HP * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 2 + 4 * STAGES;
  static constexpr int ALLOC = BAR_OFF + 8 * N_BARS + 1024;
};

// Register fragments of one consumer thread (m64nN accumulator layout):
// element 4j + e of a 64 x N tile is row (lane / 4) + 8 (e / 2) of the
// warp's 16 rows, column 8j + 2 (lane % 4) + (e % 2).
template <int HD>
struct Consumer {
  float s[BN / 2];     // scores of one kv tile, then their exponentials
  uint32_t p[BN / 4];  // P in bf16 pairs: the A fragments of P V
  float o[HD / 2];     // the output accumulator
  float m[2], l[2];    // running max (log2 units) and this thread's sums

  // S = Q K^T over the head dim, K-major A (Q) and B (K) in shared memory,
  // HD / 16 k-steps: desc_k starts the fifth at the second box, so at hd 80
  // the zero columns 80-127 are never read
  __device__ __forceinline__ void issue_qk(uint32_t q_base, uint32_t k_base) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n128(s, desc_k(q_base, BM, 0, kk), desc_k(k_base, BN, 0, kk),
                    kk > 0);
  }

  // O += P V: P from registers, V (kv rows x hd, MN-major) in shared
  // memory; at hd 80 one m64n80 product over the first box and 16 columns
  // of the second
  __device__ __forceinline__ void issue_pv(uint32_t v_base) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<HD>(o, &p[4 * kk], desc_mn(v_base, BN, kk));
  }

  // Mask if asked (row is the absolute position), take the row max, and turn s into exp2(scale_log2 s -
  // m) with m the running max in log2 units (the scale multiplies the f32
  // accumulator inside one FMA); returns the factors by which the old o and
  // l shrink.  Max and sum run as four partial chains per row: a single
  // chain of 32 dependent operations would stall the warp.
  __device__ __forceinline__ void softmax(float scale_log2, bool masked,
                                          int row, int k0, int lane, int Sk,
                                          int causal, int window,
                                          float (&alpha)[2]) {
    if (masked) mask(row, k0, lane, Sk, causal, window);
    // element i of row r: i = 4j + 2r + e; chain c takes j % 4 == c
    float mx[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        mx[r][c] = fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]);
#pragma unroll
    for (int j = 4; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r][j % 4] = fmaxf(mx[r][j % 4],
                             fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x * scale_log2);
      alpha[r] = exp2_ftz(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i % 4) / 2;
      s[i] = exp2_ftz(fmaf(s[i], scale_log2, -m[r]));
      sum[r][(i / 4) % 4] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * alpha[r] +
             ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
  }

  // kv padding, causal and window masks from absolute positions (row:
  // the query row's, q_offset included)
  __device__ __forceinline__ void mask(int row, int k0, int lane, int Sk,
                                       int causal, int window) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int qp = row + 8 * ((i % 4) / 2);
      const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      bool ok = kp < Sk;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      if (!ok) s[i] = MASKED;
    }
  }

  __device__ __forceinline__ void rescale_and_pack(const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i % 4) / 2];
    // the accumulator of columns 16kk..16kk+15 is the A fragment of the
    // kk-th k16 slice of P V, rounded pairwise to bf16
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
      p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  }
};

// OFFSET false: q_offset is the constant 0, as on every path but a
// sequence-parallel rank's block (the offset as a run-time value costs the
// consumers' schedule ~7-9% at hd 64 and 80 on an H100).
template <int HD, bool OFFSET>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
                int Kh, int Sq, int Sk, int64_t osb, int64_t oss, int64_t osh,
                int causal, int window, int offset, float scale_log2,
                int n_bh) {
  using L = Layout<HD>;
  const int q_offset = OFFSET ? offset : 0;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  // barriers: Q full, Q empty, then per stage K full, K empty, V full,
  // V empty
  const uint32_t q_full = base + L::BAR_OFF, q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 8 * (2 + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (2 + STAGES + s); };
  auto v_full = [&](int s) { return q_full + 8 * (2 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (2 + 3 * STAGES + s); };

  // Work item j is (q tile, batch*head), in Walk's order: the last q
  // tiles first, in bands of q tiles per head.
  const Walk walk{(Sq + BM - 1) / BM, n_bh, true};
  struct Item {
    int bh, b, h, kh, q0, t_lo, n_tiles;
  };
  auto item = [&](int j) {
    Item it;
    int qt;
    walk.at(j, it.bh, qt);
    it.b = it.bh / H;
    it.h = it.bh % H;
    it.kh = it.h / (H / Kh);
    it.q0 = qt * BM;
    // the kv tiles the item's rows reach, at their absolute positions
    const int q_last = min(it.q0 + BM, Sq) - 1 + q_offset;
    const int hi = causal ? min(Sk, q_last + 1) : Sk;
    const int lo = window > 0 ? max(0, it.q0 + q_offset - window + 1) : 0;
    it.t_lo = lo / BN;
    it.n_tiles = (hi + BN - 1) / BN - it.t_lo;
    return it;
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
    // producer: one thread loads each item's Q once the consumers are done
    // with the last one, and keeps the ring of K/V tiles full across items
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int t = 0;   // K/V tiles loaded so far: the ring position
      int n = 0;   // items so far
      for (int j = walk.of_round(0); j < walk.items(); j = walk.of_round(++n)) {
        const Item it = item(j);
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, L::Q_BYTES);
        for (int bx = 0; bx < L::NB; ++bx)
          tma_load(sQ + bx * BM * BOX, &qmap, q_full, 64 * bx, it.h, it.q0,
                   it.b);
        for (int i = 0; i < it.n_tiles; ++i, ++t) {
          const int s = t % STAGES, parity = ((t / STAGES) & 1) ^ 1;
          const int k0 = (it.t_lo + i) * BN;
          const uint32_t dk = sK + s * L::KV_BYTES;
          const uint32_t dv = sV + s * L::KV_BYTES;
          mbar_wait(k_empty(s), parity);
          mbar_expect_tx(k_full(s), L::KV_BYTES);
          for (int bx = 0; bx < L::NB; ++bx)
            tma_load(dk + bx * BN * BOX, &kmap, k_full(s), 64 * bx, it.kh, k0,
                     it.b);
          mbar_wait(v_empty(s), parity);
          mbar_expect_tx(v_full(s), L::KV_BYTES);
          for (int bx = 0; bx < L::NB; ++bx)
            tma_load(dv + bx * BN * BOX, &vmap, v_full(s), 64 * bx, it.kh, k0,
                     it.b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows q0 + 64 wg .. q0 + 64 wg + 63 of
    // each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const uint32_t q_base = sQ + 64 * wg * BOX;
    Consumer<HD> c;
    float alpha[2];
    int t = 0;     // K/V tiles consumed so far: the ring position
    int n = 0;     // items so far
    for (int j = walk.of_round(0); j < walk.items(); j = walk.of_round(++n)) {
      const Item it = item(j);
      const int r0 = it.q0 + 64 * wg;
      const int row = r0 + 16 * warp + lane / 4;   // and row + 8
      const int a0 = r0 + q_offset;   // the warpgroup's first position
      // a tile needs the mask only where it crosses Sk, the diagonal or
      // the window's edge for some row of this warpgroup
      auto masked = [&](int k0) {
        return k0 + BN > Sk || (causal && k0 + BN - 1 > a0) ||
               (window > 0 && k0 < a0 + 64 - window);
      };
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) c.o[i] = 0.f;
      c.m[0] = c.m[1] = NEG_INF;
      c.l[0] = c.l[1] = 0.f;
      const int nt = it.n_tiles;

      mbar_wait(q_full, n & 1);
      // an item past every key of its rows (only with a window that
      // leaves rows no key, which the op refuses) writes zeros
      if (nt > 0) {
        // tile 0: S, softmax, P
        int s = t % STAGES;
        mbar_wait(k_full(s), (t / STAGES) & 1);
        wgmma_fence();
        c.issue_qk(q_base, sK + s * L::KV_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        pin(c.s);
        mbar_arrive(k_empty(s));
        if (nt == 1) mbar_arrive(q_empty);
        int k0 = it.t_lo * BN;
        c.softmax(scale_log2, masked(k0), row + q_offset, k0, lane, Sk,
                  causal, window, alpha);
        c.rescale_and_pack(alpha);
        // tile i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} in flight
        // together; the softmax of S_i runs while the tensor cores finish
        // P V
        for (int i = 1; i < nt; ++i) {
          const int ps = (t + i - 1) % STAGES;
          s = (t + i) % STAGES;
          k0 = (it.t_lo + i) * BN;
          mbar_wait(k_full(s), ((t + i) / STAGES) & 1);
          mbar_wait(v_full(ps), ((t + i - 1) / STAGES) & 1);
          pin(c.o);
          pin(c.p);
          wgmma_fence();
          c.issue_qk(q_base, sK + s * L::KV_BYTES);
          wgmma_commit();
          c.issue_pv(sV + ps * L::KV_BYTES);
          wgmma_commit();
          wgmma_wait<1>();
          pin(c.s);
          mbar_arrive(k_empty(s));
          if (i == nt - 1) mbar_arrive(q_empty);
          c.softmax(scale_log2, masked(k0), row + q_offset, k0, lane, Sk,
                    causal, window, alpha);
          wgmma_wait<0>();
          pin(c.o);
          pin(c.p);
          mbar_arrive(v_empty(ps));
          c.rescale_and_pack(alpha);
        }
        const int ls = (t + nt - 1) % STAGES;
        mbar_wait(v_full(ls), ((t + nt - 1) / STAGES) & 1);
        pin(c.o);
        pin(c.p);
        wgmma_fence();
        c.issue_pv(sV + ls * L::KV_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        pin(c.o);
        pin(c.p);
        mbar_arrive(v_empty(ls));
        t += nt;
      } else {
        mbar_arrive(q_empty);
      }

      // the four threads of a row hold a quarter of its sum each
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        c.l[r] += __shfl_xor_sync(0xffffffffu, c.l[r], 1);
        c.l[r] += __shfl_xor_sync(0xffffffffu, c.l[r], 2);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = row + 8 * r;
        if (qp >= Sq) continue;
        const float lc = fmaxf(c.l[r], 1e-30f);
        const float inv = 1.f / lc;
        __nv_bfloat16* orow =
            o + it.b * osb + it.h * osh + (int64_t)qp * oss;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj) {
          const __nv_bfloat162 v2 = __floats2bfloat162_rn(
              c.o[4 * jj + 2 * r] * inv, c.o[4 * jj + 2 * r + 1] * inv);
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj +
                                             2 * (lane % 4)) = v2;
        }
        // natural log, as the reference: m is kept in log2 units
        if (lane % 4 == 0)
          lse[(int64_t)it.bh * Sq + qp] = c.m[r] * LN2 + logf(lc);
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Kh, int Sq, int Sk, const int64_t* st, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODER_MISSING;
  CUtensorMap qm, km, vm;
  CUresult r = make_map(enc, &qm, q, HD, H, Sq, B, st[0], st[1], st[2], BM);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &km, k, HD, Kh, Sk, B, st[3], st[4], st[5], BN);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &vm, v, HD, Kh, Sk, B, st[6], st[7], st[8], BN);
  if (r != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(r);
  auto kern = q_offset ? flash_fwd_wgmma<HD, true>
                       : flash_fwd_wgmma<HD, false>;
  int grid = 0;
  const cudaError_t err = persistent_grid(kern, Layout<HD>::ALLOC,
                                          B * H * ((Sq + BM - 1) / BM), &grid);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, Layout<HD>::ALLOC, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, H, Kh, Sq, Sk, st[9],
      st[10], st[11], causal, window, q_offset, scale * LOG2E, B * H);
  return cudaGetLastError();
}

// Each head dim of route_of's table has its own instantiation; any other
// is refused, never sent to a kernel of another width.
template <typename... A>
int launch(int hd, A... a) {
  switch (hd) {
    case 64: return launch<64>(a...);
    case 80: return launch<80>(a...);
    case 128: return launch<128>(a...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 int64 element strides,
// (batch, seq, head) for q, k, v and o in that order; the head dim is
// contiguous.  window <= 0 means no window.  q_offset >= 0 is the absolute
// position of query row 0 (keys sit at 0 .. Sk - 1).  Returns a cudaError_t
// code, or hopper::ENCODER_MISSING / ENCODE_FAILED + CUresult.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int dtype, int B, int H, int Kh, int Sq, int Sk,
              int hd, const int64_t* strides, int causal, int window,
              int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (q_offset < 0) return cudaErrorInvalidValue;
  if (route_of(dtype, hd))
    return tc::launch(hd, q, k, v, o, l, B, H, Kh, Sq, Sk, strides, causal,
                      window, q_offset, scale, s);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, l, B, H, Kh, Sq, Sk, strides,
                           causal, window, q_offset, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, l, B, H, Kh, Sq, Sk,
                                   strides, causal, window, q_offset, scale,
                                   s);
  return cudaErrorInvalidValue;
}

// 1 if flash_fwd runs (dtype, hd) on the tensor cores, 0 on the CUDA cores.
int flash_fwd_route(int dtype, int hd) { return route_of(dtype, hd); }

const char* flash_fwd_error_string(int code) {
  return hopper::error_string(code);
}

}  // extern "C"
