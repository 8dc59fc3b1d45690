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
// absolute positions: kv padding (k < Sk), causal (k <= q, top-left
// aligned, both counted from 0) and sliding window (k > q - window).  Query
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
// * tensor cores, bf16 at hd 64 and 128 (tc::flash_fwd_wgmma).  A work
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
//   swizzle; a 128-wide head is two 64-column boxes) and mbarrier
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
//   bounds reach.
//
// * CUDA cores, f32 at every hd and bf16 at hd other than 64 and 128
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// flash_fwd's own error codes, above every cudaError_t
constexpr int ENCODER_MISSING = 10000;
constexpr int ENCODE_FAILED = 20000;   // + the CUresult

// The route table: 1 = tensor cores, 0 = CUDA cores.
int route_of(int dtype, int hd) {
  return dtype == 1 && (hd == 64 || hd == 128);
}

// ---------------------------------------------------------------------------
// The CUDA-core route: f32, and bf16 at head dims other than 64 and 128.
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

// ---------------------------------------------------------------------------
// The tensor-core route: bf16 at head dims 64 and 128.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128;      // q rows per work item: 64 per consumer warpgroup
constexpr int BN = 128;      // kv rows per tile
constexpr int STAGES = 2;    // K/V tiles in flight
constexpr int NT = 384;      // consumer warpgroups 0 and 1, producer 2
constexpr int BOX = 128;     // bytes of one row of a 64-column box
constexpr int CONSUMERS = 256;
constexpr int BAND = 8;      // q tiles of one head kept together in the order
constexpr float LN2 = 0.6931471805599453f;
// A masked score is -inf, so exp2 of it is exactly 0 whatever the running
// max: a finite sentinel times the scale, less the max, can be far from 0
// once the FMA rounds them apart.  The running max starts at NEG_INF
// (finite), so it never becomes -inf and exp2(m_old - m_new) is never NaN.
constexpr float MASKED = -__builtin_huge_valf();

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes).  Each operand is HD / 64 boxes of
// rows x 64 columns, box after box; barriers at the end.
template <int HD>
struct Layout {
  static constexpr int NB = HD / 64;
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 2 + 4 * STAGES;
  static constexpr int ALLOC = BAR_OFF + 8 * N_BARS + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity) : "memory");
}

// One TMA box of a 4-D map (hd, heads, seq, batch) into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers that an asynchronous wgmma reads or writes: pinned in place
// so the compiler neither moves their uses across the wait nor reuses them
// while the tensor cores hold them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128) (+)= A (64 x 16) * B (16 x 128): A and B in shared memory,
// both K-major (no transpose); f32 accumulate; D is zeroed when !accumulate
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) += A (64 x 16) * B (16 x 64): A in registers (bf16 pairs),
// B in shared memory MN-major (the transpose bit set); f32 accumulate
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 16) * B (16 x 128): A in registers (bf16 pairs),
// B in shared memory MN-major (the transpose bit set); f32 accumulate
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t* a,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t* a,
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t* a, uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// 2^x in one MUFU op; results below 2^-126 flush to 0 (P is rounded to
// bf16 next, and l sums values near 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Register fragments of one consumer thread (m64nN accumulator layout):
// element 4j + e of a 64 x N tile is row (lane / 4) + 8 (e / 2) of the
// warp's 16 rows, column 8j + 2 (lane % 4) + (e % 2).
template <int HD>
struct Consumer {
  float s[BN / 2];     // scores of one kv tile, then their exponentials
  uint32_t p[BN / 4];  // P in bf16 pairs: the A fragments of P V
  float o[HD / 2];     // the output accumulator
  float m[2], l[2];    // running max (log2 units) and this thread's sums

  // S = Q K^T over the head dim, K-major A (Q) and B (K) in shared memory
  __device__ __forceinline__ void issue_qk(uint32_t q_base, uint32_t k_base) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 16 columns further
      const uint64_t da = smem_desc(q_base + (kk / 4) * BM * BOX + off, 16,
                                    8 * BOX);
      const uint64_t db = smem_desc(k_base + (kk / 4) * BN * BOX + off, 16,
                                    8 * BOX);
      wgmma_ss_n128(s, da, db, kk > 0);
    }
  }

  // O += P V: P from registers, V (kv rows x hd, MN-major) in shared memory
  __device__ __forceinline__ void issue_pv(uint32_t v_base) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_pv<HD>(o, &p[4 * kk],
                   smem_desc(v_base + kk * 16 * BOX, BN * BOX, 8 * BOX));
  }

  // Mask if asked, take the row max, and turn s into exp2(scale_log2 s -
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

  // kv padding, causal and window masks from absolute positions
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

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
                int Kh, int Sq, int Sk, int64_t osb, int64_t oss, int64_t osh,
                int causal, int window, float scale_log2, int n_bh) {
  using L = Layout<HD>;
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

  // Work item j is (q tile, batch*head).  Items run longest first, in
  // bands of BAND q tiles: under a causal mask the last q tiles do the
  // most work, and the short ones fill the tail.  Within a band a head's
  // tiles are adjacent, so blocks running at once share its K and V in L2
  // (ordered by q tile alone and without GQA, each running block would
  // read another head's K/V).  Rounds of gridDim.x items are dealt out
  // back and forth (block x takes item x of even rounds and
  // gridDim.x - 1 - x of odd ones), so every block's sum of lengths is
  // about the same.
  const int n_qt = (Sq + BM - 1) / BM;
  const int n_items = n_qt * n_bh;
  struct Item {
    int bh, b, h, kh, q0, t_lo, n_tiles;
  };
  auto item_of = [&](int round) {
    const int x = round & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return round * gridDim.x + x;
  };
  auto item = [&](int j) {
    Item it;
    const int band = j / (BAND * n_bh);
    const int width = min(BAND, n_qt - band * BAND);
    const int r = j - band * BAND * n_bh;
    it.bh = r / width;
    it.b = it.bh / H;
    it.h = it.bh % H;
    it.kh = it.h / (H / Kh);
    it.q0 = (n_qt - 1 - band * BAND - r % width) * BM;
    const int q_last = min(it.q0 + BM, Sq) - 1;
    const int hi = causal ? min(Sk, q_last + 1) : Sk;
    const int lo = window > 0 ? max(0, it.q0 - window + 1) : 0;
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
      for (int j = item_of(0); j < n_items; j = item_of(++n)) {
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
    for (int j = item_of(0); j < n_items; j = item_of(++n)) {
      const Item it = item(j);
      const int r0 = it.q0 + 64 * wg;
      const int row = r0 + 16 * warp + lane / 4;   // and row + 8
      // a tile needs the mask only where it crosses Sk, the diagonal or
      // the window's edge for some row of this warpgroup
      auto masked = [&](int k0) {
        return k0 + BN > Sk || (causal && k0 + BN - 1 > r0) ||
               (window > 0 && k0 < r0 + 64 - window);
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
        c.softmax(scale_log2, masked(k0), row, k0, lane, Sk, causal, window,
                  alpha);
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
          c.softmax(scale_log2, masked(k0), row, k0, lane, Sk, causal,
                    window, alpha);
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

// cuTensorMapEncodeTiled from the driver, found at run time so the library
// links against the CUDA runtime only
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 4-D map (hd, heads, seq, batch) over a bf16 (B, S, heads, hd) tensor
// with element strides (sb, ss, sh) and a contiguous head dim; boxes of 64
// columns x `rows` rows of one (batch, head), 128-byte swizzled, zeros past
// the edge.  A dim of size 1 gets the packed stride: its stride is never
// used, and any 16-byte multiple is valid.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd,
                  int heads, int seq, int batch, int64_t sb, int64_t ss,
                  int64_t sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const int64_t packed[3] = {hd, (int64_t)hd * heads,
                             (int64_t)hd * heads * seq};
  const int64_t given[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = 2 * (cuuint64_t)(dims[i + 1] == 1 ? packed[i] : given[i]);
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Kh, int Sq, int Sk, const int64_t* st, int causal,
           int window, float scale, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODER_MISSING;
  CUtensorMap qm, km, vm;
  CUresult r = make_map(enc, &qm, q, HD, H, Sq, B, st[0], st[1], st[2], BM);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &km, k, HD, Kh, Sk, B, st[3], st[4], st[5], BN);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &vm, v, HD, Kh, Sk, B, st[6], st[7], st[8], BN);
  if (r != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(r);
  auto kern = flash_fwd_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<HD>::ALLOC);
  if (err != cudaSuccess) return err;
  // one resident block per SM walks the work items
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int items = B * H * ((Sq + BM - 1) / BM);
  kern<<<sms < items ? sms : items, NT, Layout<HD>::ALLOC, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, H, Kh, Sq, Sk, st[9],
      st[10], st[11], causal, window, scale * LOG2E, B * H);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 int64 element strides,
// (batch, seq, head) for q, k, v and o in that order; the head dim is
// contiguous.  window <= 0 means no window.  Returns a cudaError_t code, or
// ENCODER_MISSING / ENCODE_FAILED + CUresult.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int dtype, int B, int H, int Kh, int Sq, int Sk,
              int hd, const int64_t* strides, int causal, int window,
              float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (route_of(dtype, hd))
    return hd == 64 ? tc::launch<64>(q, k, v, o, l, B, H, Kh, Sq, Sk, strides,
                                     causal, window, scale, s)
                    : tc::launch<128>(q, k, v, o, l, B, H, Kh, Sq, Sk,
                                      strides, causal, window, scale, s);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, l, B, H, Kh, Sq, Sk, strides,
                           causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, l, B, H, Kh, Sq, Sk,
                                   strides, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

// 1 if flash_fwd runs (dtype, hd) on the tensor cores, 0 on the CUDA cores.
int flash_fwd_route(int dtype, int hd) { return route_of(dtype, hd); }

const char* flash_fwd_error_string(int code) {
  if (code == ENCODER_MISSING)
    return "cuTensorMapEncodeTiled not found in the driver";
  if (code >= ENCODE_FAILED)
    return "cuTensorMapEncodeTiled refused a map (code - 20000 is the "
           "CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
