// Mamba2 SSD chunk scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel
// (launched by ssd_scan_kernel through pl.pallas_call).
//
// It computes the same function.  For x (Bs,S,nh,hp), dt (Bs,S,nh) f32,
// A (nh,) f32 and B/C (Bs,S,g,N), with head h reading group h / (nh/g), the
// sequence is cut into chunks of Q rows, and per chunk:
//   la   = cumsum(dt * A) over the chunk, in f32;
//   y_i  = sum_{j<=i} (C_i . B_j) exp(la_i - la_j) dt_j x_j       (intra)
//        + exp(la_i) C_i . h                                     (inter)
//   h   <- exp(la_last) h + sum_j x_j exp(la_last - la_j) dt_j B_j^T
// It returns y in x's dtype and the final state h (Bs,nh,hp,N) in f32.  The
// exponent is masked, never the product: exp(la_i - la_j) is taken only
// for j <= i, since the upper triangle overflows to inf and inf * 0 is NaN.
// A chunk shorter than Q (the tail of a ragged S) is handled in the kernel:
// its missing rows are zeros and la_last is taken at its last row, which is
// what the reference's zero-dt padding gives, so no pad copy is made.  Rows
// with dt = 0 (the engine's right-padded prompts) add nothing and decay
// nothing, so the state stays frozen at the last real token.
//
// What bounds it on this card.  At the serving prefill shape (Bs 8, S 2048,
// nh 80, hp 64, g 1, N 128, Q 256) the function needs ~65 GFLOP against
// ~0.37 GB of x, dt, B, C, y and h_final: it is bound by bytes (~0.11 ms at
// 3.35 TB/s).  Neither route gets near that.  The tensor-core route does
// ~3x the function's operations (the hi/lo products below, and C B^T once
// a head and a 64-column slab of it) and is bound by the chain of each
// (batch, head, slab) through its chunks: each chunk's inter term waits
// for the last chunk's state, each 64-row tile's products wait for its
// decay matrix, and that math (an exponential an entry, the hi/lo splits)
// runs on two consumer warps a scheduler, far from the tensor cores' rate;
// with one item a block and one block an SM, 640 items fill 4.8 waves of
// the card at that shape, and 160 (Bs 2) or 80 (Bs 1) leave SMs idle.
// The CUDA-core route is bound by shared-memory bandwidth and the one
// block an SM its f32 tiles allow.
//
// What the design does about it.  The TPU kernel walks a sequential grid
// (batch, head block, chunk) and carries h in VMEM scratch between grid
// steps.  On the GPU one block owns one (batch, head) -- on the tensor-core
// route one 64-column slab of its head dim -- and loops over the chunks in
// order itself, keeping h in shared memory as f32.  The TPU kernel holds a
// whole chunk's Q x Q matrix in VMEM; at Q = 256 that is 256 KB of f32,
// more than a block's 227 KB, so here the chunk is cut into 64-row tiles
// and only the column tiles at or below the diagonal are multiplied.
// Inputs are read through their strides (x, B and C are views of the
// mixer's convolution output), so no contiguous or per-head copy of B and
// C is made.
//
// Two routes, chosen by an explicit table on (dtype, hp, N) (route_of
// below), never after a failure:
//
// * tensor cores, bf16 at hp 64 and 128 with N a multiple of 16 up to 128
//   (tc::ssd_scan_wgmma): wgmma fed by TMA, the shape of the flash
//   forward's (flash_fwd.cu).  A work item is one 64-column slab of one
//   (batch, head): hp 128 is two items, each with the whole of C B^T and
//   the decay matrix (y and h of a slab need x of that slab alone), so
//   every item has the same registers and shared memory.  A block is two
//   consumer warpgroups and a producer warpgroup (setmaxnreg: 232 and 40
//   registers).  The producer's first warp keeps TMA loads in flight: each
//   pass's C row tiles (two slots a consumer) and a 3-stage ring of B and
//   x column tiles, all by 4-D maps over the strided tensors, (N, g, S, Bs)
//   and (hp, nh, S, Bs), 128-byte swizzled, rows past S zero-filled, each
//   completed on an mbarrier.  Its second warp reads dt and takes the
//   chunk's la and the state update's weights w a chunk ahead into a
//   2-slot ring.  A chunk of nt row tiles
//   runs in ceil(nt / 2) passes: pass p gives row tiles 2p and 2p + 1 to
//   the two consumers (the longer one to warpgroup p % 2, so each does
//   about half of the chunk) and streams column tiles 0 .. 2p + 1 past
//   both; the last pass streams them all, for the state update.  Per row
//   tile i, each consumer:
//   - inter, with G of the first column tile: y = exp(la_i) (C_i h_hi^T +
//     C_i h_lo^T), wgmma m64n64k16 with C K-major and h^T's bf16 hi and lo
//     parts MN-major in shared memory (a single rounding of h would repeat
//     one error in every row of the chunk); the row scale is applied in
//     f32.  h^T's parts start at zero, so the first chunk's term is 0;
//   - intra, per column tile j <= i: G = C_i B_j^T, wgmma with C and B
//     K-major, the bf16 inputs as stored: exact products, f32 sums.  M =
//     G exp(la_i - la_j) dt_j is made in G's accumulator registers, split
//     into bf16 hi + lo (M rounded once to bf16 misses y's tolerance ~4-5x
//     where cancellation leaves y small: unlike softmax's P it is not
//     normalised) and used as the A fragments of y += M_hi x + M_lo x
//     (wgmma from registers, x MN-major).  A tile off the diagonal and
//     inside the chunk skips the mask; elsewhere the exponent is masked to
//     -inf by selects.
//   A column tile's math comes first (M; the state update's fragments),
//   then its products go to the tensor cores in one batch -- y += M x, G
//   of the next tile, the state product -- which the consumer waits for;
//   the other consumer's math runs under it.  No wgmma is in flight while
//   other instructions write registers, and every branch around a wgmma is
//   on values the compiler sees as warp-uniform: otherwise ptxas
//   serializes every wgmma of the kernel (C7515, C7520).  G of tile j + 1
//   issued before M_j's exponentials needs a second G accumulator, which
//   spills at 232 registers and measured 1.4x slower on an H100.
//   The state update runs in the last pass, as each column tile passes:
//   the consumer that owns a 64-row box of h^T (rows n, columns p) makes
//   h^T += (w B)^T x with w_j = exp(la_last - la_j) dt_j, (w B)^T read from
//   the staged B tile by ldmatrix.trans and split into bf16 hi + lo A
//   fragments, x MN-major; each column tile's product goes to a fresh
//   accumulator and is added to h by f32 adds (the tensor cores' f32 sums
//   do not round to nearest, and h's chain runs over every row of every
//   chunk).  After the chunk both consumers meet at a named barrier, the
//   owners rebuild h^T's bf16 hi and lo boxes, and meet again.  A column
//   tile's rows past the chunk (Q not a multiple of 64) meet zero weights
//   in both products.  About 207 KB of shared memory at Q 256: one block
//   an SM.
// * CUDA cores, f32 and every other shape (ssd_scan_kernel): the products
//   as f32 FMAs, tiles staged as f32, h, B, C, x and the decay tile in
//   shared memory, 16 x 16 threads a block; the state update in a second
//   walk over the chunk's column tiles, after every row tile has read the
//   old h.  C B^T is computed once per head instead of once per group on
//   both routes.
//
// No atomics and a fixed order on both routes: two launches are bitwise
// equal.  One C B^T shared by a group's heads and the chunk-parallel split
// (chunk states, a state pass, outputs) are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no -lcuda: cuTensorMapEncodeTiled is fetched
//        from the driver at run time)
// C interface (loaded with ctypes): ssd_scan(...) returns cudaGetLastError()
// after the launch, or a code >= 10000 if a tensor map could not be made;
// ssd_scan_error_string(code) names it; ssd_scan_route(dtype, hp, N) says
// which route a call takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../flash_attention/csrc/hopper.cuh"

namespace {

constexpr int TR = 64;       // chunk rows per tile
constexpr int NT = 256;      // threads per block: 16 x 16
constexpr int LDM = TR + 1;  // odd row stride of the decay-matrix tile
constexpr int NMAX = 128;    // widest state (d_state) taken
constexpr int QMAX = 1024;   // longest chunk taken

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage TR rows of `width` contiguous elements (row stride `rs`) into
// shared memory as f32, `cols` columns per row with leading dimension `ld`.
// Rows at or past `valid` and columns at or past `width` are zero.  Each
// row is scaled by rowmul[r] when rowmul is given.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, int cols,
                                      const T* src, int64_t rs, int width,
                                      int valid, const float* rowmul) {
  for (int idx = threadIdx.x; idx < TR * cols; idx += NT) {
    const int r = idx / cols;
    const int c = idx - r * cols;
    float v = 0.f;
    if (r < valid && c < width) {
      v = to_f32(src[(int64_t)r * rs + c]);
      if (rowmul != nullptr) v *= rowmul[r];
    }
    dst[r * ld + c] = v;
  }
}

// la = cumsum(dt * A) over the Qc rows of a chunk, dt in ws; called by
// one warp: each lane a run of rows, then an exclusive shuffle scan of the
// runs' sums.
__device__ __forceinline__ void log_decay(const float* ws, float* la, int Qc,
                                          float Ah, int lane) {
  const int per = (Qc + 31) / 32;
  const int lo = lane * per;
  const int hi = min(lo + per, Qc);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += ws[i] * Ah;
    la[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float base = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) base = 0.f;
  for (int i = lo; i < hi; ++i) la[i] += base;
}

template <typename T, int HPT>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ hout, int S, int nh, int g, int N, int Q,
                int64_t xsb, int64_t xss, int64_t xsh,
                int64_t dsb, int64_t dss, int64_t dsh,
                int64_t bsb, int64_t bss, int64_t bsg,
                int64_t csb, int64_t css, int64_t csg) {
  constexpr int HP = 16 * HPT;     // head dim; thread owns columns tx + 16c
  const int NW = (N + 15) & ~15;   // state width, zero-padded to 16
  const int NB = NW / 16;          // state columns per thread
  const int LDN = NW + 1;          // odd row stride: no bank conflicts
  extern __shared__ float smem[];
  float* hs = smem;                // HP x LDN: the carried state h[p][n]
  float* Cs = hs + HP * LDN;       // TR x LDN: C rows of the row tile
  float* Bs = Cs + TR * LDN;       // TR x LDN: B rows of a column tile
  float* Xs = Bs + TR * LDN;       // TR x HP:  x rows of a column tile
  float* Ms = Xs + TR * HP;        // TR x LDM: masked decay matrix tile
  float* la = Ms + TR * LDM;       // Q: cumulative log decay of the chunk
  float* ws = la + Q;              // Q: dt, then the state-update weights

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int grp = h / (nh / g);
  const float Ah = A[h];
  const T* xb = x + b * xsb + h * xsh;
  const float* db = dt + b * dsb + h * dsh;
  const T* Bb = Bm + b * bsb + grp * bsg;
  const T* Cb = Cm + b * csb + grp * csg;
  const int64_t yss = (int64_t)nh * HP;            // y is contiguous
  T* yb = y + (int64_t)b * S * yss + (int64_t)h * HP;

  for (int i = tid; i < HP * LDN; i += NT) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int Qc = min(Q, S - c0);
    const int ntiles = (Qc + TR - 1) / TR;
    __syncthreads();   // the previous chunk is done with la and ws
    for (int i = tid; i < Qc; i += NT) ws[i] = db[(int64_t)(c0 + i) * dss];
    __syncthreads();
    if (tid < 32) log_decay(ws, la, Qc, Ah, tid);

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * TR;
      // the previous row tile is done with Cs (and, through the sync below,
      // with Bs, Xs and Ms)
      __syncthreads();
      stage(Cs, LDN, NW, Cb + (int64_t)(c0 + i0) * css, css, N, Qc - i0,
            static_cast<const float*>(nullptr));
      __syncthreads();

      // inter: acc = exp(la_i) C_i . h_p for rows ty + 16a, columns tx + 16c
      float acc[4][HPT];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < HPT; ++c) acc[a][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[HPT];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LDN + n];
#pragma unroll
        for (int c = 0; c < HPT; ++c) hv[c] = hs[(tx + 16 * c) * LDN + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < HPT; ++c)
            acc[a][c] = fmaf(cv[a], hv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float e = i < Qc ? expf(la[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < HPT; ++c) acc[a][c] *= e;
      }

      // intra: the column tiles at or below the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TR;
        if (jt > 0) __syncthreads();   // the last tile's Bs, Xs, Ms are read
        stage(Bs, LDN, NW, Bb + (int64_t)(c0 + j0) * bss, bss, N, Qc - j0,
              static_cast<const float*>(nullptr));
        stage(Xs, HP, HP, xb + (int64_t)(c0 + j0) * xss, xss, HP, Qc - j0,
              static_cast<const float*>(nullptr));
        __syncthreads();
        // G = C B^T for rows ty + 16a, columns tx + 16e
        float gm[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) gm[a][e] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LDN + n];
#pragma unroll
          for (int e = 0; e < 4; ++e) bv[e] = Bs[(tx + 16 * e) * LDN + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              gm[a][e] = fmaf(cv[a], bv[e], gm[a][e]);
        }
        // M = G exp(la_i - la_j) dt_j on j <= i < Qc, else 0 (masked
        // before the exponent is taken)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + tx + 16 * e;
            float m = 0.f;
            if (j <= i && i < Qc) m = gm[a][e] * expf(la[i] - la[j]) * ws[j];
            Ms[(ty + 16 * a) * LDM + tx + 16 * e] = m;
          }
        }
        __syncthreads();
        // acc += M x
#pragma unroll 4
        for (int jj = 0; jj < TR; ++jj) {
          float mv[4], xv[HPT];
#pragma unroll
          for (int a = 0; a < 4; ++a) mv[a] = Ms[(ty + 16 * a) * LDM + jj];
#pragma unroll
          for (int c = 0; c < HPT; ++c) xv[c] = Xs[jj * HP + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < HPT; ++c)
              acc[a][c] = fmaf(mv[a], xv[c], acc[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= Qc) continue;
        T* row = yb + (int64_t)(c0 + i) * yss;
#pragma unroll
        for (int c = 0; c < HPT; ++c) store(row + tx + 16 * c, acc[a][c]);
      }
    }

    // state update, after every row tile has read the old h
    __syncthreads();
    const float la_last = la[Qc - 1];
    for (int j = tid; j < Qc; j += NT) ws[j] = expf(la_last - la[j]) * ws[j];
    // rows p = ty + 16a, columns n = tx + 16e (e < NB)
    float sacc[HPT][NMAX / 16];
#pragma unroll
    for (int a = 0; a < HPT; ++a)
#pragma unroll
      for (int e = 0; e < NMAX / 16; ++e) sacc[a][e] = 0.f;
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * TR;
      __syncthreads();   // ws is ready; the last tile's Bs and Xs are read
      stage(Bs, LDN, NW, Bb + (int64_t)(c0 + j0) * bss, bss, N, Qc - j0,
            static_cast<const float*>(nullptr));
      stage(Xs, HP, HP, xb + (int64_t)(c0 + j0) * xss, xss, HP, Qc - j0,
            ws + j0);
      __syncthreads();
#pragma unroll 2
      for (int jj = 0; jj < TR; ++jj) {
        float xv[HPT], bv[NMAX / 16];
#pragma unroll
        for (int a = 0; a < HPT; ++a) xv[a] = Xs[jj * HP + ty + 16 * a];
#pragma unroll
        for (int e = 0; e < NMAX / 16; ++e)
          bv[e] = e < NB ? Bs[jj * LDN + tx + 16 * e] : 0.f;
#pragma unroll
        for (int a = 0; a < HPT; ++a)
#pragma unroll
          for (int e = 0; e < NMAX / 16; ++e)
            sacc[a][e] = fmaf(xv[a], bv[e], sacc[a][e]);
      }
    }
    const float decay = expf(la_last);
#pragma unroll
    for (int a = 0; a < HPT; ++a)
#pragma unroll
      for (int e = 0; e < NMAX / 16; ++e) {
        if (e >= NB) continue;
        float* hp_ = hs + (ty + 16 * a) * LDN + tx + 16 * e;
        *hp_ = decay * *hp_ + sacc[a][e];
      }
  }

  __syncthreads();
  float* hb = hout + ((int64_t)b * nh + h) * HP * N;
  for (int idx = tid; idx < HP * N; idx += NT)
    hb[idx] = hs[(idx / N) * LDN + idx % N];
}

size_t smem_bytes(int hp, int N, int Q) {
  const int NW = (N + 15) & ~15;
  return sizeof(float) * ((size_t)hp * (NW + 1) + 2 * (size_t)TR * (NW + 1) +
                          (size_t)TR * hp + (size_t)TR * LDM + 2 * (size_t)Q);
}

template <typename T, int HPT>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, void* y, float* hout,
                   int Bs, int S, int nh, int g, int N, int Q,
                   const int64_t* st, cudaStream_t stream) {
  const size_t smem = smem_bytes(16 * HPT, N, Q);
  auto kern = ssd_scan_kernel<T, HPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<Bs * nh, NT, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), hout, S, nh, g, N, Q,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hp, const void* x, const float* dt, const float* A,
                     const void* B, const void* C, void* y, float* hout,
                     int Bs, int S, int nh, int g, int N, int Q,
                     const int64_t* st, cudaStream_t stream) {
#define CASE(HPT)                                                          \
  case 16 * HPT:                                                           \
    return launch<T, HPT>(x, dt, A, B, C, y, hout, Bs, S, nh, g, N, Q, st, \
                          stream);
  switch (hp) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef CASE
}

// route_of(dtype, hp, N): 1 for the tensor-core route, 0 for the CUDA cores.
// The same table is kernel.route in Python (a test holds the two together).
int route_of(int dtype, int hp, int N) {
  return dtype == 1 && (hp == 64 || hp == 128) && N % 16 == 0 && N >= 16 &&
         N <= NMAX;
}

// ---------------------------------------------------------------------------
// The tensor-core route: bf16 at hp 64 and 128, N a multiple of 16 up to 128.
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int STAGES = 3;        // B and x column tiles in flight
constexpr int NTH = 384;         // consumer warpgroups 0 and 1, producer 2
constexpr int CONSUMERS = 256;
constexpr int TILE = TR * BOX;   // bytes of one box: 64 rows x 64 bf16

// The f32 h^T: N rows of the slab's 64 columns, element (n, p) at n * 64 +
// (p ^ 8 (n % 4)), so that the float2 accesses of the accumulator layout
// (four rows of eight columns a half-warp) hit 32 different banks.
__device__ __forceinline__ int hf_at(int n, int p) {
  return n * TR + (p ^ ((n & 3) << 3));
}

// Shared memory from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows of 128 bytes): the ring of column tiles (per stage two boxes
// of B's N columns, then one box of x's slab), four C row tiles of two
// boxes (two slots a consumer), h^T's bf16 hi and lo parts (N rows of the
// slab's 64 columns, one box each), the f32 h^T (N rows of 64), the ring
// of la, dt and the state update's weights w (two chunks, Q rounded up to
// 64 each), then the barriers.
struct Layout {
  static constexpr int STAGE = 3 * TILE;
  static constexpr int C_OFF = STAGES * STAGE;
  static constexpr int H_HI = C_OFF + 4 * 2 * TILE;
  static constexpr int H_LO = H_HI + NMAX * BOX;
  static constexpr int H_F32 = H_LO + NMAX * BOX;
  static constexpr int LA = H_F32 + NMAX * TR * 4;
  static constexpr int N_BARS = 2 * STAGES + 4 + 4 + 2 + 2;
  static __host__ __device__ int qr(int Q) { return (Q + TR - 1) / TR * TR; }
  static __host__ __device__ int bars(int Q) { return LA + 2 * 3 * qr(Q) * 4; }
  static int alloc(int Q) { return bars(Q) + 8 * N_BARS + 1024; }
};

// Row tile of consumer w in pass p: pass p takes the pair 2p, 2p + 1, and
// the longer (2p + 1, one more column tile) goes to consumer p % 2.
__device__ __forceinline__ int row_tile(int p, int w) {
  return 2 * p + (w == (p & 1));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four 8 x 8 b16 matrices, transposed: lane l gives the address of row
// l % 8 of matrix l / 8, and register m receives matrix m
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}

// bf16 hi and lo parts of two f32 values, packed pairwise (the first in
// the low half): a = hi + lo to ~2**-17 of a
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// D (64 x 64) (+)= A (64 x 16) * B (16 x 64): A in shared memory K-major,
// B in shared memory MN-major (the transpose bit set); f32 accumulate; D is
// zeroed when !accumulate
__device__ __forceinline__ void wgmma_ss_tb_n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Register fragments of one consumer thread (m64n64 accumulator layout):
// element e of a 64 x 64 tile is row 16 warp + lane / 4 + 8 ((e % 4) / 2),
// column 8 (e / 4) + 2 (lane % 4) + (e % 2); pairs (e, e + 1), e even,
// share a row.  Columns 16 kk .. 16 kk + 15 are the A fragments 4 kk ..
// 4 kk + 3 of a product over them.
__device__ __forceinline__ int frag_half(int e) { return (e >> 1) & 1; }
__device__ __forceinline__ int frag_col(int e, int t4) {
  return 8 * (e >> 2) + 2 * t4;
}

// M = G exp(la_i - la_j) dt_j on j <= i < Qc, else 0, split into bf16 hi +
// lo A fragments.  Where `edge` (a tile on the diagonal or crossing the
// chunk's end) the exponent is masked to -inf, as the reference masks it,
// by selects: a branch a element would serialize the chains.  r0: this
// thread's first row (and r0 + 8) in the chunk; j0: the column tile's
// first row.
__device__ __forceinline__ void decay_matrix(const float (&gc)[32],
                                             const float* la, const float* ds,
                                             int r0, int j0, int Qc, int t4,
                                             bool edge, uint32_t (&mh)[16],
                                             uint32_t (&ml)[16]) {
  const float l0 = la[r0], l1 = la[r0 + 8];
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int ir = r0 + 8 * frag_half(e);
    const int jc = j0 + frag_col(e, t4);
    const float li = frag_half(e) ? l1 : l0;
    const float2 lj = *reinterpret_cast<const float2*>(la + jc);
    const float2 dj = *reinterpret_cast<const float2*>(ds + jc);
    float a0 = li - lj.x, a1 = li - lj.y;
    if (edge) {
      a0 = jc <= ir && ir < Qc ? a0 : -__builtin_huge_valf();
      a1 = jc + 1 <= ir && ir < Qc ? a1 : -__builtin_huge_valf();
    }
    split(gc[e] * __expf(a0) * dj.x, gc[e + 1] * __expf(a1) * dj.y,
          mh[e >> 1], ml[e >> 1]);
  }
}

// The A fragments of (w B)^T over one column tile for the state update:
// rows n = 16 warp .. 16 warp + 15 of the B box at `box` (shared address),
// columns j (k16 step ks: rows 16 ks .. 16 ks + 15 of the tile) read by
// ldmatrix.trans through the 128-byte swizzle, each scaled by w_j =
// exp(la_last - la_j) dt_j (0 past the chunk) and split into hi + lo.
__device__ __forceinline__ void state_fragments(uint32_t box, const float* ws,
                                                int j0, int warp, int lane,
                                                uint32_t (&fh)[16],
                                                uint32_t (&fl)[16]) {
  const int jr = (lane & 7) + ((lane >> 4) << 3);
  const int ch = 2 * warp + ((lane >> 3) & 1);
  const int t4 = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int row = 16 * ks + jr;
    uint32_t r[4];
    ldsm_t(r, box + row * BOX + ((ch ^ (row & 7)) << 4));
    // the weights of rows j0 + 16 ks + 2 t4 + {0, 1, 8, 9}
    const float2 w01 =
        *reinterpret_cast<const float2*>(ws + j0 + 16 * ks + 2 * t4);
    const float2 w89 =
        *reinterpret_cast<const float2*>(ws + j0 + 16 * ks + 2 * t4 + 8);
    const float w[4] = {w01.x, w01.y, w89.x, w89.y};
    // registers 0 and 1 hold columns j 2 t4, 2 t4 + 1; 2 and 3 those + 8
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = unpack(r[q]);
      const int k = (q >> 1) * 2;
      split(v.x * w[k], v.y * w[k + 1], fh[4 * ks + q], fl[4 * ks + q]);
    }
  }
}

// One block per work item (batch, head, 64-column slab of the head dim);
// see the header for the design.
__global__ void __launch_bounds__(NTH, 1)
ssd_scan_wgmma(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap bmap,
               const __grid_constant__ CUtensorMap cmap,
               const float* __restrict__ dt, const float* __restrict__ A,
               bf16* __restrict__ y, float* __restrict__ hout, int S, int nh,
               int hp, int g, int N, int Q, int64_t dsb, int64_t dss,
               int64_t dsh) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);
  const int slabs = hp / TR;
  const int slab = blockIdx.x % slabs;
  const int bh = blockIdx.x / slabs;   // batch * nh + head
  const int b = bh / nh, h = bh % nh;
  const int grp = h / (nh / g);
  const int nbn = (N + TR - 1) / TR;   // boxes of a B or C row
  const int nk = N / 16;               // k16 steps over the state
  const int QR = Layout::qr(Q);
  float* la_ring = reinterpret_cast<float*>(sm + Layout::LA);
  float* hf = reinterpret_cast<float*>(sm + Layout::H_F32);
  const uint32_t bar0 = base + Layout::bars(Q);
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };
  auto c_full = [&](int k) { return bar0 + 8 * (2 * STAGES + k); };
  auto c_empty = [&](int k) { return bar0 + 8 * (2 * STAGES + 4 + k); };
  auto la_full = [&](int k) { return bar0 + 8 * (2 * STAGES + 8 + k); };
  auto la_empty = [&](int k) { return bar0 + 8 * (2 * STAGES + 10 + k); };
  auto ring = [&](int s) { return base + s * Layout::STAGE; };
  // warpgroup and warp, broadcast so that the compiler sees them uniform
  // (a branch on a value it takes for divergent makes ptxas serialize the
  // wgmmas under it)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    for (int k = 0; k < 4; ++k) {
      mbar_init(c_full(k), 1);
      mbar_init(c_empty(k), 128);
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(la_full(k), 32);
      mbar_init(la_empty(k), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0 && lane == 0) {
      // the loads, in the order the consumers take them: per pass the C
      // row tiles of both consumers, then the column tiles
      int t = 0;              // column tiles loaded: the ring position
      int cn[2] = {0, 0};     // C tiles loaded for each consumer
      for (int c0 = 0; c0 < S; c0 += Q) {
        const int nt = (min(Q, S - c0) + TR - 1) / TR;
        for (int p = 0; p < (nt + 1) / 2; ++p) {
          for (int w = 0; w < 2; ++w) {
            const int i = row_tile(p, w);
            if (i >= nt) continue;
            const int k = 2 * w + (cn[w] & 1);
            mbar_wait(c_empty(k), ((cn[w] >> 1) & 1) ^ 1);
            mbar_expect_tx(c_full(k), nbn * TILE);
            for (int bx = 0; bx < nbn; ++bx)
              tma_load(base + Layout::C_OFF + (2 * k + bx) * TILE, &cmap,
                       c_full(k), TR * bx, grp, c0 + TR * i, b);
            ++cn[w];
          }
          const int ncols = min(2 * p + 2, nt);
          for (int j = 0; j < ncols; ++j, ++t) {
            const int s = t % STAGES;
            mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
            mbar_expect_tx(full(s), (nbn + 1) * TILE);
            for (int bx = 0; bx < nbn; ++bx)
              tma_load(ring(s) + bx * TILE, &bmap, full(s), TR * bx, grp,
                       c0 + TR * j, b);
            tma_load(ring(s) + 2 * TILE, &xmap, full(s), TR * slab, h,
                     c0 + TR * j, b);
          }
        }
      }
    } else if (warp == 1) {
      // dt, la = cumsum(dt A) and w = exp(la_last - la) dt of each chunk,
      // a chunk ahead; zeros to the end of the last row tile
      const float Ah = A[h];
      const float* db = dt + b * dsb + h * dsh;
      int n = 0;
      for (int c0 = 0; c0 < S; c0 += Q, ++n) {
        const int Qc = min(Q, S - c0);
        const int R = (Qc + TR - 1) / TR * TR;
        const int k = n & 1;
        mbar_wait(la_empty(k), ((n >> 1) & 1) ^ 1);
        float* la = la_ring + 3 * k * QR;
        float* ds = la + QR;
        float* ws = ds + QR;
        for (int i = lane; i < Qc; i += 32)
          ds[i] = db[(int64_t)(c0 + i) * dss];
        __syncwarp();
        log_decay(ds, la, Qc, Ah, lane);
        __syncwarp();
        const float la_last = la[Qc - 1];
        for (int i = lane; i < R; i += 32) {
          if (i < Qc) {
            ws[i] = expf(la_last - la[i]) * ds[i];
          } else {
            la[i] = 0.f;
            ds[i] = 0.f;
            ws[i] = 0.f;
          }
        }
        mbar_arrive(la_full(k));
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int gr = lane / 4, t4 = lane % 4;
  // the consumer owns h^T rows 64 wg .. 64 wg + 63 (those at or past N stay
  // zeros: TMA fills B's columns past N with zeros): its entries (nrow0 + 8
  // frag_half(e), frag_col(e)) in the accumulator layout
  const bool own = TR * wg < N;
  const int nrow0 = TR * wg + 16 * warp + gr;
  const uint32_t sh_hi = base + Layout::H_HI, sh_lo = base + Layout::H_LO;
  const int64_t yss = (int64_t)nh * hp;   // y is contiguous
  bf16* yb = y + (int64_t)b * S * yss + (int64_t)h * hp + TR * slab;
  if (own) {
#pragma unroll
    for (int e = 0; e < 32; e += 2)
      *reinterpret_cast<float2*>(
          hf + hf_at(nrow0 + 8 * frag_half(e), frag_col(e, t4))) =
          make_float2(0.f, 0.f);
  }
  // h^T's bf16 parts start at zero too: the first chunk's inter term is
  // C 0 = 0, so y's accumulator is only ever written by wgmma and the
  // scale (a branch that zeroed it instead would make the compiler move
  // it between registers, and ptxas serialize every wgmma)
  for (int i = threadIdx.x; i < 2 * NMAX * BOX / 16; i += CONSUMERS)
    reinterpret_cast<uint4*>(sm + Layout::H_HI)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  consumers_sync();
  float yacc[32], gn[32], pacc[32];
  uint32_t mh[16], ml[16], fh[16], fl[16];
#pragma unroll
  for (int e = 0; e < 32; ++e) yacc[e] = gn[e] = pacc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) mh[e] = ml[e] = fh[e] = fl[e] = 0u;
  int t = 0;    // column tiles consumed: the ring position
  int cn = 0;   // C tiles consumed
  int n = 0;    // chunks
  for (int c0 = 0; c0 < S; c0 += Q, ++n) {
    const int Qc = min(Q, S - c0);
    const int nt = (Qc + TR - 1) / TR;
    const int P = (nt + 1) / 2;
    const int lk = n & 1;
    mbar_wait(la_full(lk), (n >> 1) & 1);
    const float* la = la_ring + 3 * lk * QR;
    const float* ds = la + QR;
    const float* ws = ds + QR;
    const float decay = expf(la[Qc - 1]);
    for (int p = 0; p < P; ++p) {
      const int i = row_tile(p, wg);
      const bool has = i < nt;
      const bool last = p == P - 1;
      const int ncols = min(2 * p + 2, nt);
      const int r0 = TR * i + 16 * warp + gr;   // rows r0 and r0 + 8
      int ck = 0;
      uint32_t ct = 0;
      if (has) {
        ck = 2 * wg + (cn & 1);
        ct = base + Layout::C_OFF + 2 * ck * TILE;
        mbar_wait(c_full(ck), (cn >> 1) & 1);
        ++cn;
        // inter, (C h_hi^T + C h_lo^T) exp(la_i), and G of the first
        // column tile
        const int s = t % STAGES;
        mbar_wait(full(s), (t / STAGES) & 1);
        pin(yacc);
        pin(gn);
        wgmma_fence();
        for (int kk = 0; kk < nk; ++kk)
          wgmma_ss_tb_n64(yacc, desc_k(ct, TR, 0, kk),
                          desc_mn(sh_hi, N, kk), kk > 0);
        for (int kk = 0; kk < nk; ++kk)
          wgmma_ss_tb_n64(yacc, desc_k(ct, TR, 0, kk),
                          desc_mn(sh_lo, N, kk), 1);
        for (int kk = 0; kk < nk; ++kk)
          wgmma_ss_n64(gn, desc_k(ct, TR, 0, kk), desc_k(ring(s), TR, 0, kk),
                       kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        pin(yacc);
        pin(gn);
        const float e0 = r0 < Qc ? expf(la[r0]) : 0.f;
        const float e1 = r0 + 8 < Qc ? expf(la[r0 + 8]) : 0.f;
#pragma unroll
        for (int e = 0; e < 32; ++e) yacc[e] *= frag_half(e) ? e1 : e0;
      }
      for (int j = 0; j < ncols; ++j, ++t) {
        // the tile's math, then its products in one batch, waited for
        const int s = t % STAGES;
        mbar_wait(full(s), (t / STAGES) & 1);
        const uint32_t xt = ring(s) + 2 * TILE;
        const bool intra = has && j <= i;
        const bool state = last && own;
        if (intra)
          decay_matrix(gn, la, ds, r0, TR * j, Qc, t4,
                       j == i || TR * i + TR > Qc, mh, ml);
        if (state)
          state_fragments(ring(s) + wg * TILE, ws, TR * j, warp, lane, fh,
                          fl);
        if (intra && j < i) {
          const int s1 = (t + 1) % STAGES;
          mbar_wait(full(s1), ((t + 1) / STAGES) & 1);
        }
        pin(mh);
        pin(ml);
        pin(fh);
        pin(fl);
        pin(yacc);
        pin(gn);
        wgmma_fence();
        if (intra) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs<64>(yacc, &mh[4 * kk], desc_mn(xt, TR, kk));
            wgmma_rs<64>(yacc, &ml[4 * kk], desc_mn(xt, TR, kk));
          }
          if (j < i) {
            const uint32_t bt1 = ring((t + 1) % STAGES);
            for (int kk = 0; kk < nk; ++kk)
              wgmma_ss_n64(gn, desc_k(ct, TR, 0, kk), desc_k(bt1, TR, 0, kk),
                           kk > 0);
          }
        }
        if (state) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            wgmma_rs<64>(pacc, &fh[4 * ks], desc_mn(xt, TR, ks), ks > 0);
            wgmma_rs<64>(pacc, &fl[4 * ks], desc_mn(xt, TR, ks));
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(yacc);
        pin(gn);
        pin(mh);
        pin(ml);
        pin(pacc);
        pin(fh);
        pin(fl);
        // C's last product (G of this tile) was done a tile ago
        if (intra && j == i) mbar_arrive(c_empty(ck));
        if (state) {
          // h = exp(la_last) h + the first tile's product, then + each
          // later tile's, by f32 adds (all loads before the stores, which
          // the compiler cannot tell apart)
          const float scale = j == 0 ? decay : 1.f;
          float2 v[16];
#pragma unroll
          for (int e = 0; e < 32; e += 2)
            v[e >> 1] = *reinterpret_cast<const float2*>(
                hf + hf_at(nrow0 + 8 * frag_half(e), frag_col(e, t4)));
#pragma unroll
          for (int e = 0; e < 32; e += 2)
            *reinterpret_cast<float2*>(
                hf + hf_at(nrow0 + 8 * frag_half(e), frag_col(e, t4))) =
                make_float2(v[e >> 1].x * scale + pacc[e],
                            v[e >> 1].y * scale + pacc[e + 1]);
        }
        mbar_arrive(empty(s));
      }
      if (has) {
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int ir = r0 + 8 * frag_half(e);
          if (ir < Qc)
            *reinterpret_cast<uint32_t*>(yb + (int64_t)(c0 + ir) * yss +
                                         frag_col(e, t4)) =
                pack_bf16(yacc[e], yacc[e + 1]);
        }
      }
    }
    mbar_arrive(la_empty(lk));
    if (c0 + Q < S) {
      // every inter term of this chunk has read h^T's bf16 parts: rebuild
      // them from the new h, then let the next chunk read them
      consumers_sync();
      if (own) {
        float2 v[16];
#pragma unroll
        for (int e = 0; e < 32; e += 2)
          v[e >> 1] = *reinterpret_cast<const float2*>(
              hf + hf_at(nrow0 + 8 * frag_half(e), frag_col(e, t4)));
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int nn = nrow0 + 8 * frag_half(e);
          const int pp = frag_col(e, t4);
          uint32_t hi, lo;
          split(v[e >> 1].x, v[e >> 1].y, hi, lo);
          const int off = nn * BOX + (((pp >> 3) ^ (nn & 7)) << 4) +
                          (pp & 7) * 2;
          *reinterpret_cast<uint32_t*>(sm + Layout::H_HI + off) = hi;
          *reinterpret_cast<uint32_t*>(sm + Layout::H_LO + off) = lo;
        }
      }
      fence_proxy_async();
      consumers_sync();
    }
  }

  if (own) {
    float* hb = hout + ((int64_t)bh * hp + TR * slab) * N;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int nn = nrow0 + 8 * frag_half(e);
      if (nn >= N) continue;
      const int pp = frag_col(e, t4);
      const float2 v = *reinterpret_cast<const float2*>(hf + hf_at(nn, pp));
      hb[(int64_t)pp * N + nn] = v.x;
      hb[(int64_t)(pp + 1) * N + nn] = v.y;
    }
  }
}

int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, void* y, float* hout, int Bs, int S, int nh,
           int hp, int g, int N, int Q, const int64_t* st,
           cudaStream_t stream) {
  // TMA reads x, B and C: 16-byte aligned bases, and strides of whole 16
  // bytes on every dim longer than 1 (make_map gives a dim of size 1 the
  // packed stride)
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(B) |
                         reinterpret_cast<uintptr_t>(C);
  if (addr % 16) return cudaErrorMisalignedAddress;
  const int dims[12] = {Bs, S, nh, 0, 0, 0, Bs, S, g, Bs, S, g};
  for (int i = 0; i < 12; ++i)
    if (dims[i] > 1 && st[i] % 8) return cudaErrorMisalignedAddress;
  if (hp % TR || (int64_t)Bs * nh * (hp / TR) > 0x7fffffff)
    return cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODER_MISSING;
  CUtensorMap xm, bm, cm;
  CUresult r = make_map(enc, &xm, x, hp, nh, S, Bs, st[0], st[1], st[2], TR);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &bm, B, N, g, S, Bs, st[6], st[7], st[8], TR);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &cm, C, N, g, S, Bs, st[9], st[10], st[11], TR);
  if (r != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(r);
  const int smem = Layout::alloc(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan_wgmma<<<Bs * nh * (hp / TR), NTH, smem, stream>>>(
      xm, bm, cm, dt, A, static_cast<bf16*>(y), hout, S, nh, hp, g, N, Q,
      st[3], st[4], st[5]);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt and A are f32.
// strides: 12 int64 element strides, (batch, seq, head) for x and dt and
// (batch, seq, group) for B and C; the last dim of x, B and C is contiguous.
// y (Bs,S,nh,hp) and h_final (Bs,nh,hp,N) are contiguous.  The route is
// route_of's; the tensor-core route needs x, B and C 16-byte aligned with
// strides of whole 16 bytes on every dim longer than 1 (else
// cudaErrorMisalignedAddress).  Returns a cudaError_t code, or
// hopper::ENCODER_MISSING / ENCODE_FAILED + CUresult.
int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
             const void* C, void* y, void* h_final, int dtype, int Bs, int S,
             int nh, int hp, int g, int N, int Q, const int64_t* strides,
             void* stream) {
  if (Bs < 1 || S < 1 || g < 1 || nh < g || nh % g || N < 1 || N > NMAX ||
      Q < 1 || Q > QMAX || (int64_t)Bs * nh > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  float* hf = static_cast<float*>(h_final);
  if (route_of(dtype, hp, N))
    return tc::launch(x, d, a, B, C, y, hf, Bs, S, nh, hp, g, N, Q, strides,
                      s);
  if (dtype == 0)
    return dispatch<float>(hp, x, d, a, B, C, y, hf, Bs, S, nh, g, N, Q,
                           strides, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hp, x, d, a, B, C, y, hf, Bs, S, nh, g,
                                   N, Q, strides, s);
  return cudaErrorInvalidValue;
}

int ssd_scan_route(int dtype, int hp, int N) {
  return route_of(dtype, hp, N);
}

const char* ssd_scan_error_string(int code) {
  return hopper::error_string(code);
}

}  // extern "C"
