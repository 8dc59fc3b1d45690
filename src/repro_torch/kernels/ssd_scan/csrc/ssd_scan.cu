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
// exponent is masked, never the product: exp(la_i - la_j) is evaluated only
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
// 3.35 TB/s).  Both routes run far from that: the tensor-core route is
// bound by the latency of each tile's chain (C B^T, the masked decay, the
// products) with two blocks of eight warps an SM, and by its 640 blocks
// filling 2.4 waves of the card at that shape; the CUDA-core route by
// shared-memory bandwidth and the one block an SM its f32 tiles allow.
//
// What the design does about it.  The TPU kernel walks a sequential grid
// (batch, head block, chunk) and carries h in VMEM scratch between grid
// steps.  On the GPU one block owns one (batch, head) and loops over the
// chunks in order itself, keeping h (hp x N f32, 32 KB at 64 x 128) in
// shared memory.  The TPU kernel holds a whole chunk's Q x Q matrix in
// VMEM; at Q = 256 that is 256 KB of f32, more than a block's 227 KB, so
// here the chunk is cut into row tiles of 64: each row tile stages its C
// rows once, takes the inter term from h, then walks only the column tiles
// at or below the diagonal (C B^T, the masked decay, the product with x).
// The state update follows in a second walk over the chunk's column tiles,
// after every row tile has read the old h.  Inputs are read through their
// strides (x, B and C are views of the mixer's convolution output), so no
// contiguous or per-head copy of B and C is made.
//
// Two routes, chosen by an explicit table on (dtype, hp, N) (route_of
// below), never after a failure:
//
// * tensor cores, bf16 at hp 64 and 128 with N a multiple of 16 up to 128
//   (tc::ssd_scan_mma).  The same structure, with every product on
//   warp-level mma.sync.m16n8k16 (bf16 in, f32 sums): eight warps, each 16
//   rows and half the columns of a 64 x 64 tile (the two halves' y summed
//   once a row tile, through shared memory), and in the state update each a
//   16-column block of h.  C, B and x tiles are staged as bf16 by 16-byte
//   cp.async (the next column tile's B and x in flight under this one's
//   products; rows past a ragged tail zero-filled) and read into fragments
//   by ldmatrix; h stays f32 in shared memory.  About 105 KB a block at
//   hp 64, N 128, Q 256: two blocks share an SM.  Numerics, since h_final
//   is held to an f32 tolerance:
//   - G = C B^T multiplies bf16 inputs as stored: exact products, f32 sums;
//   - M = G exp(la_i - la_j) dt_j is made in G's accumulator registers,
//     split into bf16 hi + lo parts and used in place as the A fragments of
//     M x (the m16n8k16 accumulator of two n8 tiles is the A layout of one
//     k16 step); x is the B fragment, by ldmatrix.trans.  M rounded once
//     to bf16 misses y's tolerance ~4-5x where cancellation leaves y small:
//     unlike softmax's P, M is not normalised, and its rounding errors
//     scale with |M| |x|;
//   - inter multiplies C by h split into bf16 hi + lo parts (a single
//     rounding of h would repeat one error in every row of the chunk); the
//     row scale exp(la_i) is applied in f32 to the product;
//   - the state update multiplies x^T (exact bf16, ldmatrix.trans) by
//     w_j B_j, w_j = exp(la_last - la_j) dt_j, split into bf16 hi + lo;
//     each 64-row column tile's product goes to a fresh accumulator and is
//     added to h by f32 adds (the tensor cores' f32 sums do not round to
//     nearest, and h's chain runs over every row of every chunk).
// * CUDA cores, f32 and every other shape (ssd_scan_kernel): the products
//   as f32 FMAs, tiles staged as f32.  C B^T is computed once per head
//   instead of once per group on both routes.
//
// No atomics and a fixed order on both routes: two launches are bitwise
// equal.  Wgmma with TMA, one C B^T shared by a group's heads and the
// chunk-parallel split (chunk states, a state pass, outputs) are left for
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC
// C interface (loaded with ctypes): ssd_scan(...) returns cudaGetLastError()
// after the launch; ssd_scan_error_string(code) names it;
// ssd_scan_route(dtype, hp, N) says which route a call takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// warp 0: each lane a run of rows, then an exclusive shuffle scan of the
// runs' sums.
__device__ __forceinline__ void log_decay(const float* ws, float* la, int Qc,
                                          float Ah) {
  const int lane = threadIdx.x;
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
    if (tid < 32) log_decay(ws, la, Qc, Ah);

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
// The tensor-core route: bf16 at hp 64 and 128, N a multiple of 16.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NWARP = 8;  // warps: 16 rows and half the columns of a tile
constexpr int NTH = 32 * NWARP;
constexpr int PAD = 8;             // row padding, elements: 16 bytes of bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and register m receives matrix m (transposed with .trans)
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// two f32 values as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return as_u32(__floats2bfloat162_rn(a, b));
}
__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}
// bf16 hi and lo parts of two f32 values: v = hi + lo to ~2**-17 of v
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = pack(a - hf.x, b - hf.y);
}

// Stage TR rows of `width` bf16 (a multiple of 8; row stride `rs`) into a
// tile with row stride `ld`, 16 bytes a copy; rows at or past `valid` are
// zero-filled.
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* src,
                                      int64_t rs, int width, int valid) {
  const int per = width / 8;
  for (int idx = threadIdx.x; idx < TR * per; idx += NTH) {
    const int r = idx / per;
    const int c = (idx - r * per) * 8;
    const bool ok = r < valid;
    cp16(dst + r * ld + c, src + (ok ? (int64_t)r * rs : 0) + c, ok);
  }
}

// h (hp x N' f32), la and the weights (Q f32 each), one C tile and two
// buffers each of B and x tiles (bf16); N' = N + 8 and hp + 8 row strides
size_t smem_bytes(int hp, int N, int Q) {
  const size_t ldk = N + PAD, ldx = hp + PAD;
  return sizeof(float) * ((size_t)hp * ldk + 2 * (size_t)Q) +
         sizeof(bf16) * (3 * TR * ldk + 2 * TR * ldx);
}

template <int HP>
__global__ void __launch_bounds__(NTH, HP == 64 ? 2 : 1)
ssd_scan_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, bf16* __restrict__ y,
             float* __restrict__ hout, int S, int nh, int g, int N, int Q,
             int64_t xsb, int64_t xss, int64_t xsh,
             int64_t dsb, int64_t dss, int64_t dsh,
             int64_t bsb, int64_t bss, int64_t bsg,
             int64_t csb, int64_t css, int64_t csg) {
  constexpr int NP = HP / 8;        // n8 tiles of a row's y
  constexpr int NPH = NP / 2;       // n8 tiles of half a row's y
  constexpr int LDX = HP + PAD;     // row stride of the x tiles
  constexpr int LDR = HP + PAD;     // row stride of the y partial sums
  constexpr int SLABS = HP / 64;    // 64-row h slabs of the state update
  const int nk = N / 16;            // k16 steps over the state
  const int LDK = N + PAD;          // row stride of the C, B tiles and h
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);      // HP x LDK: h[p][n]
  bf16* Cs = reinterpret_cast<bf16*>(hs + HP * LDK);   // TR x LDK
  bf16* Bs = Cs + TR * LDK;                            // 2 x TR x LDK
  bf16* Xs = Bs + 2 * TR * LDK;                        // 2 x TR x LDX
  float* la = reinterpret_cast<float*>(Xs + 2 * TR * LDX);  // Q
  float* ws = la + Q;  // Q: dt, then the state-update weights
  // TR x LDR f32 over the B and x buffers, once a row tile's are read
  float* red = reinterpret_cast<float*>(Bs);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = warp & 3;          // the warp's 16 rows of a row tile
  const int kh = warp >> 2;         // and its half of a tile's 64 columns
  const int qr = lane >> 2;         // accumulator row within 8
  const int qc = 2 * (lane & 3);    // accumulator column pair
  // ldmatrix addresses of this lane in a 16 x 16 block: (lrow, lcol) reads
  // the four 8 x 8 quarters in the order (0,0) (8,0) (0,8) (8,8); the
  // swapped (lrow_t, lcol_t) in the order (0,0) (0,8) (8,0) (8,8)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  const int lrow_t = (lane & 7) + (lane >> 4) * 8;
  const int lcol_t = ((lane >> 3) & 1) * 8;
  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int grp = h / (nh / g);
  const float Ah = A[h];
  const bf16* xb = x + b * xsb + h * xsh;
  const float* db = dt + b * dsb + h * dsh;
  const bf16* Bb = Bm + b * bsb + grp * bsg;
  const bf16* Cb = Cm + b * csb + grp * csg;
  const int64_t yss = (int64_t)nh * HP;            // y is contiguous
  bf16* yb = y + (int64_t)b * S * yss + (int64_t)h * HP;

  for (int i = tid; i < HP * LDK; i += NTH) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int Qc = min(Q, S - c0);
    const int ntiles = (Qc + TR - 1) / TR;
    __syncthreads();   // the previous chunk is done with la, ws and h
    for (int i = tid; i < Qc; i += NTH) ws[i] = db[(int64_t)(c0 + i) * dss];
    __syncthreads();
    if (tid < 32) log_decay(ws, la, Qc, Ah);

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * TR;
      __syncthreads();   // la is ready; the last row tile's tiles are read
      stage(Cs, LDK, Cb + (int64_t)(c0 + i0) * css, css, N, Qc - i0);
      stage(Bs, LDK, Bb + (int64_t)c0 * bss, bss, N, Qc);
      stage(Xs, LDX, xb + (int64_t)c0 * xss, xss, HP, Qc);
      cp_commit();
      const int r0 = i0 + rg * 16 + qr;   // this lane's rows r0, r0 + 8
      const int r1 = r0 + 8;
      const bf16* Cw = Cs + (rg * 16 + lrow) * LDK + lcol;   // A fragments
      // the warp's rows over all HP columns: its half of the inter term and
      // of M x, the other half's warp holding the rest
      float yacc[NP][4];
#pragma unroll
      for (int t = 0; t < NP; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[t][e] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TR;
        const int buf = jt & 1;
        if (jt < it) {   // the next column tile's B and x under this one
          const int nb = buf ^ 1;
          stage(Bs + nb * TR * LDK, LDK, Bb + (int64_t)(c0 + j0 + TR) * bss,
                bss, N, Qc - j0 - TR);
          stage(Xs + nb * TR * LDX, LDX, xb + (int64_t)(c0 + j0 + TR) * xss,
                xss, HP, Qc - j0 - TR);
          cp_commit();
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncthreads();
        const bf16* Bt = Bs + buf * TR * LDK;
        const bf16* Xt = Xs + buf * TR * LDX;

        if (jt == 0 && c0 > 0) {
          // inter, the warp's half of the columns: (C h^T) exp(la_i), h as
          // bf16 hi + lo
          for (int kk = 0; kk < nk; ++kk) {
            uint32_t af[4];
            ldsm(af, Cw + kk * 16);
#pragma unroll
            for (int t = 0; t < NP; ++t) {
              if ((t >= NPH) != kh) continue;
              const float* hr = hs + (t * 8 + qr) * LDK + kk * 16 + qc;
              const float2 v0 = *reinterpret_cast<const float2*>(hr);
              const float2 v1 = *reinterpret_cast<const float2*>(hr + 8);
              uint32_t h0, l0, h1, l1;
              split(v0.x, v0.y, h0, l0);
              split(v1.x, v1.y, h1, l1);
              mma(yacc[t], af, h0, h1);
              mma(yacc[t], af, l0, l1);
            }
          }
          const float e0 = r0 < Qc ? expf(la[r0]) : 0.f;
          const float e1 = r1 < Qc ? expf(la[r1]) : 0.f;
#pragma unroll
          for (int t = 0; t < NP; ++t) {
            yacc[t][0] *= e0;
            yacc[t][1] *= e0;
            yacc[t][2] *= e1;
            yacc[t][3] *= e1;
          }
        }

        // the warp's 16-column blocks of the tile, kb = 2 kh + q; on the
        // diagonal tile those past the warp's rows (kb > rg) are 0
        const int qmax = jt == it ? min(rg - 2 * kh, 1) : 1;
        if (qmax >= 0) {
          // G = C B^T over the warp's 16 rows and 32 columns
          float gacc[4][4];
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) gacc[t][e] = 0.f;
          for (int kk = 0; kk < nk; ++kk) {
            uint32_t af[4];
            ldsm(af, Cw + kk * 16);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              if (q > qmax) continue;
              uint32_t bf[4];
              ldsm(bf, Bt + ((2 * kh + q) * 16 + lrow_t) * LDK + kk * 16 +
                           lcol_t);
              mma(gacc[2 * q], af, bf[0], bf[1]);
              mma(gacc[2 * q + 1], af, bf[2], bf[3]);
            }
          }
          // M = G exp(la_i - la_j) dt_j on j <= i < Qc, else 0 (masked
          // before the exponent is taken), split into bf16 hi + lo and used
          // in place as the A fragments of yacc += M x
          const float la0 = r0 < Qc ? la[r0] : 0.f;
          const float la1 = r1 < Qc ? la[r1] : 0.f;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (q > qmax) continue;
            const int kb = 2 * kh + q;
            uint32_t mh[4], ml[4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int t = 2 * q + half;
              float m[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = e < 2 ? r0 : r1;
                const int j = j0 + kb * 16 + half * 8 + qc + (e & 1);
                const float li = e < 2 ? la0 : la1;
                m[e] = (j <= i && i < Qc)
                           ? gacc[t][e] * __expf(li - la[j]) * ws[j] : 0.f;
              }
              split(m[0], m[1], mh[2 * half], ml[2 * half]);
              split(m[2], m[3], mh[2 * half + 1], ml[2 * half + 1]);
            }
#pragma unroll
            for (int np = 0; np < HP / 16; ++np) {
              uint32_t bf[4];
              ldsm_t(bf, Xt + (kb * 16 + lrow) * LDX + np * 16 + lcol);
              mma(yacc[2 * np], mh, bf[0], bf[1]);
              mma(yacc[2 * np], ml, bf[0], bf[1]);
              mma(yacc[2 * np + 1], mh, bf[2], bf[3]);
              mma(yacc[2 * np + 1], ml, bf[2], bf[3]);
            }
          }
        }
        __syncthreads();   // this column tile's buffer may be refilled
      }
      // y = the two halves' sums, in f32 and in a fixed order, as bf16
      if (kh == 1) {
#pragma unroll
        for (int t = 0; t < NP; ++t) {
          float* rr = red + (rg * 16 + qr) * LDR + t * 8 + qc;
          *reinterpret_cast<float2*>(rr) = make_float2(yacc[t][0], yacc[t][1]);
          *reinterpret_cast<float2*>(rr + 8 * LDR) =
              make_float2(yacc[t][2], yacc[t][3]);
        }
      }
      __syncthreads();
      if (kh == 0) {
#pragma unroll
        for (int t = 0; t < NP; ++t) {
          const int col = t * 8 + qc;
          const float* rr = red + (rg * 16 + qr) * LDR + col;
          const float2 o0 = *reinterpret_cast<const float2*>(rr);
          const float2 o1 = *reinterpret_cast<const float2*>(rr + 8 * LDR);
          if (r0 < Qc)
            *reinterpret_cast<uint32_t*>(yb + (int64_t)(c0 + r0) * yss +
                                         col) =
                pack(yacc[t][0] + o0.x, yacc[t][1] + o0.y);
          if (r1 < Qc)
            *reinterpret_cast<uint32_t*>(yb + (int64_t)(c0 + r1) * yss +
                                         col) =
                pack(yacc[t][2] + o1.x, yacc[t][3] + o1.y);
        }
      }
    }

    // state update, after every row tile has read the old h
    __syncthreads();
    stage(Bs, LDK, Bb + (int64_t)c0 * bss, bss, N, Qc);
    stage(Xs, LDX, xb + (int64_t)c0 * xss, xss, HP, Qc);
    cp_commit();
    const float la_last = la[Qc - 1];
    const float decay = expf(la_last);
    for (int j = tid; j < Qc; j += NTH) ws[j] = expf(la_last - la[j]) * ws[j];
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * TR;
      const int buf = jt & 1;
      if (jt + 1 < ntiles) {
        const int nb = buf ^ 1;
        stage(Bs + nb * TR * LDK, LDK, Bb + (int64_t)(c0 + j0 + TR) * bss,
              bss, N, Qc - j0 - TR);
        stage(Xs + nb * TR * LDX, LDX, xb + (int64_t)(c0 + j0 + TR) * xss,
              xss, HP, Qc - j0 - TR);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();   // the tile has landed; ws holds the weights
      const bf16* Bt = Bs + buf * TR * LDK;
      const bf16* Xt = Xs + buf * TR * LDX;
      // sacc = x^T (w B) over the tile's 64 rows, fresh for each tile; a
      // warp owns (16-column block nb, 64-row slab sl) units of h, so each
      // w B entry is split once per slab
      for (int u = warp; u < nk * SLABS; u += NWARP) {
        const int nb = u % nk;
        const int sl = u / nk;
        float sacc[4][2][4];   // [m16 tile of h rows][n8 tile][.]
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[mt][t][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          // the weights of this lane's rows j: qc, qc + 1, qc + 8, qc + 9
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + ks * 16 + qc + (e & 1) + (e >> 1) * 8;
            w[e] = j < Qc ? ws[j] : 0.f;
          }
          uint32_t bf[4], bh[4], bl[4];   // [n8 tile][k half], hi and lo
          ldsm_t(bf, Bt + (ks * 16 + lrow) * LDK + nb * 16 + lcol);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 v = unpack(bf[r]);
            const int k = (r & 1) * 2;
            split(v.x * w[k], v.y * w[k + 1], bh[r], bl[r]);
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t af[4];
            ldsm_t(af, Xt + (ks * 16 + lrow_t) * LDX + sl * 64 + mt * 16 +
                           lcol_t);
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              mma(sacc[mt][t], af, bh[2 * t], bh[2 * t + 1]);
              mma(sacc[mt][t], af, bl[2 * t], bl[2 * t + 1]);
            }
          }
        }
        // h = exp(la_last) h + the first tile's product, then + each later
        // tile's, by f32 adds; a lane owns the h entries of its accumulator
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float2* hp_ = reinterpret_cast<float2*>(
                  hs + (sl * 64 + mt * 16 + qr + 8 * hh) * LDK + nb * 16 +
                  t * 8 + qc);
              float2 v = *hp_;
              if (jt == 0) {
                v.x *= decay;
                v.y *= decay;
              }
              v.x += sacc[mt][t][2 * hh];
              v.y += sacc[mt][t][2 * hh + 1];
              *hp_ = v;
            }
      }
      __syncthreads();   // this tile's buffer may be refilled
    }
  }

  __syncthreads();
  float* hb = hout + ((int64_t)b * nh + h) * HP * N;
  for (int idx = tid; idx < HP * N; idx += NTH)
    hb[idx] = hs[(idx / N) * LDK + idx % N];
}

template <int HP>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, void* y, float* hout,
                   int Bs, int S, int nh, int g, int N, int Q,
                   const int64_t* st, cudaStream_t stream) {
  // 16-byte cp.async of every row of x, B and C
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(B) |
                         reinterpret_cast<uintptr_t>(C);
  if (addr % 16) return cudaErrorMisalignedAddress;
  static const int rows[] = {0, 1, 2, 6, 7, 8, 9, 10, 11};
  for (int i : rows)
    if (st[i] % 8) return cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes(HP, N, Q);
  auto kern = ssd_scan_mma<HP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<Bs * nh, NTH, smem, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), static_cast<bf16*>(y), hout, S, nh, g, N,
      Q, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
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
// row strides of whole 16 bytes (else cudaErrorMisalignedAddress).  Returns
// a cudaError_t code.
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
    return hp == 64 ? tc::launch<64>(x, d, a, B, C, y, hf, Bs, S, nh, g, N,
                                     Q, strides, s)
                    : tc::launch<128>(x, d, a, B, C, y, hf, Bs, S, nh, g, N,
                                      Q, strides, s);
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
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
