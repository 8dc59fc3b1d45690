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
// 3.35 TB/s).  This first version does its products with f32 FMAs on the
// CUDA cores and computes C B^T once per head instead of once per group, so
// it does ~2x the needed operations at the f32 rate and in practice is
// bounded by shared-memory bandwidth and by the one block per SM that its
// shared memory allows.
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
// contiguous or per-head copy of B and C is made.  Tensor cores, TMA, one
// C B^T shared by a group's heads and the chunk-parallel split (chunk
// states, a state pass, outputs) are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC
// C interface (loaded with ctypes): ssd_scan(...) returns cudaGetLastError()
// after the launch; ssd_scan_error_string(code) names it.

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
    // la = cumsum(dt * A): warp 0, each lane a run of rows, then an
    // exclusive shuffle scan of the runs' sums
    if (tid < 32) {
      const int per = (Qc + 31) / 32;
      const int lo = tid * per;
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
        if (tid >= off) incl += v;
      }
      float base = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) base = 0.f;
      for (int i = lo; i < hi; ++i) la[i] += base;
    }

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

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt and A are f32.
// strides: 12 int64 element strides, (batch, seq, head) for x and dt and
// (batch, seq, group) for B and C; the last dim of x, B and C is contiguous.
// y (Bs,S,nh,hp) and h_final (Bs,nh,hp,N) are contiguous.  Returns a
// cudaError_t code.
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
  if (dtype == 0)
    return dispatch<float>(hp, x, d, a, B, C, y, hf, Bs, S, nh, g, N, Q,
                           strides, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hp, x, d, a, B, C, y, hf, Bs, S, nh, g,
                                   N, Q, strides, s);
  return cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
