// Percentile stretch for Hopper (sm_90a), hand-written CUDA C++ (K5).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/percentile_norm/kernel.py::_norm_kernel
// (launched by percentile_norm_kernel through pl.pallas_call).
//
// It computes the same function.  For x (R, C) pixels by bands, f32 or bf16,
// and the per-band bounds lo, hi (1, C) f32, it writes the f32
//   out = clip((x - lo) * (1 / max(hi - lo, 1e-12)), 0, 1)
// in the TPU kernel's operation order: the reciprocal first (IEEE division;
// the build uses no --use_fast_math and no __fdividef), then one subtract
// and one multiply, which cannot be contracted into an FMA, so the result
// is bit for bit the plain version's.  The max and the clamp are written as
// comparisons that keep NaN: fmaxf/fminf return the operand that is not
// NaN, so a nodata pixel would come out 0 or 1 where the reference's
// jnp.maximum / jnp.clip give NaN.
//
// What bounds it on this card.  Four or so operations per element against
// 4 + 4 bytes (f32 in, f32 out): it is bound by bytes, R * C * (in size + 4)
// over 3.35 TB/s, 1.15 ms for a 10980 x 10980 Sentinel-2 tile of 4 bands.
//
// What the design does about it.  The TPU kernel streams (block_rows, C)
// tiles through VMEM with lo/hi resident, and pads R up to a whole block.
// Here one grid-stride loop covers the R * C elements with 64-bit indices
// (a 13-band tile has 1.57e9 elements, and a scene may exceed 2**31); the
// C lows and reciprocals are staged once per block in shared memory.  When
// rows are packed (row stride C) and the pointers aligned, each thread
// moves four elements per iteration (one 16-byte f32 load, or 8 bytes of
// bf16, and one 16-byte store), tracking the band of its first element with
// a running counter instead of a 64-bit modulo per element.  Otherwise it
// walks (row, band) counters element by element through the row stride.
// The ragged end (R * C not a multiple of four) is done in the kernel, with
// no pad copy.  The grid holds as many 256-thread blocks as the card keeps
// resident, so the loop streams with enough loads in flight.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC
// C interface (loaded with ctypes): percentile_norm(...) returns
// cudaGetLastError() after the launch; percentile_norm_error_string(code)
// names it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int MAX_BANDS = 4096;   // lows and reciprocals: 32 KB of shared
constexpr int BLOCKS_PER_SM = 8;  // 8 x 256 threads: a full SM
constexpr float EPS = 1e-12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// clip((x - lo) * scale, 0, 1), NaN kept
__device__ __forceinline__ float stretch(float x, float lo, float scale) {
  float u = (x - lo) * scale;
  u = (u < 0.f) ? 0.f : u;
  return (u > 1.f) ? 1.f : u;
}

// four packed elements starting at element 4 * v
__device__ __forceinline__ void load4(const float* x, int64_t v, float r[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(x) + v);
  r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* x, int64_t v,
                                      float r[4]) {
  // a bf16 is the high half of its f32: widen the bits exactly (NaN too)
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(x) + v);
  r[0] = __uint_as_float(t.x << 16);
  r[1] = __uint_as_float(t.x & 0xffff0000u);
  r[2] = __uint_as_float(t.y << 16);
  r[3] = __uint_as_float(t.y & 0xffff0000u);
}

template <typename T>
__global__ void __launch_bounds__(NT)
stretch_kernel(const T* __restrict__ x, const float* __restrict__ lo,
               const float* __restrict__ hi, float* __restrict__ out,
               int64_t R, int C, int64_t ldx, int packed) {
  extern __shared__ float smem[];
  float* slo = smem;       // C lows
  float* ssc = smem + C;   // C reciprocals 1 / max(hi - lo, eps)
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float l = lo[c];
    float d = hi[c] - l;
    d = (d < EPS) ? EPS : d;   // as jnp.maximum: a NaN d stays NaN
    slo[c] = l;
    ssc[c] = 1.0f / d;
  }
  __syncthreads();

  const int64_t n = R * (int64_t)C;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (packed) {
    const int64_t nv = n >> 2;
    const int step = (int)((stride * 4) % C);
    int col = (int)((t0 * 4) % C);   // band of the first of the four
    for (int64_t v = t0; v < nv; v += stride) {
      float r[4];
      load4(x, v, r);
      int c = col;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = stretch(r[j], slo[c], ssc[c]);
        c = (c + 1 == C) ? 0 : c + 1;
      }
      reinterpret_cast<float4*>(out)[v] = make_float4(r[0], r[1], r[2], r[3]);
      col += step;
      if (col >= C) col -= C;
    }
    // the last n % 4 elements
    const int64_t i = (nv << 2) + t0;
    if (i < n) {
      const int c = (int)(i % C);
      out[i] = stretch(to_f32(x[i]), slo[c], ssc[c]);
    }
  } else {
    // rows ldx >= C elements apart: walk (row, band) with carries
    const int64_t srow = stride / C;
    const int scol = (int)(stride % C);
    int64_t row = t0 / C;
    int col = (int)(t0 % C);
    for (int64_t i = t0; i < n; i += stride) {
      out[i] = stretch(to_f32(x[row * ldx + col]), slo[col], ssc[col]);
      row += srow;
      col += scol;
      if (col >= C) {
        col -= C;
        ++row;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* lo, const void* hi, void* out,
                   int64_t R, int C, int64_t ldx, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t n = R * (int64_t)C;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const int packed = ldx == C && xa % (4 * sizeof(T)) == 0 && oa % 16 == 0;
  const int64_t work = packed ? (n >> 2) : n;
  int64_t blocks = (work + NT - 1) / NT;
  if (blocks > (int64_t)sms * BLOCKS_PER_SM) blocks = (int64_t)sms * BLOCKS_PER_SM;
  if (blocks < 1) blocks = 1;
  stretch_kernel<T><<<(unsigned)blocks, NT, 2 * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(out), R, C, ldx,
      packed);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of x: 0 = float32, 1 = bfloat16.  x (R, C) with its rows ldx >= C
// elements apart and its bands contiguous; lo, hi (C,) f32 contiguous; out
// (R, C) f32 contiguous.  Returns a cudaError_t code.
int percentile_norm(const void* x, const void* lo, const void* hi, void* out,
                    int dtype, int64_t R, int C, int64_t ldx, void* stream) {
  if (R < 1 || C < 1 || C > MAX_BANDS || ldx < C || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(x, lo, hi, out, R, C, ldx, s)
                 : launch<__nv_bfloat16>(x, lo, hi, out, R, C, ldx, s);
  return (int)err;
}

const char* percentile_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
