// Elementwise LUT activation (paper Sec. III-E, Appendix C), for sm_90a.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/lut_act/kernel.py::_lut_kernel  (lut_act_2d)
// which padded the flattened input to (256, 128) tiles and pinned the table
// in VMEM.  The tiling was the TPU's layout, not part of the function: this
// kernel is one grid-stride pass over the flattened tensor, float32 or
// bfloat16 in and the same type out, and computes per element the op
// sequence of the plain version repro_torch/core/lut.py::lut_eval:
//
//   nearest: y = t[clamp(int_rz((x - lo) * inv_bw))]
//   lerp:    pos = (x - lo) / bw - 0.5;  i0 = clamp(int_rz(floor(pos)));
//            i1 = clamp(i0 + 1);  f = clamp(pos - i0, 0, 1)  (NaN passes);
//            y = (1 - f) * t[i0] + f * t[i1]
//   tails:   x >= hi -> t[size-1] (linear tail: x);  x <= lo -> t[0] (0)
//
// Every multiply, add and divide is an explicit round-to-nearest intrinsic
// and the file is built with --fmad=false, so the result is bitwise equal
// to the plain version on the card (its lo, bw, 1/bw are the same float32
// values, passed in).
//
// Bound: HBM bytes.  Per element it reads x and writes y: 8 B in float32,
// 4 B in bfloat16 (2^26 elements: 537 MB, ~160 us at 3.35 TB/s), against
// 4 (nearest) to 11 (lerp) fp32 operations.  The table (1 KB at 256
// entries) sits in shared memory for the whole launch; each thread moves
// 16 bytes per load and store (4 floats or 8 bfloat16) when both tensors
// are 16-byte aligned, and the grid strides over the tensor so a launch
// fills the card whatever its size.
//
// Plain C interface (loaded with ctypes); launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSize = 12288;      // 48 KB of table: no opt-in needed
constexpr int kBlocksPerSm = 8;

struct LutParams {
  const void* x;
  void* out;
  int64_t n;
  const float* table;
  int size;
  float lo, hi, bw, inv_bw;
  int lerp, linear_tail;
};

__device__ __forceinline__ int clamp_index(int i, int size) {
  return i < 0 ? 0 : (i > size - 1 ? size - 1 : i);
}

__device__ __forceinline__ float lut_value(const float* t, float x,
                                           const LutParams& p) {
  float y;
  if (p.lerp) {
    const float pos = __fsub_rn(__fdiv_rn(__fsub_rn(x, p.lo), p.bw), 0.5f);
    const int i0 = clamp_index(__float2int_rz(floorf(pos)), p.size);
    const int i1 = clamp_index(i0 + 1, p.size);
    float f = __fsub_rn(pos, __int2float_rn(i0));
    f = isnan(f) ? f : fminf(fmaxf(f, 0.0f), 1.0f);  // as torch.clamp
    y = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), t[i0]), __fmul_rn(f, t[i1]));
  } else {
    y = t[clamp_index(
        __float2int_rz(__fmul_rn(__fsub_rn(x, p.lo), p.inv_bw)), p.size)];
  }
  const bool above = x >= p.hi, below = x <= p.lo;
  if (p.linear_tail) return above ? x : (below ? 0.0f : y);
  return above ? t[p.size - 1] : (below ? t[0] : y);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int kVec>
struct alignas(16) Vec {
  T v[kVec];
};

// kVec: elements per 16-byte vector (x and out 16-byte aligned, checked by
// the launcher), or 1 for element-wise access.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) lut_act_kernel(LutParams p) {
  extern __shared__ float t[];
  for (int i = threadIdx.x; i < p.size; i += blockDim.x) t[i] = p.table[i];
  __syncthreads();

  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  // elements [0, n_vec * kVec) move as vectors, the rest one by one
  const int64_t n_vec = kVec > 1 ? p.n / kVec : 0;
  if constexpr (kVec > 1) {
    const Vec<T, kVec>* xv = reinterpret_cast<const Vec<T, kVec>*>(x);
    Vec<T, kVec>* ov = reinterpret_cast<Vec<T, kVec>*>(out);
    for (int64_t i = tid; i < n_vec; i += stride) {
      const Vec<T, kVec> a = xv[i];
      Vec<T, kVec> b;
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        b.v[k] = from_float<T>(lut_value(t, to_float(a.v[k]), p));
      ov[i] = b;
    }
  }
  for (int64_t i = n_vec * kVec + tid; i < p.n; i += stride)
    out[i] = from_float<T>(lut_value(t, to_float(x[i]), p));
}

template <typename T, int kVec>
cudaError_t launch(const LutParams& p, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t want = (p.n / kVec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1)
                                                 : cap);
  lut_act_kernel<T, kVec><<<blocks, kThreads, sizeof(float) * p.size,
                            stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* a) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

}  // namespace

extern "C" {

// Launch one pass.  dtype: 0 float32, 1 bfloat16.  Returns cudaSuccess (0)
// or the launch error; an argument the kernel does not take returns
// cudaErrorInvalidValue without launching.
int lut_act_launch(const void* x, void* out, int64_t n, int dtype,
                   const float* table, int size, float lo, float hi,
                   float bw, float inv_bw, int lerp, int linear_tail,
                   void* stream) {
  if (n < 0 || size < 1 || size > kMaxSize || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const LutParams p{x, out, n, table, size, lo, hi, bw, inv_bw, lerp,
                    linear_tail};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(out);
  cudaError_t err;
  if (dtype == 0)
    err = vec ? launch<float, 4>(p, s) : launch<float, 1>(p, s);
  else
    err = vec ? launch<__nv_bfloat16, 8>(p, s) : launch<__nv_bfloat16, 1>(p, s);
  return static_cast<int>(err);
}

const char* lut_act_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
