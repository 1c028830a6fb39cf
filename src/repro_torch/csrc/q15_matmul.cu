// Matmul with fused Q15/Q7 weight dequantization (paper Appendix B at LM
// scale: the quantized sampling head of the LM serving engine), for sm_90a.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/q15_matmul/kernel.py::_mm_kernel  (q15_matmul_padded)
// which padded x and the weights to (128, 128, 128) blocks, cast each
// block to bfloat16 in VMEM, accumulated the MXU's products in float32
// across the K blocks and applied the per-tensor scale once at the end.
// The blocking was the TPU's layout, not part of the function.  This
// kernel computes the same function, out[m, n] = scale * sum_k
// bf16(x[m, k]) * bf16(w[k, n]), with no padding (it guards its own tails):
//
//   x  -> bfloat16 with __float2bfloat16_rn (round to nearest even);
//   w  -> float -> bfloat16, round to nearest even (int16 values above 256
//         round; every int8 value is exact in bfloat16, so for int8 the
//         rounding is the identity and is skipped);
//   products of two bfloat16 values, exact in float32, added in float32
//   in ascending k (__fmul_rn, __fadd_rn; built with --fmad=false), from
//   +0.0;
//   one __fmul_rn by the scale at the end; the output is written as
//   float32, or as bfloat16 with __float2bfloat16_rn.
//
// Against the plain version (kernels/q15_matmul/kernel.py::plain, a
// float32 product of the same bfloat16 values) only the order of the
// float32 additions differs.
//
// Bound.  The engine's head is a decode-time product of M <= 8 rows
// against the (1536, 151936) integer head: every weight is read once, so
// HBM bytes bound the function for int16 (467 MB, ~141 us at 3.35 TB/s)
// and for int8 (233 MB, ~71 us); its M*K*N products are ~56 us of FMAs
// at 33.5 T/s.  Each product of two bfloat16 values is exact in float32,
// so an FMA (or wgmma) would round as the separate multiply and add do;
// the port builds every kernel with --fmad=false and writes none, so
// this kernel issues two instructions per product.  Design: each block
// owns a tile of columns, each thread C adjacent columns (one 4-byte
// vector of weights per k when N % C == 0 and the weights are aligned,
// else C = 1), so a warp's weight loads are one contiguous 128-byte
// segment per k, and the loads of 16 steps of k are in flight at once
// (the grid has only N / C threads to hide HBM latency with); grid.y
// walks tiles of MT <= 8 rows of x, so at M <= 8 every weight byte is
// read once and converted once for all the rows.  x is staged in shared
// memory, already rounded to bfloat16, kChunk values of k at a time.
// Tensor cores (wgmma), TMA and split-K are later work.
//
// Plain C interface (loaded with ctypes); launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;     // k values of x staged per pass
constexpr int kVecBytes = 4;    // weight bytes a thread loads per k

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float weight_value(int16_t w) {
  return round_bf16(static_cast<float>(w));
}
__device__ __forceinline__ float weight_value(int8_t w) {
  return static_cast<float>(w);           // exact in bfloat16
}

// The C weights a thread takes at one k: one 32-bit load when C > 1 (the
// launcher checked the alignment), split into C values in registers.
template <typename W, int C>
__device__ __forceinline__ void load_weights(const W* p, float (&wf)[C]) {
  if constexpr (C == 1) {
    wf[0] = weight_value(__ldg(p));
  } else {
    static_assert(C * sizeof(W) == kVecBytes, "one 32-bit word per k");
    const unsigned int word = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
    for (int c = 0; c < C; ++c)
      wf[c] = weight_value(static_cast<W>(word >> (8 * sizeof(W) * c)));
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename W, int C, int MT, typename O>
__global__ void __launch_bounds__(kThreads)
q15_matmul_kernel(const float* __restrict__ x, const W* __restrict__ w,
                  const float* __restrict__ scale, O* __restrict__ out,
                  int M, int K, int N) {
  __shared__ alignas(16) float xs[kChunk * MT];     // [k][row]
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * C;
  const int row0 = blockIdx.y * MT;
  const bool live = col0 < N;      // C > 1 only when N % C == 0
  float acc[MT][C];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = K - k0 < kChunk ? K - k0 : kChunk;
    __syncthreads();               // the previous chunk is consumed
    for (int i = threadIdx.x; i < kChunk * MT; i += kThreads) {
      const int kk = i / MT, r = i % MT;
      float v = 0.0f;
      if (kk < kn && row0 + r < M)
        v = round_bf16(x[static_cast<size_t>(row0 + r) * K + k0 + kk]);
      xs[i] = v;
    }
    __syncthreads();
    if (live) {
      const W* wp = w + static_cast<size_t>(k0) * N + col0;
#pragma unroll 16   // 16 steps' weight loads in flight
      for (int kk = 0; kk < kn; ++kk) {
        float wf[C];
        load_weights<W, C>(wp + static_cast<size_t>(kk) * N, wf);
        const float* xk = xs + kk * MT;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float xv = xk[r];
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(xv, wf[c]));
        }
      }
    }
  }
  if (!live) return;
  const float s = *scale;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    if (row0 + r >= M) break;
    O* o = out + static_cast<size_t>(row0 + r) * N + col0;
#pragma unroll
    for (int c = 0; c < C; ++c) store(o + c, __fmul_rn(acc[r][c], s));
  }
}

template <typename W, int C, int MT, typename O>
cudaError_t launch_rows(const float* x, const void* w, const float* scale,
                        void* out, int M, int K, int N, cudaStream_t stream) {
  const int cols_per_block = kThreads * C;
  const dim3 grid((N + cols_per_block - 1) / cols_per_block,
                  (M + MT - 1) / MT);
  q15_matmul_kernel<W, C, MT, O><<<grid, kThreads, 0, stream>>>(
      x, static_cast<const W*>(w), scale, static_cast<O*>(out), M, K, N);
  return cudaGetLastError();
}

// MT: the fewest rows per block that hold every row of x, up to 8.
template <typename W, int C, typename O>
cudaError_t launch_cols(const float* x, const void* w, const float* scale,
                        void* out, int M, int K, int N, cudaStream_t stream) {
  if (M <= 1) return launch_rows<W, C, 1, O>(x, w, scale, out, M, K, N, stream);
  if (M <= 2) return launch_rows<W, C, 2, O>(x, w, scale, out, M, K, N, stream);
  if (M <= 4) return launch_rows<W, C, 4, O>(x, w, scale, out, M, K, N, stream);
  return launch_rows<W, C, 8, O>(x, w, scale, out, M, K, N, stream);
}

template <typename W, typename O>
cudaError_t launch_typed(const float* x, const void* w, const float* scale,
                         void* out, int M, int K, int N, cudaStream_t stream) {
  constexpr int C = kVecBytes / sizeof(W);
  const bool vec = N % C == 0 &&
                   reinterpret_cast<uintptr_t>(w) % kVecBytes == 0;
  return vec ? launch_cols<W, C, O>(x, w, scale, out, M, K, N, stream)
             : launch_cols<W, 1, O>(x, w, scale, out, M, K, N, stream);
}

}  // namespace

extern "C" {

// out (M, N) = scale * bf16(x (M, K)) @ bf16(w (K, N)), all row-major and
// contiguous.  w_bits: 8 (int8) or 16 (int16); out_dtype: 0 float32,
// 1 bfloat16; scale points at one float32 on the device.  Returns
// cudaSuccess (0) or the launch error; an argument the kernel does not
// take returns cudaErrorInvalidValue without launching.
int q15_matmul_launch(const float* x, const void* w, int w_bits,
                      const float* scale, void* out, int out_dtype, int M,
                      int K, int N, void* stream) {
  if (M < 0 || K < 0 || N < 0 || (w_bits != 8 && w_bits != 16) ||
      (out_dtype != 0 && out_dtype != 1) || (M + 7) / 8 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w_bits == 16)
    err = out_dtype == 0
              ? launch_typed<int16_t, float>(x, w, scale, out, M, K, N, s)
              : launch_typed<int16_t, __nv_bfloat16>(x, w, scale, out, M, K, N, s);
  else
    err = out_dtype == 0
              ? launch_typed<int8_t, float>(x, w, scale, out, M, K, N, s)
              : launch_typed<int8_t, __nv_bfloat16>(x, w, scale, out, M, K, N, s);
  return static_cast<int>(err);
}

const char* q15_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
