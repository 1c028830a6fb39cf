// One masked FastGRNN step for S independent streams in the dense layout,
// for sm_90a.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/fastgrnn_cell/kernel.py::_q15_step_kernel_mxu
// (built there by make_fastgrnn_step(mxu=True)).  That kernel padded x and
// h to 128 lanes and ran the two projections as (B, 128) x (128, 128)
// matrix-unit contractions against effective W^T / U^T that the host had
// dequantized and pre-multiplied (W1 W2^T, U1 U2^T) in float32.  The
// padding was the TPU's layout, not part of the function: this kernel takes
// the unpadded (S, H) / (S, D) rows and computes, per stream row b whose
// mask byte is non-zero, the op sequence of the plain version
// repro_torch/kernels/fastgrnn_cell/qstep.py::step_dense:
//
//   pre = (x W^T) + (h U^T)   two chains, each j ascending from +0, added
//   z   = lut_sigmoid(pre + b_z);  ht = lut_tanh(pre + b_h)
//   h'  = (zeta * (1 - z) + nu) * ht + z * h
//
// and copies h bit for bit where the mask byte is zero.  Like the TPU
// kernel it stores no activation in Q15 in any mode.  Every multiply and
// add is an explicit round-to-nearest intrinsic and the file is built with
// --fmad=false, so the result is bitwise equal to the plain version.  No
// tensor core is used: TF32 would break the plain version's bitwise
// contract and the reference's 1e-6 step tolerance.
//
// Bound: HBM bytes.  Per stream-step it reads x (D*4 = 12 B), h (H*4 =
// 64 B) and the mask byte and writes h' (64 B): 141 B, about 18.5 MB per
// step at S = 131,072, 5.5 us at 3.35 TB/s, against 2(DH + HH) + 10H =
// 768 operations (~1.5 us at the fp32 rate).  The effective weights and
// both 256-entry LUTs live in shared memory (3,392 B at H = 16, D = 3).
// One thread owns one stream row.  For the paper's width (H = 16, D = 3)
// the kernel is instantiated with both sizes fixed, so the row and the
// loops live in registers and h moves as 16-byte vectors; any other width
// runs the same code with runtime sizes.
//
// Plain C interface (loaded with ctypes); launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fastgrnn_cell.cuh"

namespace {

constexpr int kMaxH = 64;
constexpr int kMaxD = 16;
constexpr int kLut = fastgrnn_cell::kLut;
constexpr int kThreads = 256;

struct DenseParams {
  const float* h;          // (S, H)
  const float* x;          // (S, D)
  const uint8_t* mask;     // (S,)
  float* out;              // (S, H), fresh buffer
  int S, H, D;
  const float* w;          // (H, D) effective W, row-major
  const float* u;          // (H, H) effective U, row-major
  const float* b_z;        // (H,)
  const float* b_h;        // (H,)
  const float* sig_lut;    // (256,)
  const float* tanh_lut;   // (256,)
  float zeta, nu;
};

// kH = kD = 0: sizes from the parameters; otherwise fixed at compile time
// (then kH % 4 == 0 and h / out are 16-byte aligned, checked by the
// launcher).
template <int kH, int kD>
__global__ void __launch_bounds__(kThreads)
q15_step_dense_kernel(DenseParams p) {
  constexpr bool kFixed = kH > 0;
  constexpr int kRowH = kFixed ? kH : kMaxH;
  constexpr int kRowD = kFixed ? kD : kMaxD;
  const int H = kFixed ? kH : p.H;
  const int D = kFixed ? kD : p.D;
  extern __shared__ float smem[];
  float* sig = smem;
  float* tnh = sig + kLut;
  float* bz = tnh + kLut;
  float* bh = bz + H;
  float* w = bh + H;
  float* u = w + H * D;
  for (int i = threadIdx.x; i < kLut; i += blockDim.x) {
    sig[i] = p.sig_lut[i];
    tnh[i] = p.tanh_lut[i];
  }
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    bz[i] = p.b_z[i];
    bh[i] = p.b_h[i];
  }
  for (int i = threadIdx.x; i < H * D; i += blockDim.x) w[i] = p.w[i];
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) u[i] = p.u[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.S) return;
  const size_t hoff = static_cast<size_t>(b) * H;
  float h[kRowH];
  if constexpr (kFixed) {
    const float4* src = reinterpret_cast<const float4*>(p.h + hoff);
#pragma unroll
    for (int j = 0; j < kRowH / 4; ++j) {
      const float4 v = src[j];
      h[4 * j] = v.x;
      h[4 * j + 1] = v.y;
      h[4 * j + 2] = v.z;
      h[4 * j + 3] = v.w;
    }
  } else {
    for (int j = 0; j < H; ++j) h[j] = p.h[hoff + j];
  }

  // With fixed sizes every loop below has a constant trip count and is
  // unrolled completely (#pragma unroll), so h, x and hn live in
  // registers; with runtime sizes the pragma leaves the loops as they are.
  float hn[kRowH];
  if (p.mask[b] == 0) {  // inactive stream: keep its state bit for bit
#pragma unroll
    for (int i = 0; i < H; ++i) hn[i] = h[i];
  } else {
    float x[kRowD];
#pragma unroll
    for (int j = 0; j < D; ++j) x[j] = p.x[static_cast<size_t>(b) * D + j];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      float wx = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j)
        wx = __fadd_rn(wx, __fmul_rn(x[j], w[i * D + j]));
      float uh = 0.0f;
#pragma unroll
      for (int j = 0; j < H; ++j)
        uh = __fadd_rn(uh, __fmul_rn(h[j], u[i * H + j]));
      const float pre = __fadd_rn(wx, uh);
      const float z = fastgrnn_cell::lut_nearest(sig, __fadd_rn(pre, bz[i]));
      const float ht = fastgrnn_cell::lut_nearest(tnh, __fadd_rn(pre, bh[i]));
      hn[i] = fastgrnn_cell::gate(z, ht, h[i], p.zeta, p.nu);
    }
  }

  if constexpr (kFixed) {
    float4* dst = reinterpret_cast<float4*>(p.out + hoff);
#pragma unroll
    for (int j = 0; j < kRowH / 4; ++j)
      dst[j] = make_float4(hn[4 * j], hn[4 * j + 1], hn[4 * j + 2],
                           hn[4 * j + 3]);
  } else {
    for (int i = 0; i < H; ++i) p.out[hoff + i] = hn[i];
  }
}

// The fixed-size instantiation serves the paper's width when h and out
// take 16-byte vector loads and stores.
bool fixed_width(int H, int D, const float* h, const float* out) {
  return H == 16 && D == 3 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <int kH, int kD>
cudaError_t launch(const DenseParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kLut + 2 * p.H + p.H * p.D +
                                       p.H * p.H);
  const int blocks = (p.S + kThreads - 1) / kThreads;
  q15_step_dense_kernel<kH, kD><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one step.  Returns cudaSuccess (0) or the launch error; a shape
// outside the kernel's fixed per-thread buffers returns
// cudaErrorInvalidValue without launching.
int q15_step_dense_launch(const float* h, const float* x, const uint8_t* mask,
                          float* out, int S, int H, int D, const float* w,
                          const float* u, const float* b_z, const float* b_h,
                          const float* sig_lut, const float* tanh_lut,
                          float zeta, float nu, void* stream) {
  if (S < 0 || H < 1 || H > kMaxH || D < 1 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  const DenseParams p{h, x, mask, out, S, H, D, w, u, b_z, b_h, sig_lut,
                      tanh_lut, zeta, nu};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = fixed_width(H, D, h, out) ? launch<16, 3>(p, s)
                                                    : launch<0, 0>(p, s);
  return static_cast<int>(err);
}

// 1 when a launch at this width and these addresses runs the instantiation
// with fixed sizes, 0 when it runs the one with runtime sizes.
int q15_step_dense_fixed(int H, int D, const float* h, const float* out) {
  return fixed_width(H, D, h, out);
}

const char* q15_step_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
