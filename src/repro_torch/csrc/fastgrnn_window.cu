// Fused FP32 FastGRNN full-window scan (paper Eq. 1-3 with the Sec. III-E
// LUT activations), for sm_90a.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/fastgrnn_cell/kernel.py::_cell_kernel  (fastgrnn_window)
// which kept the effective W^T / U^T, the biases, both LUTs and h in VMEM
// for a whole window, looping over T inside one program per 8-row batch
// tile padded to 128 lanes.  The padding was the TPU's layout, not part of
// the function: this kernel takes the unpadded time-major x (T, B, D) and
// writes the trajectory (T, B, H) and the final h (B, H), computing per row
// b, from h = +0 and for t = 0 .. T-1, the op sequence of the plain version
// repro_torch/kernels/fastgrnn_cell/qstep.py::window_scan (T unmasked
// dense-layout steps, the arithmetic of q15_step_dense.cu):
//
//   pre = (x_t W^T) + (h U^T)   two chains, each j ascending from +0, added
//   z   = lut_sigmoid(pre + b_z);  ht = lut_tanh(pre + b_h)   (nearest)
//   h   = (zeta * (1 - z) + nu) * ht + z * h;   traj[t] = h
//
// Every multiply and add is an explicit round-to-nearest intrinsic and the
// file is built with --fmad=false, so the result is bitwise equal to the
// plain version on the card.
//
// Bound: fp32 instructions, closely followed by HBM bytes.  Per
// window-step it reads x (D*4 = 12 B) and writes traj (H*4 = 64 B), plus
// 64 B of final h per window: 1.28 GB at B = 131,072, T = 128, ~383 us at
// 3.35 TB/s.  With FMA forbidden every add and multiply is one
// instruction: 2(DH + H^2) for the products, H for pre, 2H for the biases,
// 4H for the two LUT indices and 6H for the gate = 816 per window-step,
// 13.7 G at that size, ~409 us at 132 SMs x 128 lanes x 1.98 GHz; plus 32
// shared-memory LUT gathers per window-step.  The design keeps everything
// but x and traj off HBM: one thread owns one row for all T steps with h
// in registers; at the paper's width (H = 16, D = 3) the kernel is
// instantiated with both sizes fixed, the effective W, U and the biases
// travel in the kernel's parameter space (the constant bank: operands of
// the multiplies, no load instruction), both LUTs sit in shared memory,
// x of the next step is loaded before the current step computes, and traj
// is stored as 16-byte vectors (a warp writes 2 KB of contiguous traj per
// step).  Any other width runs the same code with runtime sizes and the
// weights in shared memory.
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
constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;   // 64 registers a thread: one wave at 131,072
constexpr int kFixedH = 16;
constexpr int kFixedD = 3;

struct WindowParams {
  const float* x;          // (T, B, D)
  float* traj;             // (T, B, H)
  float* h_out;            // (B, H)
  int T, B, H, D;
  const float* w;          // (H, D) effective W, row-major (runtime width)
  const float* u;          // (H, H) effective U, row-major (runtime width)
  const float* b_z;        // (H,)   (runtime width)
  const float* b_h;        // (H,)   (runtime width)
  const float* sig_lut;    // (256,)
  const float* tanh_lut;   // (256,)
  float zeta, nu;
};

// The paper's width: the weights by value, in the parameter space.
template <int kH, int kD>
struct FixedWeights {
  float w[kH * kD];
  float u[kH * kH];
  float bz[kH];
  float bh[kH];
};

// kH = kD = 0: sizes and weights from WindowParams; otherwise fixed at
// compile time, the weights from fw (then kH % 4 == 0 and traj / h_out are
// 16-byte aligned, checked by the launcher).
template <int kH, int kD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fastgrnn_window_kernel(const WindowParams p,
                       const __grid_constant__ FixedWeights<kFixedH, kFixedD>
                           fw) {
  constexpr bool kFixed = kH > 0;
  constexpr int kRowH = kFixed ? kH : kMaxH;
  constexpr int kRowD = kFixed ? kD : kMaxD;
  const int H = kFixed ? kH : p.H;
  const int D = kFixed ? kD : p.D;
  extern __shared__ float smem[];
  float* sig = smem;
  float* tnh = sig + kLut;
  float* bz = tnh + kLut;         // runtime width only, below
  float* bh = bz + H;
  float* ws = bh + H;
  float* us = ws + H * D;
  for (int i = threadIdx.x; i < kLut; i += blockDim.x) {
    sig[i] = p.sig_lut[i];
    tnh[i] = p.tanh_lut[i];
  }
  if constexpr (!kFixed) {
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      bz[i] = p.b_z[i];
      bh[i] = p.b_h[i];
    }
    for (int i = threadIdx.x; i < H * D; i += blockDim.x) ws[i] = p.w[i];
    for (int i = threadIdx.x; i < H * H; i += blockDim.x) us[i] = p.u[i];
  }
  __syncthreads();

  // With fixed sizes every index below is a compile-time constant after
  // unrolling, so fw.* are constant-bank operands and h, x, hn registers.
  auto W = [&](int i, int j) -> float {
    if constexpr (kFixed) return fw.w[i * kD + j];
    else return ws[i * D + j];
  };
  auto U = [&](int i, int j) -> float {
    if constexpr (kFixed) return fw.u[i * kH + j];
    else return us[i * H + j];
  };
  auto BZ = [&](int i) -> float {
    if constexpr (kFixed) return fw.bz[i];
    else return bz[i];
  };
  auto BH = [&](int i) -> float {
    if constexpr (kFixed) return fw.bh[i];
    else return bh[i];
  };

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const size_t B = static_cast<size_t>(p.B);
  float h[kRowH];
#pragma unroll
  for (int i = 0; i < H; ++i) h[i] = 0.0f;
  float xn[kRowD];
  if (p.T > 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) xn[j] = p.x[static_cast<size_t>(b) * D + j];
  }

  for (int t = 0; t < p.T; ++t) {
    float x[kRowD];
#pragma unroll
    for (int j = 0; j < D; ++j) x[j] = xn[j];
    if (t + 1 < p.T) {   // the next step's x, in flight while this computes
      const float* src = p.x + ((t + 1) * B + b) * D;
#pragma unroll
      for (int j = 0; j < D; ++j) xn[j] = src[j];
    }
    float hn[kRowH];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      float wx = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) wx = __fadd_rn(wx, __fmul_rn(x[j], W(i, j)));
      float uh = 0.0f;
#pragma unroll
      for (int j = 0; j < H; ++j) uh = __fadd_rn(uh, __fmul_rn(h[j], U(i, j)));
      const float pre = __fadd_rn(wx, uh);
      const float z = fastgrnn_cell::lut_nearest(sig, __fadd_rn(pre, BZ(i)));
      const float ht = fastgrnn_cell::lut_nearest(tnh, __fadd_rn(pre, BH(i)));
      hn[i] = fastgrnn_cell::gate(z, ht, h[i], p.zeta, p.nu);
    }
#pragma unroll
    for (int i = 0; i < H; ++i) h[i] = hn[i];
    float* dst = p.traj + (t * B + b) * H;
    if constexpr (kFixed) {
#pragma unroll
      for (int j = 0; j < kH / 4; ++j)
        reinterpret_cast<float4*>(dst)[j] =
            make_float4(h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3]);
    } else {
      for (int i = 0; i < H; ++i) dst[i] = h[i];
    }
  }

  float* dst = p.h_out + static_cast<size_t>(b) * H;
  if constexpr (kFixed) {
#pragma unroll
    for (int j = 0; j < kH / 4; ++j)
      reinterpret_cast<float4*>(dst)[j] =
          make_float4(h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3]);
  } else {
    for (int i = 0; i < H; ++i) dst[i] = h[i];
  }
}

// The fixed-size instantiation serves the paper's width when traj and
// h_out take 16-byte vector stores.
bool fixed_width(int H, int D, const float* traj, const float* h_out) {
  return H == kFixedH && D == kFixedD &&
         reinterpret_cast<uintptr_t>(traj) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(h_out) % 16 == 0;
}

template <int kH, int kD>
cudaError_t launch(const WindowParams& p,
                   const FixedWeights<kFixedH, kFixedD>& fw,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kLut + (kH > 0 ? 0 : 2 * p.H + p.H * p.D +
                                                    p.H * p.H));
  const int blocks = (p.B + kThreads - 1) / kThreads;
  fastgrnn_window_kernel<kH, kD><<<blocks, kThreads, smem, stream>>>(p, fw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one window scan.  w, u, b_z, b_h are device copies of the
// effective weights and biases (read at any width); w_host, u_host,
// bz_host, bh_host the same values in host memory (read at the paper's
// width, where they travel by value).  Returns cudaSuccess (0) or the
// launch error; a shape outside the kernel's fixed per-thread buffers
// returns cudaErrorInvalidValue without launching.
int fastgrnn_window_launch(const float* x, float* traj, float* h_out, int T,
                           int B, int H, int D, const float* w,
                           const float* u, const float* b_z,
                           const float* b_h, const float* w_host,
                           const float* u_host, const float* bz_host,
                           const float* bh_host, const float* sig_lut,
                           const float* tanh_lut, float zeta, float nu,
                           void* stream) {
  if (T < 0 || B < 0 || H < 1 || H > kMaxH || D < 1 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const WindowParams p{x, traj, h_out, T, B, H, D, w, u, b_z, b_h, sig_lut,
                       tanh_lut, zeta, nu};
  FixedWeights<kFixedH, kFixedD> fw{};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fixed_width(H, D, traj, h_out))
    return static_cast<int>(launch<0, 0>(p, fw, s));
  for (int i = 0; i < kFixedH * kFixedD; ++i) fw.w[i] = w_host[i];
  for (int i = 0; i < kFixedH * kFixedH; ++i) fw.u[i] = u_host[i];
  for (int i = 0; i < kFixedH; ++i) {
    fw.bz[i] = bz_host[i];
    fw.bh[i] = bh_host[i];
  }
  return static_cast<int>(launch<kFixedH, kFixedD>(p, fw, s));
}

// 1 when a launch at this width and these addresses runs the instantiation
// with fixed sizes, 0 when it runs the one with runtime sizes.
int fastgrnn_window_fixed(int H, int D, const float* traj,
                          const float* h_out) {
  return fixed_width(H, D, traj, h_out);
}

const char* fastgrnn_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
