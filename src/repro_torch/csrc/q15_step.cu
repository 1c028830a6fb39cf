// One masked Q15 FastGRNN step for S independent streams, for sm_90a.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/fastgrnn_cell/kernel.py::_q15_step_kernel
// (built there by make_fastgrnn_step(mxu=False)).  It computes, per stream
// row b whose mask byte is non-zero, exactly the op sequence of the plain
// version repro_torch/kernels/fastgrnn_cell/qstep.py::step_batched (itself
// the batched image of the scalar core/qruntime.QRuntime.step):
//
//   wx  = W x            (low rank: W1 (W2^T x)),  j ascending, acc from +0
//   uh  = U h            (low rank: U1 (U2^T h))
//   pre = store(wx + uh)
//   z   = store(lut_sigmoid(pre + b_z));  ht = store(lut_tanh(pre + b_h))
//   h'  = store((zeta * (1 - z) + nu) * ht + z * h)
//
// and copies h bit for bit where the mask byte is zero.  Every multiply and
// add is an explicit round-to-nearest intrinsic and the file is built with
// --fmad=false, so no a*b+c is contracted into an FMA: the result is
// bitwise equal to the plain version and to the scalar runtime.
//
// Bound: HBM bytes.  Per stream-step it reads x (d*4 = 12 B), h (H*4 =
// 64 B) and the mask byte and writes h' (64 B): about 18.5 MB per step at
// S = 131,072, about 5.5 us at 3.35 TB/s, against ~0.1 GFLOP (~1.5 us at
// the fp32 non-tensor rate).  Weights (dequantized once per block) and both
// 256-entry LUTs live in shared memory (under 3 KB at paper width), so they
// are never re-read from HBM per row.  One thread owns one stream row.
//
// Plain C interface (loaded with ctypes); launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fastgrnn_cell.cuh"

namespace {

constexpr int kMaxH = 64;
constexpr int kMaxD = 16;
constexpr int kMaxR = 32;
constexpr int kLut = fastgrnn_cell::kLut;
constexpr int kThreads = 256;

// bits of the store-enable mask (activation storage, Table V)
constexpr int kStorePre = 1;
constexpr int kStoreZ = 2;
constexpr int kStoreHt = 4;
constexpr int kStoreH = 8;

struct StepParams {
  const float* h;          // (S, H)
  const float* x;          // (S, D)
  const uint8_t* mask;     // (S,)
  float* out;              // (S, H), fresh buffer
  int S, H, D, low_rank, RW, RU;
  // full rank: wa = W (H, D), ua = U (H, H); low rank: wa = W1 (H, RW),
  // wb = W2 (D, RW), ua = U1 (H, RU), ub = U2 (H, RU); all int16 row-major
  const int16_t* wa;
  const int16_t* wb;
  const int16_t* ua;
  const int16_t* ub;
  float s_wa, s_wb, s_ua, s_ub;
  const float* b_z;        // (H,)
  const float* b_h;        // (H,)
  const float* sig_lut;    // (256,)
  const float* tanh_lut;   // (256,)
  float zeta, nu;
  int store;               // kStore* bits
  float s_pre, s_z, s_ht, s_h;
};

// Q15 activation storage: round half to even of a correctly rounded
// quotient, clip (NaN passes through, as numpy's clip and torch.clamp
// do), dequantize.
__device__ __forceinline__ float store_q15(float t, float s) {
  float q = rintf(__fdiv_rn(t, s));
  q = q < -32768.0f ? -32768.0f : (q > 32767.0f ? 32767.0f : q);
  return __fmul_rn(q, s);
}

__device__ __forceinline__ void dequant(float* dst, const int16_t* src,
                                        int n, float s) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = __fmul_rn(static_cast<float>(src[i]), s);
}

__global__ void __launch_bounds__(kThreads)
q15_step_kernel(StepParams p) {
  extern __shared__ float smem[];
  const int H = p.H, D = p.D, RW = p.RW, RU = p.RU;
  float* sig = smem;
  float* tnh = sig + kLut;
  float* bz = tnh + kLut;
  float* bh = bz + H;
  float* wa = bh + H;
  float* wb;
  float* ua;
  float* ub;
  if (p.low_rank) {
    wb = wa + H * RW;
    ua = wb + D * RW;
    ub = ua + H * RU;
    dequant(wa, p.wa, H * RW, p.s_wa);
    dequant(wb, p.wb, D * RW, p.s_wb);
    dequant(ua, p.ua, H * RU, p.s_ua);
    dequant(ub, p.ub, H * RU, p.s_ub);
  } else {
    wb = nullptr;
    ua = wa + H * D;
    ub = nullptr;
    dequant(wa, p.wa, H * D, p.s_wa);
    dequant(ua, p.ua, H * H, p.s_ua);
  }
  for (int i = threadIdx.x; i < kLut; i += blockDim.x) {
    sig[i] = p.sig_lut[i];
    tnh[i] = p.tanh_lut[i];
  }
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    bz[i] = p.b_z[i];
    bh[i] = p.b_h[i];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.S) return;
  const size_t hoff = static_cast<size_t>(b) * H;
  if (p.mask[b] == 0) {  // inactive stream: copy its state bit for bit
    const uint32_t* src = reinterpret_cast<const uint32_t*>(p.h) + hoff;
    uint32_t* dst = reinterpret_cast<uint32_t*>(p.out) + hoff;
    for (int i = 0; i < H; ++i) dst[i] = src[i];
    return;
  }

  float h[kMaxH];
  float x[kMaxD];
  for (int j = 0; j < H; ++j) h[j] = p.h[hoff + j];
  for (int j = 0; j < D; ++j) x[j] = p.x[static_cast<size_t>(b) * D + j];

  // low-rank inner products W2^T x and U2^T h (j ascending, acc from +0)
  float tw[kMaxR];
  float tu[kMaxR];
  if (p.low_rank) {
    for (int k = 0; k < RW; ++k) {
      float acc = 0.0f;
      for (int j = 0; j < D; ++j)
        acc = __fadd_rn(acc, __fmul_rn(x[j], wb[j * RW + k]));
      tw[k] = acc;
    }
    for (int k = 0; k < RU; ++k) {
      float acc = 0.0f;
      for (int j = 0; j < H; ++j)
        acc = __fadd_rn(acc, __fmul_rn(h[j], ub[j * RU + k]));
      tu[k] = acc;
    }
  }

  const bool st_pre = p.store & kStorePre, st_z = p.store & kStoreZ;
  const bool st_ht = p.store & kStoreHt, st_h = p.store & kStoreH;
  for (int i = 0; i < H; ++i) {
    float wx = 0.0f, uh = 0.0f;
    if (p.low_rank) {
      for (int k = 0; k < RW; ++k)
        wx = __fadd_rn(wx, __fmul_rn(tw[k], wa[i * RW + k]));
      for (int k = 0; k < RU; ++k)
        uh = __fadd_rn(uh, __fmul_rn(tu[k], ua[i * RU + k]));
    } else {
      for (int j = 0; j < D; ++j)
        wx = __fadd_rn(wx, __fmul_rn(x[j], wa[i * D + j]));
      for (int j = 0; j < H; ++j)
        uh = __fadd_rn(uh, __fmul_rn(h[j], ua[i * H + j]));
    }
    float pre = __fadd_rn(wx, uh);
    if (st_pre) pre = store_q15(pre, p.s_pre);
    float z = fastgrnn_cell::lut_nearest(sig, __fadd_rn(pre, bz[i]));
    float ht = fastgrnn_cell::lut_nearest(tnh, __fadd_rn(pre, bh[i]));
    if (st_z) z = store_q15(z, p.s_z);
    if (st_ht) ht = store_q15(ht, p.s_ht);
    float hn = fastgrnn_cell::gate(z, ht, h[i], p.zeta, p.nu);
    if (st_h) hn = store_q15(hn, p.s_h);
    p.out[hoff + i] = hn;
  }
}

}  // namespace

extern "C" {

// Launch one step.  Returns cudaSuccess (0) or the launch error; a shape
// outside the kernel's fixed per-thread buffers returns
// cudaErrorInvalidValue without launching.
int q15_step_launch(const float* h, const float* x, const uint8_t* mask,
                    float* out, int S, int H, int D, int low_rank, int RW,
                    int RU, const int16_t* wa, const int16_t* wb,
                    const int16_t* ua, const int16_t* ub, float s_wa,
                    float s_wb, float s_ua, float s_ub, const float* b_z,
                    const float* b_h, const float* sig_lut,
                    const float* tanh_lut, float zeta, float nu, int store,
                    float s_pre, float s_z, float s_ht, float s_h,
                    void* stream) {
  if (S < 0 || H < 1 || H > kMaxH || D < 1 || D > kMaxD ||
      (low_rank && (RW < 1 || RW > kMaxR || RU < 1 || RU > kMaxR)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  StepParams p{h, x, mask, out, S, H, D, low_rank, RW, RU, wa, wb, ua, ub,
               s_wa, s_wb, s_ua, s_ub, b_z, b_h, sig_lut, tanh_lut, zeta,
               nu, store, s_pre, s_z, s_ht, s_h};
  const int n_w = low_rank ? H * RW + D * RW + 2 * H * RU : H * D + H * H;
  const size_t smem = sizeof(float) * (2 * kLut + 2 * H + n_w);
  const int blocks = (S + kThreads - 1) / kThreads;
  q15_step_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* q15_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
