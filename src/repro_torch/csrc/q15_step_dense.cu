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
// tensor core is used: TF32, or a 3xTF32 split, would change the rounding
// of the ascending-j float32 sums.
//
// Bound: HBM bytes.  Per stream-step it reads x (D*4 = 12 B), h (H*4 =
// 64 B) and the mask byte and writes h' (64 B): 141 B, about 18.5 MB per
// step at S = 131,072, 5.5 us at 3.35 TB/s, against 2(DH + HH) + 10H =
// 768 operations (~1.5 us at the fp32 rate).  The instructions come close
// behind the bytes: with the LUT indexing, the weight reads and the data
// movement the card issues well over 1,100 a row, so the design overlaps
// the cell with the copies as finely as it can.
//
// Two kernels:
//
// * q15_step_dense_kernel_fixed<16, 3> runs the paper's width (H = 16,
//   d = 3) when h and out are 16-byte aligned, whatever the rank of the
//   model: the dense layout always multiplies by the H x d and H x H
//   effective matrices.  Its cell is K1's full-rank deployed cell (no
//   storage), on the tiled persistent pipeline of step_tiles.cuh: the row
//   in registers, the weights read from 16-byte padded shared rows as
//   float4 broadcasts, tiles of 256 rows of h moved in and out by bulk
//   asynchronous copies (the next tile's in flight), x and the mask one
//   tile ahead, inactive rows taking h by a select, a persistent grid of
//   two blocks an SM with an even split of tiles, and the block's
//   constants loaded in one round before the first tile's copy.
//   Unlike K1 a tile moves in eight parts, one a warp (2 KB, its own
//   mbarriers): a warp starts on its rows as soon as they land and copies
//   them out as soon as it has written them, with no block barrier, so
//   the cell overlaps the other warps' copies.
// * q15_step_dense_kernel_any runs every other width or alignment: one
//   thread a row, sizes at run time.
//
// Plain C interface (loaded with ctypes); launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fastgrnn_cell.cuh"
#include "step_tiles.cuh"

namespace {

using step_tiles::cell;
using step_tiles::Constants;
using step_tiles::kLut;
using step_tiles::kTile;
using step_tiles::Layout;
using step_tiles::NoStorage;
using step_tiles::Plan;
using step_tiles::tile_loop;

constexpr int kMaxH = 64;
constexpr int kMaxD = 16;
constexpr int kThreads = 256;          // q15_step_dense_kernel_any
constexpr int kWarps = kTile / 32;     // a fixed-width tile moves a warp's
                                       // rows at a time

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

// ---------------------------------------------------------------------------
// q15_step_dense_kernel_any: every width, one thread a row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
q15_step_dense_kernel_any(DenseParams p) {
  const int H = p.H, D = p.D;
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
  for (int i = 0; i < H; ++i) {
    float wx = 0.0f;
    for (int j = 0; j < D; ++j)
      wx = __fadd_rn(wx, __fmul_rn(x[j], w[i * D + j]));
    float uh = 0.0f;
    for (int j = 0; j < H; ++j)
      uh = __fadd_rn(uh, __fmul_rn(h[j], u[i * H + j]));
    const float pre = __fadd_rn(wx, uh);
    const float z = fastgrnn_cell::lut_nearest(sig, __fadd_rn(pre, bz[i]));
    const float ht = fastgrnn_cell::lut_nearest(tnh, __fadd_rn(pre, bh[i]));
    p.out[hoff + i] = fastgrnn_cell::gate(z, ht, h[i], p.zeta, p.nu);
  }
}

// ---------------------------------------------------------------------------
// q15_step_dense_kernel_fixed: the paper's width, on step_tiles.cuh's
// pipeline
// ---------------------------------------------------------------------------

// Two blocks an SM (at most 128 registers a thread), as K1.
template <int kH, int kD>
__global__ void __launch_bounds__(kTile, 2)
q15_step_dense_kernel_fixed(DenseParams p) {
  using L = Layout<kH, kD, 0, 0, kWarps>;
  using C = Constants<L>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  // the effective weights as one flat index space: W, then U
  C cst;
  cst.fetch(p, threadIdx.x, [&](int i) {
    if (i < C::nA) return p.w[i];
    if (i < C::nW) return p.u[i - C::nA];
    return 0.0f;
  });
  tile_loop<L>(p, sm, cst, [&](const float (&x)[kD], const float (&h)[kH],
                               float (&hn)[kH]) {
    cell<L>(sm, NoStorage{}, p.zeta, p.nu, x, h, hn);
  });
}

// The fixed-width kernel serves the paper's width when h and out are
// 16-byte aligned: the bulk copies and the 16-byte row chunks need it.
bool fixed_width(int H, int D, const float* h, const float* out) {
  return H == 16 && D == 3 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// The plan of a launch (S >= 1); with `report`, the runtime-width kernel's
// resident blocks an SM too (its grid does not need them).
cudaError_t make_plan(int S, int H, int D, const float* h, const float* out,
                      bool report, Plan* pl) {
  if (!fixed_width(H, D, h, out)) {
    *pl = {reinterpret_cast<const void*>(&q15_step_dense_kernel_any), 0,
           (S + kThreads - 1) / kThreads, kThreads, kThreads, 0,
           sizeof(float) * (2 * kLut + 2 * H + H * D + H * H)};
    int sms = 0;
    return report ? step_tiles::occupancy(*pl, -1, &pl->per_sm, &sms)
                  : cudaSuccess;
  }
  *pl = {reinterpret_cast<const void*>(&q15_step_dense_kernel_fixed<16, 3>),
         1, 0, kTile, kTile, 0, Layout<16, 3, 0, 0, kWarps>::kBytes};
  return step_tiles::persistent_grid(S, 0, pl);
}

bool valid_shape(int S, int H, int D) {
  return S >= 0 && H >= 1 && H <= kMaxH && D >= 1 && D <= kMaxD;
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
  if (!valid_shape(S, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  DenseParams p{h, x, mask, out, S, H, D, w, u, b_z, b_h, sig_lut,
                tanh_lut, zeta, nu};
  Plan pl;
  cudaError_t err = make_plan(S, H, D, h, out, false, &pl);
  if (err == cudaSuccess)
    err = step_tiles::launch(pl, &p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// What a launch of S >= 1 rows at this width and these addresses runs, into
// plan[0..7]: the fixed-width code (1) or not (0), blocks, threads a block,
// rows a tile, dynamic shared memory in bytes, resident blocks an SM, and
// the chosen kernel's local memory (bytes a thread) and registers a thread.
int q15_step_dense_plan(int S, int H, int D, const float* h,
                        const float* out, int* plan) {
  if (S < 1 || !valid_shape(S, H, D))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  cudaError_t err = make_plan(S, H, D, h, out, true, &pl);
  if (err == cudaSuccess) err = step_tiles::report(pl, plan);
  return static_cast<int>(err);
}

const char* q15_step_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
