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
// 64 B) and the mask byte and writes h' (64 B): 141 B, about 18.5 MB per
// step at S = 131,072, 5.5 us at 3.35 TB/s.  The instructions come close
// behind: every multiply and add is its own instruction, about 1,100 a row
// at the paper's width with the LUT indexing and the data movement, which
// the card issues in about 4.5 us.
//
// Two kernels:
//
// * q15_step_kernel_fixed<H, D, RW, RU> runs the paper's width (H = 16,
//   d = 3; low rank r_w = 2, r_u = 8, or full rank) when h and out are
//   16-byte aligned, on the tiled persistent pipeline of step_tiles.cuh
//   (which K2, q15_step_dense.cu, shares).
//   - Every size is a compile-time constant, so every loop unrolls and the
//     row (h, x, W2^T x, U2^T h, the new h) lives in registers: no stack
//     frame.  The activation-storage bits are one block-uniform branch
//     between two instantiations of the cell, so the deployed cell (no
//     storage) is one basic block that the compiler schedules across all
//     16 outputs.
//   - The weights are dequantized once per block into shared memory, each
//     row padded to 16 bytes, and read as float4 broadcasts.  U2^T h is
//     summed with j outer and k inner, so each accumulator still adds its
//     terms j ascending from +0.
//   - The grid is persistent: at most one block per resident slot (two an
//     SM), each walking over the same number of tiles of kTile rows.  A
//     tile of h is one contiguous run of global memory.  One thread moves
//     it into shared memory with one bulk asynchronous copy (cp.async.bulk,
//     completing on an mbarrier), the next tile's copy in flight while the
//     block computes this one, and moves the new h out with one bulk copy.
//     x and the mask come straight from global memory (a warp's rows are
//     one contiguous run), the next tile's ahead in registers.
//   - The block's constants (LUTs, biases, weights) are fetched with every
//     load issued at once, before the tile copies: behind them they would
//     wait for the card's whole first wave of DRAM traffic.
//   - The LUT bucket is fastgrnn_cell.cuh's nearest bucket without its
//     saturation overrides, which the index clamp already implies.
// * q15_step_kernel_any runs every other width or alignment: one thread a
//   row, sizes at run time.
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
constexpr int kMaxR = 32;
constexpr int kThreads = 256;          // q15_step_kernel_any

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

// ---------------------------------------------------------------------------
// q15_step_kernel_any: every width, one thread a row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
q15_step_kernel_any(StepParams p) {
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

// ---------------------------------------------------------------------------
// q15_step_kernel_fixed: the paper's width, on step_tiles.cuh's pipeline
// ---------------------------------------------------------------------------

// K1's activation storage for the cell: the Q15 rounding of each stored
// activation (p.store's bits).
struct Q15Storage {
  const StepParams& p;
  __device__ __forceinline__ float pre(float v) const {
    return (p.store & kStorePre) ? store_q15(v, p.s_pre) : v;
  }
  __device__ __forceinline__ float z(float v) const {
    return (p.store & kStoreZ) ? store_q15(v, p.s_z) : v;
  }
  __device__ __forceinline__ float ht(float v) const {
    return (p.store & kStoreHt) ? store_q15(v, p.s_ht) : v;
  }
  __device__ __forceinline__ float h(float v) const {
    return (p.store & kStoreH) ? store_q15(v, p.s_h) : v;
  }
};

// Two blocks an SM (at most 128 registers a thread): the cell's registers
// against the warps that hide its latencies.
template <int kH, int kD, int kRW, int kRU>
__global__ void __launch_bounds__(kTile, 2)
q15_step_kernel_fixed(StepParams p) {
  using L = Layout<kH, kD, kRW, kRU>;
  using C = Constants<L>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  // the weights dequantized, as one flat index space: wa, wb, ua, ub
  C cst;
  cst.fetch(p, threadIdx.x, [&](int i) {
    if (i < C::nA) return __fmul_rn(static_cast<float>(p.wa[i]), p.s_wa);
    if (i < C::nA + C::nB)
      return __fmul_rn(static_cast<float>(p.wb[i - C::nA]), p.s_wb);
    if (i < C::nA + C::nB + C::nU)
      return __fmul_rn(static_cast<float>(p.ua[i - C::nA - C::nB]), p.s_ua);
    if (i < C::nW)
      return __fmul_rn(static_cast<float>(p.ub[i - C::nA - C::nB - C::nU]),
                       p.s_ub);
    return 0.0f;
  });
  tile_loop<L>(p, sm, cst, [&](const float (&x)[kD], const float (&h)[kH],
                               float (&hn)[kH]) {
    if (p.store)
      cell<L>(sm, Q15Storage{p}, p.zeta, p.nu, x, h, hn);
    else
      cell<L>(sm, NoStorage{}, p.zeta, p.nu, x, h, hn);
  });
}

// The fixed-width kernel serves the paper's width (H = 16, d = 3; low rank
// r_w = 2, r_u = 8, or full rank) when h and out are 16-byte aligned: the
// bulk copies and the 16-byte row chunks need it.
bool fixed_width(int H, int D, int low_rank, int RW, int RU, const float* h,
                 const float* out) {
  return H == 16 && D == 3 && (!low_rank || (RW == 2 && RU == 8)) &&
         reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

size_t any_smem(int H, int D, int low_rank, int RW, int RU) {
  const int n_w = low_rank ? H * RW + D * RW + 2 * H * RU : H * D + H * H;
  return sizeof(float) * (2 * kLut + 2 * H + n_w);
}

// The plan of a launch (S >= 1); with `report`, the runtime-width kernel's
// resident blocks an SM too (its grid does not need them).
cudaError_t make_plan(int S, int H, int D, int low_rank, int RW, int RU,
                      const float* h, const float* out, bool report,
                      Plan* pl) {
  if (!fixed_width(H, D, low_rank, RW, RU, h, out)) {
    *pl = {reinterpret_cast<const void*>(&q15_step_kernel_any), 0,
           (S + kThreads - 1) / kThreads, kThreads, kThreads, 0,
           any_smem(H, D, low_rank, RW, RU)};
    int sms = 0;
    return report ? step_tiles::occupancy(*pl, -1, &pl->per_sm, &sms)
                  : cudaSuccess;
  }
  if (low_rank)
    *pl = {reinterpret_cast<const void*>(&q15_step_kernel_fixed<16, 3, 2, 8>),
           1, 0, kTile, kTile, 0, Layout<16, 3, 2, 8>::kBytes};
  else
    *pl = {reinterpret_cast<const void*>(&q15_step_kernel_fixed<16, 3, 0, 0>),
           1, 0, kTile, kTile, 0, Layout<16, 3, 0, 0>::kBytes};
  return step_tiles::persistent_grid(S, low_rank ? 0 : 1, pl);
}

bool valid_shape(int S, int H, int D, int low_rank, int RW, int RU) {
  return S >= 0 && H >= 1 && H <= kMaxH && D >= 1 && D <= kMaxD &&
         (!low_rank || (RW >= 1 && RW <= kMaxR && RU >= 1 && RU <= kMaxR));
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
  if (!valid_shape(S, H, D, low_rank, RW, RU))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  StepParams p{h, x, mask, out, S, H, D, low_rank, RW, RU, wa, wb, ua, ub,
               s_wa, s_wb, s_ua, s_ub, b_z, b_h, sig_lut, tanh_lut, zeta,
               nu, store, s_pre, s_z, s_ht, s_h};
  Plan pl;
  cudaError_t err = make_plan(S, H, D, low_rank, RW, RU, h, out, false, &pl);
  if (err == cudaSuccess)
    err = step_tiles::launch(pl, &p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// What a launch of S >= 1 rows at this width and these addresses runs, into
// plan[0..7]: the fixed-width code (1) or not (0), blocks, threads a block,
// rows a tile, dynamic shared memory in bytes, resident blocks an SM, and
// the chosen kernel's local memory (bytes a thread) and registers a thread.
int q15_step_plan(int S, int H, int D, int low_rank, int RW, int RU,
                  const float* h, const float* out, int* plan) {
  if (S < 1 || !valid_shape(S, H, D, low_rank, RW, RU))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  cudaError_t err = make_plan(S, H, D, low_rank, RW, RU, h, out, true, &pl);
  if (err == cudaSuccess) err = step_tiles::report(pl, plan);
  return static_cast<int>(err);
}

const char* q15_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
