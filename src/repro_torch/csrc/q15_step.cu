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
//   16-byte aligned.
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

namespace {

constexpr int kMaxH = 64;
constexpr int kMaxD = 16;
constexpr int kMaxR = 32;
constexpr int kLut = fastgrnn_cell::kLut;
constexpr int kThreads = 256;          // q15_step_kernel_any
constexpr int kTile = 256;             // rows (and threads) a fixed-width tile

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
// q15_step_kernel_fixed: the paper's width
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// Shared memory of the fixed kernel, in floats; every region and every
// weight row starts on a 16-byte boundary.  Low rank: wa = W1 (H rows of
// RW), wb = W2 (D rows of RW), ua = U1 (H rows of RU), ub = U2 (H rows of
// RU); full rank: wa = W (H rows of D), ua = U (H rows of H).
template <int kH, int kD, int kRW, int kRU>
struct Layout {
  static constexpr bool kLow = kRW > 0;
  static constexpr int kColsA = kLow ? kRW : kD;    // wa's row
  static constexpr int kColsU = kLow ? kRU : kH;    // ua's row
  static constexpr int sA = pad4(kColsA), sU = pad4(kColsU);
  static constexpr int sB = kLow ? pad4(kRW) : 0, sV = kLow ? pad4(kRU) : 0;
  static constexpr int oSig = 0, oTnh = kLut, oBz = 2 * kLut;
  static constexpr int oBh = oBz + pad4(kH);
  static constexpr int oWA = oBh + pad4(kH);
  static constexpr int oWB = oWA + kH * sA;
  static constexpr int oUA = oWB + kD * sB;
  static constexpr int oUB = oUA + kH * sU;
  static constexpr int kFloats = oUB + kH * sV;
  static constexpr int oBar = kFloats;               // two mbarriers (16 B)
  static constexpr int oTile = kFloats + 4;          // two tiles of h
  static constexpr int kTileFloats = kTile * kH;
  static constexpr size_t kBytes = sizeof(float) * (oTile + 2 * kTileFloats);
};

// The block's constants: both LUTs, the biases and the dequantized
// weights.  fetch() issues every global load before any use, so the block
// waits for one round of memory latency; store() puts them in place.
template <int kH, int kD, int kRW, int kRU>
struct Constants {
  using L = Layout<kH, kD, kRW, kRU>;
  // the weights as one flat index space: wa, wb, ua, ub (row-major each)
  static constexpr int nA = kH * L::kColsA, nB = L::kLow ? kD * kRW : 0;
  static constexpr int nU = kH * L::kColsU, nV = L::kLow ? kH * kRU : 0;
  static constexpr int nW = nA + nB + nU + nV;
  static constexpr int kPerW = (nW + kTile - 1) / kTile;
  static constexpr int kPerL = (kLut + kTile - 1) / kTile;
  float w[kPerW], sg[kPerL], th[kPerL], bz = 0.0f, bh = 0.0f;

  __device__ __forceinline__ void fetch(const StepParams& p, int tid) {
#pragma unroll
    for (int k = 0; k < kPerW; ++k) {
      const int i = tid + k * kTile;
      w[k] = 0.0f;
      if (i < nA)
        w[k] = __fmul_rn(static_cast<float>(p.wa[i]), p.s_wa);
      else if (i < nA + nB)
        w[k] = __fmul_rn(static_cast<float>(p.wb[i - nA]), p.s_wb);
      else if (i < nA + nB + nU)
        w[k] = __fmul_rn(static_cast<float>(p.ua[i - nA - nB]), p.s_ua);
      else if (i < nW)
        w[k] = __fmul_rn(static_cast<float>(p.ub[i - nA - nB - nU]), p.s_ub);
    }
#pragma unroll
    for (int k = 0; k < kPerL; ++k) {
      const int i = tid + k * kTile;
      if (i < kLut) {
        sg[k] = p.sig_lut[i];
        th[k] = p.tanh_lut[i];
      }
    }
    if (tid < kH) {
      bz = p.b_z[tid];
      bh = p.b_h[tid];
    }
  }

  __device__ __forceinline__ void store(float* sm, int tid) const {
#pragma unroll
    for (int k = 0; k < kPerW; ++k) {
      const int i = tid + k * kTile;
      if (i < nA)
        sm[L::oWA + (i / L::kColsA) * L::sA + i % L::kColsA] = w[k];
      else if (i < nA + nB)
        sm[L::oWB + ((i - nA) / kRW) * L::sB + (i - nA) % kRW] = w[k];
      else if (i < nA + nB + nU)
        sm[L::oUA + ((i - nA - nB) / L::kColsU) * L::sU +
           (i - nA - nB) % L::kColsU] = w[k];
      else if (i < nW)
        sm[L::oUB + ((i - nA - nB - nU) / kRU) * L::sV +
           (i - nA - nB - nU) % kRU] = w[k];
    }
#pragma unroll
    for (int k = 0; k < kPerL; ++k) {
      const int i = tid + k * kTile;
      if (i < kLut) {
        sm[L::oSig + i] = sg[k];
        sm[L::oTnh + i] = th[k];
      }
    }
    if (tid < kH) {
      sm[L::oBz + tid] = bz;
      sm[L::oBh + tid] = bh;
    }
  }
};

// One weight row of N values from a 16-byte aligned row padded to 16
// bytes: float4 broadcasts.
template <int N>
__device__ __forceinline__ void weight_row(const float* p, float (&v)[N]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int c = 0; c < pad4(N) / 4; ++c) {
    const float4 t = q[c];
    const float e[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * c + k < N) v[4 * c + k] = e[k];
  }
}

// fastgrnn_cell::lut_nearest without its saturation overrides, which the
// index clamp already implies: v >= 8 makes (v + 8) * 16 >= 256 (the sum
// and the product round monotonically), so the index clamps to 255; v <= -8
// makes it <= 0 (index 0); NaN gives index 0 and fails both override
// tests.  So the value is the same, bit for bit.
__device__ __forceinline__ float lut_bucket(const float* t, float v) {
  int idx = __float2int_rz(__fmul_rn(__fsub_rn(v, -8.0f), 16.0f));
  idx = idx < 0 ? 0 : (idx > kLut - 1 ? kLut - 1 : idx);
  return t[idx];
}

// The step for one row held in registers (x, h in; hn out), from the
// weights, biases and LUTs in shared memory.  kStore: whether any
// activation is stored in Q15 (p.store != 0).
template <int kH, int kD, int kRW, int kRU, bool kStore>
__device__ __forceinline__ void cell(const float* sm, const StepParams& p,
                                     const float (&x)[kD],
                                     const float (&h)[kH],
                                     float (&hn)[kH]) {
  using L = Layout<kH, kD, kRW, kRU>;
  const float* sig = sm + L::oSig;
  const float* tnh = sm + L::oTnh;
  const bool st_pre = kStore && (p.store & kStorePre);
  const bool st_z = kStore && (p.store & kStoreZ);
  const bool st_ht = kStore && (p.store & kStoreHt);
  const bool st_h = kStore && (p.store & kStoreH);
  float tw[L::kLow ? kRW : 1], tu[L::kLow ? kRU : 1];
  if constexpr (L::kLow) {
    // W2^T x and U2^T h, j outer and k inner: each tw[k] / tu[k] still
    // adds its terms j ascending from +0
#pragma unroll
    for (int k = 0; k < kRW; ++k) tw[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < kRU; ++k) tu[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      float w[kRW];
      weight_row<kRW>(sm + L::oWB + j * L::sB, w);
#pragma unroll
      for (int k = 0; k < kRW; ++k)
        tw[k] = __fadd_rn(tw[k], __fmul_rn(x[j], w[k]));
    }
#pragma unroll
    for (int j = 0; j < kH; ++j) {
      float u[kRU];
      weight_row<kRU>(sm + L::oUB + j * L::sV, u);
#pragma unroll
      for (int k = 0; k < kRU; ++k)
        tu[k] = __fadd_rn(tu[k], __fmul_rn(h[j], u[k]));
    }
  }
#pragma unroll
  for (int i = 0; i < kH; ++i) {
    float a[L::kColsA], u[L::kColsU];
    weight_row<L::kColsA>(sm + L::oWA + i * L::sA, a);
    weight_row<L::kColsU>(sm + L::oUA + i * L::sU, u);
    float wx = 0.0f, uh = 0.0f;
    if constexpr (L::kLow) {
#pragma unroll
      for (int k = 0; k < kRW; ++k) wx = __fadd_rn(wx, __fmul_rn(tw[k], a[k]));
#pragma unroll
      for (int k = 0; k < kRU; ++k) uh = __fadd_rn(uh, __fmul_rn(tu[k], u[k]));
    } else {
#pragma unroll
      for (int j = 0; j < kD; ++j) wx = __fadd_rn(wx, __fmul_rn(x[j], a[j]));
#pragma unroll
      for (int j = 0; j < kH; ++j) uh = __fadd_rn(uh, __fmul_rn(h[j], u[j]));
    }
    float pre = __fadd_rn(wx, uh);
    if (st_pre) pre = store_q15(pre, p.s_pre);
    float z = lut_bucket(sig, __fadd_rn(pre, sm[L::oBz + i]));
    float ht = lut_bucket(tnh, __fadd_rn(pre, sm[L::oBh + i]));
    if (st_z) z = store_q15(z, p.s_z);
    if (st_ht) ht = store_q15(ht, p.s_ht);
    float v = fastgrnn_cell::gate(z, ht, h[i], p.zeta, p.nu);
    if (st_h) v = store_q15(v, p.s_h);
    hn[i] = v;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16) from global to shared
// memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT_%=:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT_%=;\n}"
      ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// One bulk copy of `bytes` from shared to global memory, in a bulk group.
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// A tile row of 16 floats moves as four 16-byte chunks: at step c a thread
// reads (or writes) slot (c + rot) & 3 of its row.  A row is 64 bytes, so
// rows of one parity share their banks; with rot = (tid >> 1) & 3 the
// eight threads of a 16-byte phase (four rotations x two parities) hit
// eight different groups of four banks.  Selects put the chunks back in
// order, so every register index stays a compile-time constant.
__device__ __forceinline__ void tile_row_load(const float* t, int rot,
                                              float (&h)[16]) {
  const float4* q = reinterpret_cast<const float4*>(t);
  float4 v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = q[(c + rot) & 3];
  // v[c] holds chunk (c + rot) & 3; chunk m is v[(m - rot) & 3]
  const bool r1 = rot & 1, r2 = rot & 2;
  float4 b[4], o[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) b[m] = r1 ? v[(m + 3) & 3] : v[m];
#pragma unroll
  for (int m = 0; m < 4; ++m) o[m] = r2 ? b[(m + 2) & 3] : b[m];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    h[4 * m] = o[m].x;
    h[4 * m + 1] = o[m].y;
    h[4 * m + 2] = o[m].z;
    h[4 * m + 3] = o[m].w;
  }
}

__device__ __forceinline__ void tile_row_store(float* t, int rot,
                                               const float (&h)[16]) {
  float4 o[4], b[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    o[m] = make_float4(h[4 * m], h[4 * m + 1], h[4 * m + 2], h[4 * m + 3]);
  // slot (c + rot) & 3 takes chunk (c + rot) & 3 at step c
  const bool r1 = rot & 1, r2 = rot & 2;
#pragma unroll
  for (int c = 0; c < 4; ++c) b[c] = r1 ? o[(c + 1) & 3] : o[c];
  float4* q = reinterpret_cast<float4*>(t);
#pragma unroll
  for (int c = 0; c < 4; ++c) q[(c + rot) & 3] = r2 ? b[(c + 2) & 3] : b[c];
}

// Two blocks an SM (at most 128 registers a thread): the cell's registers
// against the warps that hide its latencies.
template <int kH, int kD, int kRW, int kRU>
__global__ void __launch_bounds__(kTile, 2)
q15_step_kernel_fixed(StepParams p) {
  static_assert(kH == 16, "a tile row is four 16-byte chunks");
  using L = Layout<kH, kD, kRW, kRU>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::oBar);
  float* tiles = sm + L::oTile;
  const int tid = threadIdx.x;
  const int ntiles = (p.S + kTile - 1) / kTile;   // the grid has no more
  const int stride = gridDim.x;

  auto copy_in = [&](int tile, int buf) {
    const int rows = min(kTile, p.S - tile * kTile);
    bulk_load(tiles + buf * L::kTileFloats,
              p.h + static_cast<size_t>(tile) * L::kTileFloats,
              static_cast<uint32_t>(rows * kH * sizeof(float)), &bar[buf]);
  };
  float xn[kD];
  bool actn = false;
  auto fetch_x = [&](int tile) {
    const int row = tile * kTile + tid;
#pragma unroll
    for (int j = 0; j < kD; ++j) xn[j] = 0.0f;
    actn = false;
    if (row < p.S) {
      actn = p.mask[row] != 0;
#pragma unroll
      for (int j = 0; j < kD; ++j)
        xn[j] = p.x[static_cast<size_t>(row) * kD + j];
    }
  };
  // The constants' loads first, then the first tile's x and its copy:
  // behind the copies the constants would wait for the card's first wave
  // of DRAM traffic.
  Constants<kH, kD, kRW, kRU> cst;
  cst.fetch(p, tid);
  fetch_x(blockIdx.x);
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    copy_in(blockIdx.x, 0);
  }
  cst.store(sm, tid);
  __syncthreads();

  const int rot = (tid >> 1) & 3;
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += stride, ++it) {
    const int buf = it & 1;
    const int rows = min(kTile, p.S - tile * kTile);
    float x[kD];
#pragma unroll
    for (int j = 0; j < kD; ++j) x[j] = xn[j];
    const bool act = actn;
    const bool more = tile + stride < ntiles;
    if (more) fetch_x(tile + stride);
    float* t = tiles + buf * L::kTileFloats;
    if (tid == 0 && more) {
      // the other buffer's last store has read it: refill it
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      copy_in(tile + stride, buf ^ 1);
    }
    mbar_wait(&bar[buf], (it >> 1) & 1);
    float h[kH], hn[kH];
    tile_row_load(t + tid * kH, rot, h);
    if (p.store)
      cell<kH, kD, kRW, kRU, true>(sm, p, x, h, hn);
    else
      cell<kH, kD, kRW, kRU, false>(sm, p, x, h, hn);
    if (!act) {  // inactive stream: its state bit for bit
#pragma unroll
      for (int i = 0; i < kH; ++i) hn[i] = h[i];
    }
    tile_row_store(t + tid * kH, rot, hn);
    // the block's writes to the tile, then one bulk copy out
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0)
      bulk_store(p.out + static_cast<size_t>(tile) * L::kTileFloats, t,
                 static_cast<uint32_t>(rows * kH * sizeof(float)));
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

// What a launch at one shape runs: the kernel, its grid and shared memory.
struct Plan {
  const void* fn;
  int fixed, blocks, threads, tile, per_sm;
  size_t smem;
};

size_t any_smem(int H, int D, int low_rank, int RW, int RU) {
  const int n_w = low_rank ? H * RW + D * RW + 2 * H * RU : H * D + H * H;
  return sizeof(float) * (2 * kLut + 2 * H + n_w);
}

// The SMs of the current device and the resident blocks an SM of each
// fixed-width kernel (low rank, full rank), asked once per device.
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_per_sm[kMaxDevices][2];

cudaError_t occupancy(const Plan& pl, int which, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices && which >= 0;
  if (cached && g_per_sm[dev][which] > 0) {
    *per_sm = g_per_sm[dev][which];
    *sms = g_sms[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && pl.smem > 48 * 1024)
    err = cudaFuncSetAttribute(pl.fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(pl.smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pl.fn,
                                                        pl.threads, pl.smem);
  if (err == cudaSuccess && cached) {
    g_sms[dev] = *sms;
    g_per_sm[dev][which] = *per_sm;
  }
  return err;
}

// The plan of a launch (S >= 1); with `report`, the runtime-width kernel's
// resident blocks an SM too (its grid does not need them).
cudaError_t make_plan(int S, int H, int D, int low_rank, int RW, int RU,
                      const float* h, const float* out, bool report,
                      Plan* pl) {
  int sms = 0;
  if (!fixed_width(H, D, low_rank, RW, RU, h, out)) {
    *pl = {reinterpret_cast<const void*>(&q15_step_kernel_any), 0,
           (S + kThreads - 1) / kThreads, kThreads, kThreads, 0,
           any_smem(H, D, low_rank, RW, RU)};
    return report ? occupancy(*pl, -1, &pl->per_sm, &sms) : cudaSuccess;
  }
  if (low_rank)
    *pl = {reinterpret_cast<const void*>(&q15_step_kernel_fixed<16, 3, 2, 8>),
           1, 0, kTile, kTile, 0, Layout<16, 3, 2, 8>::kBytes};
  else
    *pl = {reinterpret_cast<const void*>(&q15_step_kernel_fixed<16, 3, 0, 0>),
           1, 0, kTile, kTile, 0, Layout<16, 3, 0, 0>::kBytes};
  const cudaError_t err = occupancy(*pl, low_rank ? 0 : 1, &pl->per_sm, &sms);
  if (err != cudaSuccess) return err;
  // persistent: at most one block per resident slot, every block the
  // same number of tiles (a block with one more would set the time)
  const int ntiles = (S + kTile - 1) / kTile;
  const int slots = pl->per_sm * sms;
  const int per_block = (ntiles + slots - 1) / slots;
  pl->blocks = (ntiles + per_block - 1) / per_block;
  return cudaSuccess;
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
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchKernel(pl.fn, dim3(pl.blocks), dim3(pl.threads), args,
                         pl.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, pl.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[8] = {pl.fixed, pl.blocks, pl.threads, pl.tile,
                    static_cast<int>(pl.smem), pl.per_sm,
                    static_cast<int>(attr.localSizeBytes), attr.numRegs};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return static_cast<int>(cudaSuccess);
}

const char* q15_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
