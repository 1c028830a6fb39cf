// The fixed-width step pipeline shared by K1 (q15_step.cu) and K2
// (q15_step_dense.cu) at the paper's width (H = 16, d = 3): the block's
// constants in padded shared memory, the cell for one row in registers,
// and the persistent loop over tiles of kTile rows that bulk asynchronous
// copies move in and out.  Each kernel keeps its own __global__ entry and
// its own constants loader (K1 dequantizes int16 weights, K2 reads the
// effective float32 ones); what they share is here.
//
// * Layout: shared memory in floats; every region and every weight row
//   starts on a 16-byte boundary, so a row is read as float4 broadcasts.
// * Constants: the LUTs, the biases and the weights, every global load
//   issued at once before any use (one round of memory latency), then put
//   in place.  Behind the tile copies they would wait for the card's whole
//   first wave of DRAM traffic, so tile_loop issues the copies after them.
// * cell: the step of one row, each accumulator adding its terms j
//   ascending from +0, every multiply and add its own round-to-nearest
//   intrinsic (the files build with --fmad=false).  The activation storage
//   is a policy type: K1's Q15 rounding, or none.
// * tile_loop: a persistent grid, each block walking over the same number
//   of tiles.  A tile of h is one contiguous run of global memory, moved
//   in parts (Layout's kParts: 1 for K1, one a warp for K2).  One thread a
//   part moves it into shared memory with one cp.async.bulk completing on
//   the part's mbarrier, the next tile's copy in flight while the part's
//   threads compute this one, and moves the new h out with one bulk copy
//   once they have written it (a block barrier for a whole tile, a warp's
//   for a warp's part).  x and the mask come straight from global memory,
//   the next tile's ahead in registers.  Inactive rows take h by a
//   select.
// * The host side: the plan of a launch (kernel, grid, shared memory) from
//   the occupancy query, and the report the plan queries write.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fastgrnn_cell.cuh"

namespace step_tiles {
// Internal linkage: each kernel library keeps its own copy of this code and
// of the occupancy cache below (a symbol shared between libraries would
// hand one kernel's cached occupancy to another).
namespace {

constexpr int kLut = fastgrnn_cell::kLut;
constexpr int kTile = 256;             // rows (and threads) a tile

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// Shared memory of a fixed-width kernel, in floats.  Low rank (kRW > 0):
// wa = W1 (H rows of RW), wb = W2 (D rows of RW), ua = U1 (H rows of RU),
// ub = U2 (H rows of RU); full rank: wa = W (H rows of D), ua = U (H rows
// of H).  A tile moves in kParts parts of kTile / kParts rows, each with
// two mbarriers (one a buffer).
template <int kH, int kD, int kRW, int kRU, int kParts = 1>
struct Layout {
  static constexpr int H = kH, D = kD, RW = kRW, RU = kRU, Parts = kParts;
  static_assert(kTile % (32 * kParts) == 0, "a part is whole warps");
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
  static constexpr int oBar = kFloats;               // 2 kParts mbarriers
  static constexpr int oTile = kFloats + 4 * kParts; // two tiles of h
  static constexpr int kTileFloats = kTile * kH;
  static constexpr size_t kBytes = sizeof(float) * (oTile + 2 * kTileFloats);
};

// The block's constants: both LUTs, the biases and the weights.  fetch()
// issues every global load before any use, so the block waits for one
// round of memory latency; store() puts them in place.  The weights are
// one flat index space, wa, wb, ua, ub (row-major each): `weight(i)` is
// flat weight i as float32 for i < nW, and 0 beyond.
template <class L>
struct Constants {
  static constexpr int nA = L::H * L::kColsA, nB = L::kLow ? L::D * L::RW : 0;
  static constexpr int nU = L::H * L::kColsU, nV = L::kLow ? L::H * L::RU : 0;
  static constexpr int nW = nA + nB + nU + nV;
  static constexpr int kPerW = (nW + kTile - 1) / kTile;
  static constexpr int kPerL = (kLut + kTile - 1) / kTile;
  float w[kPerW], sg[kPerL], th[kPerL], bz = 0.0f, bh = 0.0f;

  // P: the kernel's parameters (sig_lut, tanh_lut, b_z, b_h)
  template <class P, class W>
  __device__ __forceinline__ void fetch(const P& p, int tid, W weight) {
#pragma unroll
    for (int k = 0; k < kPerW; ++k) w[k] = weight(tid + k * kTile);
#pragma unroll
    for (int k = 0; k < kPerL; ++k) {
      const int i = tid + k * kTile;
      if (i < kLut) {
        sg[k] = p.sig_lut[i];
        th[k] = p.tanh_lut[i];
      }
    }
    if (tid < L::H) {
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
        sm[L::oWB + ((i - nA) / L::RW) * L::sB + (i - nA) % L::RW] = w[k];
      else if (i < nA + nB + nU)
        sm[L::oUA + ((i - nA - nB) / L::kColsU) * L::sU +
           (i - nA - nB) % L::kColsU] = w[k];
      else if (i < nW)
        sm[L::oUB + ((i - nA - nB - nU) / L::RU) * L::sV +
           (i - nA - nB - nU) % L::RU] = w[k];
    }
#pragma unroll
    for (int k = 0; k < kPerL; ++k) {
      const int i = tid + k * kTile;
      if (i < kLut) {
        sm[L::oSig + i] = sg[k];
        sm[L::oTnh + i] = th[k];
      }
    }
    if (tid < L::H) {
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

// The activation storage policy of a cell that stores nothing.
struct NoStorage {
  __device__ __forceinline__ float pre(float v) const { return v; }
  __device__ __forceinline__ float z(float v) const { return v; }
  __device__ __forceinline__ float ht(float v) const { return v; }
  __device__ __forceinline__ float h(float v) const { return v; }
};

// The step for one row held in registers (x, h in; hn out), from the
// weights, biases and LUTs in shared memory (Layout L).  `st` rounds each
// stored activation (NoStorage: none).
template <class L, class St>
__device__ __forceinline__ void cell(const float* sm, const St& st,
                                     float zeta, float nu,
                                     const float (&x)[L::D],
                                     const float (&h)[L::H],
                                     float (&hn)[L::H]) {
  constexpr int kH = L::H, kD = L::D, kRW = L::RW, kRU = L::RU;
  const float* sig = sm + L::oSig;
  const float* tnh = sm + L::oTnh;
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
    const float pre = st.pre(__fadd_rn(wx, uh));
    const float z = st.z(lut_bucket(sig, __fadd_rn(pre, sm[L::oBz + i])));
    const float ht = st.ht(lut_bucket(tnh, __fadd_rn(pre, sm[L::oBh + i])));
    hn[i] = st.h(fastgrnn_cell::gate(z, ht, h[i], zeta, nu));
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

// The persistent loop of a fixed-width kernel over its tiles, from the
// block's constants (fetched, not yet stored) on.  P: the kernel's
// parameters (h, x, mask, out, S); `row(x, h, hn)` computes one row's new
// h.  The grid has no more blocks than tiles.  Only the last tile can be
// ragged; a part with no row in it is not copied and not waited for.
template <class L, class P, class Cst, class Row>
__device__ __forceinline__ void tile_loop(const P& p, float* sm,
                                          const Cst& cst, Row row) {
  constexpr int kH = L::H, kD = L::D;
  constexpr int kRows = kTile / L::Parts;            // rows a part
  static_assert(kH == 16, "a tile row is four 16-byte chunks");
  static_assert(L::Parts == 1 || kRows == 32, "a part is the block or a warp");
  constexpr bool kWhole = L::Parts == 1;             // one part: the tile
  const int tid = threadIdx.x;
  // this thread's part, its row in the part, and whether it moves the part
  const int part = kWhole ? 0 : threadIdx.x / kRows;
  const int prow = kWhole ? tid : threadIdx.x % kRows;
  const bool first = prow == 0;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::oBar) + 2 * part;
  float* tiles = sm + L::oTile + part * kRows * kH;   // this part's rows
  const int ntiles = (p.S + kTile - 1) / kTile;
  const int stride = gridDim.x;

  auto copy_in = [&](int tile, int buf) {
    const int r0 = tile * kTile + part * kRows;
    if (kWhole || r0 < p.S)
      bulk_load(tiles + buf * L::kTileFloats,
                p.h + static_cast<size_t>(r0) * kH,
                static_cast<uint32_t>(min(kRows, p.S - r0) * kH *
                                      sizeof(float)), &bar[buf]);
  };
  float xn[kD];
  bool actn = false;
  auto fetch_x = [&](int tile) {
    const int r = tile * kTile + tid;
#pragma unroll
    for (int j = 0; j < kD; ++j) xn[j] = 0.0f;
    actn = false;
    if (r < p.S) {
      actn = p.mask[r] != 0;
#pragma unroll
      for (int j = 0; j < kD; ++j)
        xn[j] = p.x[static_cast<size_t>(r) * kD + j];
    }
  };
  // the first tile's x and its copy behind the constants' loads
  fetch_x(blockIdx.x);
  if (first) {
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
    const int r0 = tile * kTile + part * kRows;
    float x[kD];
#pragma unroll
    for (int j = 0; j < kD; ++j) x[j] = xn[j];
    const bool act = actn;
    const bool more = tile + stride < ntiles;
    if (more) fetch_x(tile + stride);
    if (first && more) {
      // the other buffer's last store has read it: refill it
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      copy_in(tile + stride, buf ^ 1);
    }
    if (!kWhole && r0 >= p.S) continue;   // the part's threads alike
    float* t = tiles + buf * L::kTileFloats;
    mbar_wait(&bar[buf], (it >> 1) & 1);
    float h[kH], hn[kH];
    tile_row_load(t + prow * kH, rot, h);
    row(x, h, hn);
#pragma unroll
    for (int i = 0; i < kH; ++i) hn[i] = act ? hn[i] : h[i];
    tile_row_store(t + prow * kH, rot, hn);
    // the part's writes to its rows, then one bulk copy out
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if constexpr (kWhole)
      __syncthreads();
    else
      __syncwarp();
    if (first)
      bulk_store(p.out + static_cast<size_t>(r0) * kH, t,
                 static_cast<uint32_t>(min(kRows, p.S - r0) * kH *
                                       sizeof(float)));
  }
  if (first) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// What a launch at one shape runs: the kernel, its grid and shared memory.
struct Plan {
  const void* fn;
  int fixed, blocks, threads, tile, per_sm;
  size_t smem;
};

// The SMs of the current device and the resident blocks an SM of each
// fixed-width kernel of a source (`which` < kKinds), asked once per device;
// `which` < 0 asks without the cache.
constexpr int kMaxDevices = 64;
constexpr int kKinds = 2;
int g_sms[kMaxDevices];
int g_per_sm[kMaxDevices][kKinds];

cudaError_t occupancy(const Plan& pl, int which, int* per_sm,
                             int* sms) {
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

// The persistent grid of a fixed-width plan (fn, smem, threads set) for S
// rows: at most one block per resident slot, every block the same number
// of tiles (a block with one more would set the time).
cudaError_t persistent_grid(int S, int which, Plan* pl) {
  int sms = 0;
  const cudaError_t err = occupancy(*pl, which, &pl->per_sm, &sms);
  if (err != cudaSuccess) return err;
  const int ntiles = (S + kTile - 1) / kTile;
  const int slots = pl->per_sm * sms;
  const int per_block = (ntiles + slots - 1) / slots;
  pl->blocks = (ntiles + per_block - 1) / per_block;
  return cudaSuccess;
}

// A plan as the plan queries report it, into plan[0..7]: the fixed-width
// code (1) or not (0), blocks, threads a block, rows a tile, dynamic shared
// memory in bytes, resident blocks an SM, and the chosen kernel's local
// memory (bytes a thread) and registers a thread.
cudaError_t report(const Plan& pl, int* plan) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, pl.fn);
  if (err != cudaSuccess) return err;
  const int v[8] = {pl.fixed, pl.blocks, pl.threads, pl.tile,
                    static_cast<int>(pl.smem), pl.per_sm,
                    static_cast<int>(attr.localSizeBytes), attr.numRegs};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return cudaSuccess;
}

cudaError_t launch(const Plan& pl, void* params, cudaStream_t stream) {
  void* args[] = {params};
  const cudaError_t err = cudaLaunchKernel(
      pl.fn, dim3(pl.blocks), dim3(pl.threads), args, pl.smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace step_tiles
