// The quantized LM head (paper Appendix B at LM scale): a matmul with
// fused Q15/Q7 weight dequantization, on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/q15_matmul/kernel.py::_mm_kernel  (q15_matmul_padded)
// which padded x and the weights to (128, 128, 128) blocks, cast each block
// to bfloat16 in VMEM, accumulated the MXU's products in float32 across
// the K blocks and applied the per-tensor scale once at the end.  The
// blocking was the TPU's layout, not part of the function.  This kernel
// computes the same function,
//
//   out[m, n] = scale * sum_k bf16(x[m, k]) * bf16(w[k, n]),
//
// x float32 (M, K), w int16 or int8 (K, N), both row-major; float32 sums
// from +0.0; one __fmul_rn by the scale; the output float32, or bfloat16
// rounded to nearest even from the float32 result.  Nothing is padded: the
// kernel masks its own tails.
//
// What binds it.  The engine calls it with M <= 8 rows (a decode tick's
// slots, or one row at a prefill) against the whole integer head, so each
// weight is read once and used M times: 8 multiply-adds per weight, far
// below the ~295 operations per byte at which the bf16 tensor cores would
// bind.  HBM bytes bind it: at Qwen2-1.5B's 8 x 1536 x 151,936 head,
// 467 MB of int16 (141 us at 3.35 TB/s) or 233 MB of int8 (71 us).  Under
// the bytes lies the instruction stream: an I2F and a bfloat16 round trip
// per weight, then a multiply and an add into each of the M rows on the
// CUDA cores (the port builds without FMA), is about 20 instructions a
// weight, enough to bind int16 and int8 alike.  Here the products go to
// the tensor cores and a weight costs about three instructions:
//
// - mma.sync m16n8k16, bf16 in, float32 sums, with the operands swapped:
//   A = w^T (16 output columns x 16 values of k) and B = x^T (16 values of
//   k x the 8 rows of x), so the MMA's n = 8 is the engine's slot count.
//   Rows of x past M are zeros and cost no bytes; M > 8 takes one grid row
//   per 8 rows of x.
// - Fragments straight from coalesced loads, with no shared-memory
//   transpose.  A sum over k does not depend on which k sits in which
//   fragment slot as long as A and B agree, so lane (g = lane / 4,
//   t = lane % 4) puts the k-slots {2t, 2t+1, 2t+8, 2t+9} of each step of
//   16 on the physical k0 + 4t + {0, 1, 2, 3}.  For each of those four rows
//   of w it loads the C adjacent columns n0 + C g ... n0 + C g + C - 1 with
//   one 16-byte load (C = 8 int16 or 16 int8 values; 8 int8 values, 8
//   bytes, where N % 16 != 0); at a fixed k the eight lanes with the same t
//   read 8 C contiguous columns.  MMA i (of C / 2) puts column n0 + C g +
//   2i on m-slot g and column n0 + C g + 2i + 1 on m-slot g + 8.  The B
//   fragment is x[g][k0 + 4t ... k0 + 4t + 3], one 16-byte load from L1 (x
//   is a few KB) rounded to bfloat16 in registers; it serves all C / 2
//   MMAs of the step, and the accumulators land as C contiguous columns of
//   rows 2t and 2t + 1: vector stores.
// - Conversion without I2F: an int16 value v, biased to v + 2^15 and put
//   under the exponent of 2^23 with one byte permute, is the float
//   2^23 + 2^15 + v, and one subtraction leaves v exactly; one
//   cvt.rn.bf16x2.f32 then rounds a pair to bfloat16, to nearest even as
//   torch's int16 -> bfloat16 cast does.  int8 the same way, exact, and
//   packed by a byte permute of the floats' upper halves.
// - Bytes in flight: a block is 4 warps on one tile of columns, each warp
//   a quarter of K (split-K inside the block), each keeping a ring of
//   kDepth steps of weight and x loads in registers ahead of its MMAs
//   (2 for int16, 3 for int8, whose registers leave room for it); the
//   weights bypass L1.  Nothing is staged in shared memory, so a block
//   streams from its first instruction.  A warp takes one tile of 8 C
//   columns, or two side by side (256 contiguous bytes of an int16 row)
//   where that takes fewer waves of blocks over the card: the last, partly
//   filled wave is where the bandwidth goes unused (plan()).  Even
//   zamba2's 2048 x 32,000 head gives 2,000 warps.  The four partial sums
//   are added in shared memory in a fixed order, ((w0 + w1) + w2) + w3,
//   with no atomics: the result is the same from run to run, and the
//   bfloat16 output is the float32 output rounded.
// - Tails: a ragged K is zero-filled in x and masked in w; lanes past N
//   store nothing.  A weight pointer or an N that does not allow the
//   vector load takes the same MMA kernel with masked scalar loads.
//
// Numerics.  A product of two bfloat16 values is exact in float32.  The
// tensor core adds the products and the running sum in its own order and
// need not round each partial sum to nearest, so against the plain version
// (kernels/q15_matmul/kernel.py::plain, a float32 product of the same
// bfloat16 values) only the order and the rounding of the float32
// additions differ, as they did for the first K5: about one ulp of a
// running sum per step of 16, and the four partial sums keep the running
// sums small.  The gate stays 1e-5 x max|plain|.
//
// Plain C interface (loaded with ctypes); launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;           // warps of a block, each a quarter of K
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;            // rows of x per block: the MMA's n
constexpr int kDepth16 = 2;         // steps of loads in flight per warp, int16
constexpr int kDepth8 = 3;          // and int8

// How a lane reads its C columns of one row of w.
enum Load { kVec16, kVec8, kScalar };

// Round a pair to bfloat16, to nearest even; lo (the lower k or column)
// in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The weights are read once: the read-only path, not kept in L1.
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld_stream8(const void* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

// D += A B on the tensor cores: A 16 x 16 and B 16 x 8 bfloat16, D float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The values of a weight word as exact floats: each value biased to
// unsigned (XOR kBias), put under the exponent of 2^23 (one byte permute)
// and the bias subtracted again.
template <typename W> struct Weights;
template <> struct Weights<int16_t> {
  static constexpr uint32_t kBias = 0x80008000u;   // v -> v + 2^15
  static constexpr int kPerWord = 2;
  __device__ static float value(uint32_t biased, int e) {
    const uint32_t bits = __byte_perm(biased, 0x4B000000u, e ? 0x7632 : 0x7610);
    return __fsub_rn(__uint_as_float(bits), 8421376.0f);   // 2^23 + 2^15
  }
  // a pair of values as bfloat16, rounded to nearest even
  __device__ static uint32_t pack(float lo, float hi) {
    return pack_bf16x2(lo, hi);
  }
};
template <> struct Weights<int8_t> {
  static constexpr uint32_t kBias = 0x80808080u;   // v -> v + 2^7
  static constexpr int kPerWord = 4;
  __device__ static float value(uint32_t biased, int e) {
    const uint32_t bits = __byte_perm(biased, 0x4B000000u, 0x7650 + e);
    return __fsub_rn(__uint_as_float(bits), 8388736.0f);   // 2^23 + 2^7
  }
  // a pair as bfloat16: exact, so the upper halves of the two floats,
  // taken with one byte permute
  __device__ static uint32_t pack(float lo, float hi) {
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  }
};

template <typename W, int C>
constexpr int kWords = C * static_cast<int>(sizeof(W)) / 4;  // per row

// The lane's C columns at rows k .. k + 3 of w, as raw words; rows past K
// and columns past N read as zero.
template <typename W, int C, Load L>
__device__ __forceinline__ void load_rows(uint32_t (&r)[4][kWords<W, C>],
                                          const W* w, int k, int col, int K,
                                          int N) {
  static_assert(L != kVec16 || C * sizeof(W) == 16, "one 16-byte load");
  static_assert(L != kVec8 || C * sizeof(W) == 8, "one 8-byte load");
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const W* p = w + static_cast<size_t>(k + j) * N + col;
    const bool row_in = k + j < K;
    if constexpr (L == kVec16) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row_in && col < N) v = ld_stream16(p);   // all C columns or none
      r[j][0] = v.x, r[j][1] = v.y, r[j][2] = v.z, r[j][3] = v.w;
    } else if constexpr (L == kVec8) {
      uint2 v = make_uint2(0u, 0u);
      if (row_in && col < N) v = ld_stream8(p);
      r[j][0] = v.x, r[j][1] = v.y;
    } else {
      using U = std::make_unsigned_t<W>;
      constexpr int kPer = Weights<W>::kPerWord;
#pragma unroll
      for (int q = 0; q < kWords<W, C>; ++q) {
        uint32_t word = 0u;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int c = q * kPer + e;
          if (row_in && col + c < N)
            word |= static_cast<uint32_t>(static_cast<U>(__ldg(p + c)))
                    << (8 * sizeof(W) * e);
        }
        r[j][q] = word;
      }
    }
  }
}

// The A fragment of MMA i of a step: the lane's columns 2i (m-slot g) and
// 2i + 1 (m-slot g + 8); registers 0 and 1 hold rows k, k + 1 (k-slots
// 2t, 2t + 1), registers 2 and 3 rows k + 2, k + 3 (k-slots 2t + 8, 2t + 9).
template <typename W, int C>
__device__ __forceinline__ void fragment(const uint32_t (&r)[4][kWords<W, C>],
                                         int i, uint32_t (&a)[4]) {
  using V = Weights<W>;
  const int q = 2 * i / V::kPerWord, e = 2 * i % V::kPerWord;
  uint32_t u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) u[j] = r[j][q] ^ V::kBias;
  a[0] = V::pack(V::value(u[0], e), V::value(u[1], e));
  a[1] = V::pack(V::value(u[0], e + 1), V::value(u[1], e + 1));
  a[2] = V::pack(V::value(u[2], e), V::value(u[3], e));
  a[3] = V::pack(V::value(u[2], e + 1), V::value(u[3], e + 1));
}

// C values of one output row from column `col` on: vector stores, or
// scalar stores masked at N.
template <Load L, int C>
__device__ __forceinline__ void store_row(float* o, const float (&v)[C],
                                          int left) {
  if constexpr (L != kScalar) {
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<float4*>(o + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < left) o[c] = v[c];
  }
}
template <Load L, int C>
__device__ __forceinline__ void store_row(__nv_bfloat16* o, const float (&v)[C],
                                          int left) {
  if constexpr (L != kScalar) {
#pragma unroll
    for (int c = 0; c < C; c += 8)
      *reinterpret_cast<uint4*>(o + c) = make_uint4(
          pack_bf16x2(v[c], v[c + 1]), pack_bf16x2(v[c + 2], v[c + 3]),
          pack_bf16x2(v[c + 4], v[c + 5]), pack_bf16x2(v[c + 6], v[c + 7]));
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < left) o[c] = __float2bfloat16_rn(v[c]);
  }
}

// The lane's B fragment source at rows k .. k + 3 of x: x[row][k .. k + 3],
// zero past M and K (one 16-byte load where K % 4 == 0 and x is aligned).
__device__ __forceinline__ float4 load_x(const float* x, int row, int k,
                                         int M, int K, bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row < M) {
    const float* p = x + static_cast<size_t>(row) * K + k;
    if (vec) {
      if (k < K) v = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      if (k < K) v.x = __ldg(p);
      if (k + 1 < K) v.y = __ldg(p + 1);
      if (k + 2 < K) v.z = __ldg(p + 2);
      if (k + 3 < K) v.w = __ldg(p + 3);
    }
  }
  return v;
}

template <typename W, int C, int T, Load L, typename O>
__global__ void __launch_bounds__(kThreads)
q15_matmul_kernel(const float* __restrict__ x, const W* __restrict__ w,
                  const float* __restrict__ scale, O* __restrict__ out,
                  int M, int K, int N) {
  constexpr int kMma = C / 2;
  constexpr int kDepth = sizeof(W) == 2 ? kDepth16 : kDepth8;
  extern __shared__ float part[];      // the partial sums of warps 1 .. 3
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t = lane % 4;
  // the lane's first column in tile 0; tile u is 8 C columns further on
  const int col = blockIdx.x * T * 8 * C + lane / 4 * C;
  const int row0 = blockIdx.y * kRows, xrow = row0 + lane / 4;
  const int steps = (K + 15) / 16;
  const int s0 = warp * steps / kWarps, s1 = (warp + 1) * steps / kWarps;
  const bool x_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  float acc[T][kMma][4];
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int i = 0; i < kMma; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[u][i][q] = 0.0f;

  // a ring of kDepth steps in registers: the weights and x of step s + d
  uint32_t buf[kDepth][T][4][kWords<W, C>];
  float4 xb[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    if (s0 + d < s1) {
      const int k = 16 * (s0 + d) + 4 * t;
#pragma unroll
      for (int u = 0; u < T; ++u)
        load_rows<W, C, L>(buf[d][u], w, k, col + u * 8 * C, K, N);
      xb[d] = load_x(x, xrow, k, M, K, x_vec);
    }
  for (int s = s0; s < s1; s += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (s + d < s1) {
        const uint2 b = make_uint2(pack_bf16x2(xb[d].x, xb[d].y),
                                   pack_bf16x2(xb[d].z, xb[d].w));
        const int k = 16 * (s + d + kDepth) + 4 * t;
        const bool more = s + d + kDepth < s1;
        if (more) xb[d] = load_x(x, xrow, k, M, K, x_vec);
#pragma unroll
        for (int u = 0; u < T; ++u) {
          uint32_t a[kMma][4];   // converted first: buf[d] refills early
#pragma unroll
          for (int i = 0; i < kMma; ++i) fragment<W, C>(buf[d][u], i, a[i]);
          if (more) load_rows<W, C, L>(buf[d][u], w, k, col + u * 8 * C, K, N);
#pragma unroll
          for (int i = 0; i < kMma; ++i) mma_bf16(acc[u][i], a[i], b);
        }
      }
    }
  }

  // ((w0 + w1) + w2) + w3 in a fixed order; warp 0 adds and stores
  constexpr int kAcc = T * kMma * 4;   // a lane's accumulators
  float* const flat = &acc[0][0][0];
  if (warp > 0)
#pragma unroll
    for (int e = 0; e < kAcc; ++e)
      part[((warp - 1) * kAcc + e) * 32 + lane] = flat[e];
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int p = 0; p < kWarps - 1; ++p)
#pragma unroll
    for (int e = 0; e < kAcc; ++e)
      flat[e] = __fadd_rn(flat[e], part[(p * kAcc + e) * 32 + lane]);
  const float sc = __ldg(scale);
  // D's registers: 0 (m-slot g, row 2t), 1 (g, 2t + 1), 2 (g + 8, 2t),
  // 3 (g + 8, 2t + 1); so row 2t + h holds acc[i][h] at column 2i and
  // acc[i][2 + h] at column 2i + 1
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 2 * t + h, cu = col + u * 8 * C;
      if (r >= M || cu >= N) continue;
      float v[C];
#pragma unroll
      for (int i = 0; i < kMma; ++i) {
        v[2 * i] = __fmul_rn(acc[u][i][h], sc);
        v[2 * i + 1] = __fmul_rn(acc[u][i][2 + h], sc);
      }
      store_row<L, C>(out + static_cast<size_t>(r) * N + cu, v, N - cu);
    }
}

// Shared memory of a block: the partial sums of warps 1 .. kWarps - 1.
template <int C, int T>
constexpr size_t kPartBytes = static_cast<size_t>(kWarps - 1) * T * 2 * C *
                              32 * sizeof(float);

template <typename W, int C, int T, Load L, typename O>
cudaError_t launch(const float* x, const void* w, const float* scale,
                   void* out, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + T * 8 * C - 1) / (T * 8 * C), (M + kRows - 1) / kRows);
  q15_matmul_kernel<W, C, T, L, O><<<grid, kThreads, kPartBytes<C, T>, stream>>>(
      x, static_cast<const W*>(w), scale, static_cast<O*>(out), M, K, N);
  return cudaGetLastError();
}

// How many times the card must fill up with blocks of this instantiation
// to run `blocks` of them (its occupancy is asked once per device).
template <typename W, int C, int T, Load L, typename O>
int waves(int blocks) {
  static int resident[64] = {};          // blocks the card holds at once
  int dev = 0;
  cudaGetDevice(&dev);
  int& r = resident[dev % 64];
  if (r == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, q15_matmul_kernel<W, C, T, L, O>, kThreads,
            kPartBytes<C, T>) != cudaSuccess)
      cudaGetLastError();                // a failed query is no launch error
    r = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return (blocks + r - 1) / r;
}

// How a launch reads the weights (Load) and how many column tiles a warp
// takes (1 or 2).
struct Plan {
  Load load;
  int tiles;
};

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The widest load that N and the pointers allow: 16 bytes a row, else 8
// (int8), else masked scalar loads; vector stores need 16-byte output rows,
// which N % 8 == 0 and an aligned output give.  Then two column tiles per
// warp where that takes fewer waves of blocks over the card: the last,
// partly filled wave is where the card's memory bandwidth goes unused.
// The plan does not depend on the output's type (the float32
// instantiations' occupancy decides), so a bfloat16 output is the float32
// output of the same kernel, rounded.
template <typename W>
Plan plan(const void* w, const void* out, int M, int N) {
  const int rows = (M + kRows - 1) / kRows;
  auto tiles = [&](auto one, auto two, int C) {
    const int b1 = (N + 8 * C - 1) / (8 * C) * rows;
    const int b2 = (N + 16 * C - 1) / (16 * C) * rows;
    return two(b2) < one(b1) ? 2 : 1;
  };
  constexpr int C16 = 16 / static_cast<int>(sizeof(W));
  if (N % C16 == 0 && N % 8 == 0 && aligned(w, 16) && aligned(out, 16))
    return {kVec16, tiles(waves<W, C16, 1, kVec16, float>,
                          waves<W, C16, 2, kVec16, float>, C16)};
  if (sizeof(W) == 1 && N % 8 == 0 && aligned(w, 8) && aligned(out, 16))
    return {kVec8, tiles(waves<int8_t, 8, 1, kVec8, float>,
                         waves<int8_t, 8, 2, kVec8, float>, 8)};
  return {kScalar, 1};
}

template <typename W, typename O>
cudaError_t launch_planned(const float* x, const void* w, const float* scale,
                           void* out, int M, int K, int N, cudaStream_t s) {
  constexpr int C16 = 16 / static_cast<int>(sizeof(W));
  const Plan p = plan<W>(w, out, M, N);
  if (p.load == kVec16)
    return p.tiles == 2
               ? launch<W, C16, 2, kVec16, O>(x, w, scale, out, M, K, N, s)
               : launch<W, C16, 1, kVec16, O>(x, w, scale, out, M, K, N, s);
  if constexpr (sizeof(W) == 1)
    if (p.load == kVec8)
      return p.tiles == 2
                 ? launch<W, 8, 2, kVec8, O>(x, w, scale, out, M, K, N, s)
                 : launch<W, 8, 1, kVec8, O>(x, w, scale, out, M, K, N, s);
  return launch<W, 8, 1, kScalar, O>(x, w, scale, out, M, K, N, s);
}

bool valid(int w_bits, int out_dtype, int M, int K, int N) {
  return M >= 0 && K >= 0 && N >= 0 && (w_bits == 8 || w_bits == 16) &&
         (out_dtype == 0 || out_dtype == 1) && (M + 7) / 8 <= 65535;
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
  if (!valid(w_bits, out_dtype, M, K, N))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w_bits == 16)
    err = out_dtype == 0
              ? launch_planned<int16_t, float>(x, w, scale, out, M, K, N, s)
              : launch_planned<int16_t, __nv_bfloat16>(x, w, scale, out, M,
                                                       K, N, s);
  else
    err = out_dtype == 0
              ? launch_planned<int8_t, float>(x, w, scale, out, M, K, N, s)
              : launch_planned<int8_t, __nv_bfloat16>(x, w, scale, out, M,
                                                      K, N, s);
  return static_cast<int>(err);
}

// The kernel q15_matmul_launch runs for these weights and output (w_bits
// 8 or 16, M >= 0, N >= 0; the same for either output type), as 4 * load +
// tiles (load: 0 16-byte, 1 8-byte, 2 scalar loads of w; tiles: 1 or 2
// column tiles per warp), or -1 for arguments it does not take.  Launches
// nothing.
int q15_matmul_plan(const void* w, int w_bits, const void* out, int M,
                    int N) {
  if (!valid(w_bits, 0, M, 0, N)) return -1;
  const Plan p = w_bits == 16 ? plan<int16_t>(w, out, M, N)
                              : plan<int8_t>(w, out, M, N);
  return 4 * static_cast<int>(p.load) + p.tiles;
}

const char* q15_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
