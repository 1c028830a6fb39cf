// Mamba-2 chunked SSD scan (state-space duality, arXiv:2405.21060) for
// sm_90a: the full-sequence scan of every mamba block of the LM engine's
// prefill.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/ssd_scan/kernel.py::_ssd_kernel  (ssd_scan_heads)
// which ran one program per (batch, head), staged the head's whole
// sequence in VMEM, walked the chunks with a fori_loop and carried the
// (N, P) state in a VMEM buffer.  This source computes the same function
// (kernels/ssd_scan/kernel.py::plain) per head and chunk of Q rows:
//
//   cs   = cumsum(dt * A)                              (float32)
//   M_ij = (C_i . B_j) * exp(cs_i - cs_j) * dt_j       for j <= i, else 0
//   y_i  = sum_j M_ij x_j  +  exp(cs_i) * (C_i . H)    (float32, one
//                                                       rounding to x's type)
//   H    = exp(cs_last) * H + sum_j (B_j * exp(cs_last - cs_j) * dt_j) x_j
//
// from H = 0, every product and sum in float32 (x, B, C read as float32 or
// bfloat16); it returns y in x's type and the final H in float32.
//
// Three phases.  Only the carried state is sequential over the chunks: the
// chunk-local terms do not depend on it.  One ssd_scan_launch call enqueues
// three kernels, in order, on the caller's stream:
//  P1 chunk state, one block per (head, chunk, 64 rows of N, 64 columns of
//     P): the chunk's cumsum into the float32 scratch cs (BH, S), and
//     s_c = sum_j (B_j * w_j) x_j with w_j = exp(cs_last - cs_j) * dt_j into
//     the float32 scratch hc (BH, n_chunks, N, P).
//  P2 state pass, one thread per (head, 4 elements of the N x P state): for
//     each chunk in order, hc[c] = H (the state chunk c starts from, in
//     place of s_c; chunk 0's, zero, is not stored) and
//     H = exp(cs_last_c) * H + s_c; the last H is the state output.
//  P3 chunk output, one block per (head, chunk, 64-row tile of the chunk,
//     64 columns of P), the tiles with the most rows j first: y_i from the
//     chunk's tiles j <= i and from hc[c].
// At b = 1, S = 1000, 48 heads of P = 64, N = 128 (mamba2-780m's prefill)
// that is 384 blocks in P1 and 768 in P3 on 132 SMs; a one-chunk prompt
// (S <= 256) still gives P3 four row tiles a head.
//
// What bounds it.  Operations: about 0.4 G multiply-adds each for M x, C H
// and the state sums, and 2 G FLOP of C B^T, against 15 MB of inputs and
// outputs.  PERF.md's bound is the least work at any chunk length: in
// bfloat16 every product on the tensor cores (M x, C H and the state sums
// as three bfloat16 parts, as below), about 4.8 us, just above the bytes'
// 4.3 us; in float32 one FMA per multiply-add, about 25 us.
// What the design does about it:
//  * bfloat16 inputs (the engine's): every product goes to the tensor
//    cores, mma.sync m16n8k16, bf16 in, float32 sums.  C B^T takes C and B
//    as they are: a product of two bfloat16 values is exact in float32.
//    M, H and B * w are float32, so each enters as three bfloat16 parts
//    (split3: a = a0 + a1 + a2 to within 2^-27 |a|), each part times the
//    exact bfloat16 operand, so M x, C H and the state sums lose nothing
//    to the operands either; only the order and rounding of the float32
//    sums differ from the plain version, as they already did.  A warp
//    keeps its 16 rows of C as A fragments for the whole block, turns its
//    tile of C B^T into M in registers (two column blocks of the MMA's
//    output are one A fragment of the next MMA), and takes x's fragments
//    with ldmatrix.trans.  N pads with zeros to the MMA's depth of 16 and
//    rows past the chunk load as zeros: zero products are exact.
//  * float32 inputs: SIMT, one __fmaf_rn per multiply-add (the port builds
//    with --fmad=false, so nothing is contracted implicitly); TF32 would
//    keep 10 bits against a 1e-4 gate.  Each thread keeps a 4 x 4 tile of
//    outputs fed by 16-byte shared-memory loads.
//  * Loads: 16 bytes a thread where the layout allows, each chunk's B and
//    x once per phase; P1 loads the next tile into registers while the
//    MMAs run (the first across the cumsum), P3 copies the next tile with
//    cp.async into a second buffer.  Nothing of x, B or C is copied
//    through device memory: only cs (4 B a row) and the chunk states go
//    through the scratch.
//  * About 40 KB of shared memory per P1 block and 99 KB per P3 block in
//    bfloat16 (35 KB and 101 KB in float32), so two or more blocks share
//    an SM.
//
// What is kept from the plain version:
//  * The cumsum's order.  Each chunk's cs is added left to right in float32
//    by one lane (run = run + dt * a, products formed in parallel, no FMA),
//    the plain version's chunk_cumsum.  At |cs| of a few hundred one
//    float32 ulp of cs is a few 1e-5 of every decay, so K6 matches plain
//    elementwise only because the two share cs bit for bit.  P1 writes it
//    once and P2 and P3 read it.
//  * The ragged last chunk is masked: rows past the sequence load as zeros,
//    their M entries are zero and cs_last is the last real row's.
//  * The decay is clamped before the exp: M_ij is 0 for j > i, never exp
//    of a positive argument; on the diagonal tile the blocks of 16 columns
//    past a warp's rows are skipped, not computed.
//
// Plain C interface (loaded with ctypes); launches on the given stream,
// allocates nothing (the caller passes the scratch) and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;        // 8 warps; a 16 x 16 grid of threads
constexpr int kSide = 16;
constexpr int kT = 64;               // rows of a tile (i or j), columns of P
constexpr int kLdT = kT + 4;         // a float row of 64, padded
constexpr int kLdW = kT + 8;         // a row of 64 packed pairs, padded
constexpr int kMaxN = 128;           // state rows
constexpr int kMaxK = kMaxN / 16;    // MMA steps over N
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr int kP2Batch = 8;          // chunks whose loads P2 issues at once

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ __forceinline__ int n_pad(int N) { return round_up(N, 16); }
__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The bfloat16 halves of a 32-bit word as exact floats.
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Round a pair to bfloat16, to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// Two floats as three pairs of bfloat16 parts, a = a0 + a1 + a2 to within
// 2^-27 |a| (each residual is exact in float32 and shrinks by 2^-9), so a
// product of each part with a bfloat16 value is exact in float32.
__device__ __forceinline__ void split3(float a, float b, uint32_t (&w)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w[k] = pack_bf16x2(a, b);
    a = __fsub_rn(a, lo_f(w[k]));
    b = __fsub_rn(b, hi_f(w[k]));
  }
}

// D += A B on the tensor cores: A 16 x 16 and B 16 x 8 bfloat16, D float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight bfloat16 values (16 bytes) of a row from column c; zero bits past
// cols and for a row that is not there.  One 16-byte load where `vec`.
__device__ __forceinline__ uint4 load8(const uint16_t* row, int c, int cols,
                                       bool there, bool vec) {
  if (there && vec && c + 8 <= cols)
    return *reinterpret_cast<const uint4*>(row + c);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = there && c + 2 * k < cols ? row[c + 2 * k] : 0u;
    const uint32_t hi = there && c + 2 * k + 1 < cols ? row[c + 2 * k + 1] : 0u;
    w[k] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Four floats of a row from column c, zero past cols and for a row that
// is not there.  One 16-byte load where `vec`.
__device__ __forceinline__ float4 load4(const float* row, int c, int cols,
                                        bool there, bool vec) {
  if (there && vec && c + 4 <= cols)
    return *reinterpret_cast<const float4*>(row + c);
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = there && c + k < cols ? row[c + k] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc[r][c] += a[r] * b[c], one FMA each.
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4& a,
                                       const float4& b) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[r][c] = __fmaf_rn(comp(a, r), comp(b, c), acc[r][c]);
}

// dst[r * ld + c] = src[r * src_ld + c] for r < rows and c < cols, zero
// for the rest of the tile_rows x width tile (width a multiple of 4).
__device__ __forceinline__ void stage_f32(float* dst, int ld, int tile_rows,
                                          int width, const float* src,
                                          size_t src_ld, int rows, int cols,
                                          bool vec) {
  const int per_row = width / 4;
  for (int e = threadIdx.x; e < tile_rows * per_row; e += kThreads) {
    const int r = e / per_row, c = (e % per_row) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        load4(src + static_cast<size_t>(r) * src_ld, c, cols, r < rows, vec);
  }
}

// Rows 2 q and 2 q + 1 of a tile (a and b, 8 columns each) paired column
// by column into one word, row 2 q in the low half, row 2 q + 1 in the
// high: an MMA B fragment register, at dst .. dst + 7.
__device__ __forceinline__ void put_pairs(uint32_t* dst, const uint4& a,
                                          const uint4& b) {
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[2 * k] = __byte_perm(word(a, k), word(b, k), 0x5410);
    w[2 * k + 1] = __byte_perm(word(a, k), word(b, k), 0x7632);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(dst + 4) = make_uint4(w[4], w[5], w[6], w[7]);
}

// 16 bytes from global to shared memory, asynchronously; bytes past
// `bytes` are zero-filled (and none is read when it is 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Four 8 x 8 bfloat16 matrices from shared memory, transposed: with the
// rows of a [k][n] tile, the MMA B fragments of two column blocks of 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// The kT x width bfloat16 tile into shared rows of ld values, zero past
// rows and cols: with cp.async, 16 bytes a thread, where `vec` (the tile
// and its row starts 16-byte aligned), else through registers.  width a
// multiple of 8, ld of 8.
__device__ __forceinline__ void copy_tile(uint16_t* dst, int ld, int width,
                                          const uint16_t* src, size_t src_ld,
                                          int rows, int cols, bool vec) {
  const int per_row = width / 8;
  for (int e = threadIdx.x; e < kT * per_row; e += kThreads) {
    const int r = e / per_row, c = (e % per_row) * 8;
    uint16_t* d = dst + r * ld + c;
    const uint16_t* s = src + static_cast<size_t>(r) * src_ld;
    if (vec) {
      const int n = r < rows ? imin(8, cols - c) : 0;
      cp_async16(d, n > 0 ? s + c : src, n > 0 ? 2 * n : 0);
    } else {
      *reinterpret_cast<uint4*>(d) = load8(s, c, cols, r < rows, false);
    }
  }
}

// The chunk's dt, its cumsum cs and w_j = exp(cs_last - cs_j) * dt_j in
// shared memory (qn rows each); block 0 of the chunk writes cs to the
// scratch.  The products dt * a are formed in parallel, and one lane adds
// them left to right, eight read into registers at a time: the plain
// version's order (kernel.py::chunk_cumsum), so cs agrees bit for bit.
__device__ __forceinline__ void chunk_prologue(const float* dtb, float a,
                                               int qn, float* dt_s,
                                               float* cs_s, float* w_s,
                                               float* csb, bool writer) {
  for (int i = threadIdx.x; i < qn; i += kThreads) {
    const float d = dtb[i];
    dt_s[i] = d;
    cs_s[i] = __fmul_rn(d, a);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.0f;
    for (int i0 = 0; i0 < qn; i0 += 8) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = i0 + k < qn ? cs_s[i0 + k] : 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        run = __fadd_rn(run, v[k]);
        if (i0 + k < qn) cs_s[i0 + k] = run;
      }
    }
  }
  __syncthreads();
  const float cs_last = cs_s[qn - 1];
  for (int i = threadIdx.x; i < qn; i += kThreads) {
    if (writer) csb[i] = cs_s[i];
    w_s[i] = __fmul_rn(expf(__fsub_rn(cs_last, cs_s[i])), dt_s[i]);
  }
}

// ---------------------------------------------------------------------------
// P1: chunk state, s_c[n][p] = sum_j (B_j[n] * w_j) x_j[p].  Block (bh,
// chunk, N tile x P tile), a kT x kT tile of s_c.
// ---------------------------------------------------------------------------

// float32: SIMT FMAs; thread (ty, tx) owns rows n0 + 4 ty .. + 3 and
// columns p0 + 4 tx .. + 3.  Shared: dt, cs, w (qr floats each), the
// tiles B * w and x (kT x kT floats each).
__global__ void __launch_bounds__(kThreads)
ssd_scan_p1_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ B, float* __restrict__ cs,
                       float* __restrict__ hc, int S, int P, int N, int Q,
                       int nc, int ntiles_n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int qr = round_up(imin(Q, S), 4);
  float* dt_s = smem;
  float* cs_s = dt_s + qr;
  float* w_s = cs_s + qr;
  float* bw_s = w_s + qr;
  float* x_s = bw_s + kT * kT;

  const int bh = blockIdx.x, c = blockIdx.y;
  const int n0 = (blockIdx.z % ntiles_n) * kT;
  const int p0 = (blockIdx.z / ntiles_n) * kT;
  const int c0 = c * Q, qn = imin(Q, S - c0);
  const int ncols = imin(kT, N - n0), pcols = imin(kT, P - p0);
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const size_t row0 = static_cast<size_t>(bh) * S + c0;
  chunk_prologue(dt + row0, A[bh], qn, dt_s, cs_s, w_s, cs + row0,
                 blockIdx.z == 0);

  const bool vec_b = aligned16(B) && N % 4 == 0;
  const bool vec_x = aligned16(x) && P % 4 == 0;
  float acc[4][4] = {};
  for (int j0 = 0; j0 < qn; j0 += kT) {
    const int jrows = imin(kT, qn - j0);
    __syncthreads();                   // w_s is written; the tiles are free
    for (int e = threadIdx.x; e < kT * (kT / 4); e += kThreads) {
      const int r = e / (kT / 4), cc = (e % (kT / 4)) * 4;
      float4 v = load4(B + (row0 + j0 + r) * N + n0, cc, ncols, r < jrows,
                       vec_b);
      if (r < jrows) {
        const float w = w_s[j0 + r];
        v = make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w),
                        __fmul_rn(v.z, w), __fmul_rn(v.w, w));
      }
      *reinterpret_cast<float4*>(bw_s + r * kT + cc) = v;
    }
    stage_f32(x_s, kT, kT, kT, x + (row0 + j0) * P + p0, P, jrows, pcols,
              vec_x);
    __syncthreads();
    for (int jj = 0; jj < jrows; ++jj)
      outer4(acc, ld4(bw_s + jj * kT + 4 * ty), ld4(x_s + jj * kT + 4 * tx));
  }
  float* out = hc + (static_cast<size_t>(bh) * nc + c) * N * P + p0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = 4 * ty + r;
    if (n >= ncols) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * tx + q < pcols)
        out[static_cast<size_t>(n0 + n) * P + 4 * tx + q] = acc[r][q];
  }
}

// bfloat16: on the tensor cores.  B * w is float32, so it enters as three
// bfloat16 parts (split3), each times the exact bfloat16 x.  Warp w
// computes rows n0 + 16 (w % 4) .. + 15 and columns p0 + 32 (w / 4) ..
// + 31.  Shared: dt, cs, w (qr floats each), the three parts of (B * w)^T
// paired along j (3 x kT / 2 x kLdW words) and x paired along j (kT / 2 x
// kLdW words).
__global__ void __launch_bounds__(kThreads)
ssd_scan_p1_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const __nv_bfloat16* __restrict__ B,
                        float* __restrict__ cs, float* __restrict__ hc, int S,
                        int P, int N, int Q, int nc, int ntiles_n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int qr = round_up(imin(Q, S), 4);
  float* dt_s = smem;
  float* cs_s = dt_s + qr;
  float* w_s = cs_s + qr;
  uint32_t* bw2 = reinterpret_cast<uint32_t*>(w_s + qr);
  constexpr int kPart = (kT / 2) * kLdW;
  uint32_t* x2 = bw2 + 3 * kPart;

  const int bh = blockIdx.x, c = blockIdx.y;
  const int n0 = (blockIdx.z % ntiles_n) * kT;
  const int p0 = (blockIdx.z / ntiles_n) * kT;
  const int c0 = c * Q, qn = imin(Q, S - c0);
  const int ncols = imin(kT, N - n0), pcols = imin(kT, P - p0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wi = warp % 4, wj = warp / 4;
  const size_t row0 = static_cast<size_t>(bh) * S + c0;
  const uint16_t* Bu = reinterpret_cast<const uint16_t*>(B);
  const uint16_t* xu = reinterpret_cast<const uint16_t*>(x);
  const bool vec_b = aligned16(B) && N % 8 == 0;
  const bool vec_x = aligned16(x) && P % 8 == 0;
  // one item a thread: rows 2 q and 2 q + 1 of a tile, 8 columns of B and
  // of x, loaded into registers one tile ahead
  static_assert((kT / 2) * (kT / 8) == kThreads, "one item a thread");
  const int q = threadIdx.x / (kT / 8), cc = (threadIdx.x % (kT / 8)) * 8;
  uint4 ba, bb, xa, xb;
  auto fetch = [&](int j0) {
    const int jrows = imin(kT, qn - j0);
    const uint16_t* br = Bu + (row0 + j0 + 2 * q) * N + n0;
    const uint16_t* xr = xu + (row0 + j0 + 2 * q) * P + p0;
    ba = load8(br, cc, ncols, 2 * q < jrows, vec_b);
    bb = load8(br + N, cc, ncols, 2 * q + 1 < jrows, vec_b);
    xa = load8(xr, cc, pcols, 2 * q < jrows, vec_x);
    xb = load8(xr + P, cc, pcols, 2 * q + 1 < jrows, vec_x);
  };
  fetch(0);                            // in flight across the cumsum
  chunk_prologue(dt + row0, A[bh], qn, dt_s, cs_s, w_s, cs + row0,
                 blockIdx.z == 0);
  float acc[4][4] = {};
  for (int j0 = 0; j0 < qn; j0 += kT) {
    const int jrows = imin(kT, qn - j0);
    __syncthreads();                   // w_s is written; the tiles are free
    {
      // (B * w)^T in three parts, and x, both paired along j
      const float wa = 2 * q < jrows ? w_s[j0 + 2 * q] : 0.0f;
      const float wb = 2 * q + 1 < jrows ? w_s[j0 + 2 * q + 1] : 0.0f;
      uint32_t parts[8][3];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        split3(__fmul_rn(lo_f(word(ba, k)), wa),
               __fmul_rn(lo_f(word(bb, k)), wb), parts[2 * k]);
        split3(__fmul_rn(hi_f(word(ba, k)), wa),
               __fmul_rn(hi_f(word(bb, k)), wb), parts[2 * k + 1]);
      }
#pragma unroll
      for (int h = 0; h < 3; ++h) {
        uint32_t* d = bw2 + h * kPart + q * kLdW + cc;
        *reinterpret_cast<uint4*>(d) =
            make_uint4(parts[0][h], parts[1][h], parts[2][h], parts[3][h]);
        *reinterpret_cast<uint4*>(d + 4) =
            make_uint4(parts[4][h], parts[5][h], parts[6][h], parts[7][h]);
      }
      put_pairs(x2 + q * kLdW + cc, xa, xb);
    }
    __syncthreads();
    if (j0 + kT < qn) fetch(j0 + kT);  // lands while the MMAs run
    for (int kk = 0; 16 * kk < jrows; ++kk) {
      const int qk = 8 * kk + t;
      uint32_t a[3][4];
#pragma unroll
      for (int h = 0; h < 3; ++h) {
        const uint32_t* p = bw2 + h * kPart + qk * kLdW + 16 * wi + g;
        a[h][0] = p[0];
        a[h][1] = p[8];
        a[h][2] = p[4 * kLdW];
        a[h][3] = p[4 * kLdW + 8];
      }
#pragma unroll
      for (int pt = 0; pt < 4; ++pt) {
        const uint32_t* p = x2 + qk * kLdW + 32 * wj + 8 * pt + g;
        const uint32_t b0 = p[0], b1 = p[4 * kLdW];
#pragma unroll
        for (int h = 0; h < 3; ++h) mma_bf16(acc[pt], a[h], b0, b1);
      }
    }
  }
  float* out = hc + (static_cast<size_t>(bh) * nc + c) * N * P + p0;
#pragma unroll
  for (int pt = 0; pt < 4; ++pt)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = 16 * wi + g + 8 * (k / 2);
      const int p = 32 * wj + 8 * pt + 2 * t + k % 2;
      if (n < ncols && p < pcols)
        out[static_cast<size_t>(n0 + n) * P + p] = acc[pt][k];
    }
}

// ---------------------------------------------------------------------------
// P2: the state pass.  A thread of head bh owns V consecutive elements of
// the state (16 bytes where V = 4) and walks the chunks in order.
// ---------------------------------------------------------------------------

template <int V>
__device__ __forceinline__ void ld_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void st_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_p2_kernel(const float* __restrict__ cs, float* __restrict__ hc,
                   float* __restrict__ state, int S, int NP, int Q, int nc) {
  const int e = (blockIdx.x * kThreads + threadIdx.x) * V;
  const int bh = blockIdx.y;
  if (e >= NP) return;                 // NP is a multiple of V
  const float* csb = cs + static_cast<size_t>(bh) * S;
  float* h = hc + static_cast<size_t>(bh) * nc * NP + e;
  float H[V] = {};
  for (int c0 = 0; c0 < nc; c0 += kP2Batch) {
    // the loads of kP2Batch chunks first, so their latencies overlap
    float sv[kP2Batch][V], cl[kP2Batch];
#pragma unroll
    for (int k = 0; k < kP2Batch; ++k)
      if (c0 + k < nc) {
        ld_v<V>(h + static_cast<size_t>(c0 + k) * NP, sv[k]);
        cl[k] = csb[imin((c0 + k + 1) * Q, S) - 1];
      }
#pragma unroll
    for (int k = 0; k < kP2Batch; ++k)
      if (c0 + k < nc) {
        // the state chunk c0 + k starts from (chunk 0's is zero: P3 does
        // not read it)
        if (c0 + k > 0) st_v<V>(h + static_cast<size_t>(c0 + k) * NP, H);
        const float decay = expf(cl[k]);
#pragma unroll
        for (int v = 0; v < V; ++v) H[v] = __fmaf_rn(decay, H[v], sv[k][v]);
      }
  }
  st_v<V>(state + static_cast<size_t>(bh) * NP + e, H);
}

// ---------------------------------------------------------------------------
// P3: chunk output.  Block (bh, chunk x P tile, 64-row tile of the chunk,
// the longest rows first), a kT x kT tile of y: rows i0 .., columns p0 ..
// ---------------------------------------------------------------------------

// float32: SIMT FMAs.  Thread (ty, tx) owns rows i0 + 4 ty .. + 3 and
// columns p0 + 4 tx .. + 3 of y, and rows ty + 16 r, columns tx + 16 q of
// each tile of C B^T.  Shared: cs, dt (qr floats each), the C tile (kT x
// ldc floats); then either H (np x kT floats) or the B tile (kT x ldc),
// the x tile (kT x kT) and M^T (kT x kLdT).
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_p3_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ B,
                       const float* __restrict__ C,
                       const float* __restrict__ cs,
                       const float* __restrict__ hc, float* __restrict__ y,
                       int S, int P, int N, int Q, int nc, int ntiles_p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int np = n_pad(N);
  const int ldc = np + 4;              // 16-byte rows, an odd count of them
  const int qr = round_up(imin(Q, S), kT);
  float* cs_s = smem;
  float* dt_s = cs_s + qr;
  float* c_s = dt_s + qr;
  float* h_s = c_s + kT * ldc;
  float* b_s = h_s;
  float* x_s = b_s + kT * ldc;
  float* m_s = x_s + kT * kT;

  const int bh = blockIdx.x;
  const int c = blockIdx.y / ntiles_p;
  const int p0 = (blockIdx.y % ntiles_p) * kT;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kT;
  const int c0 = c * Q, qn = imin(Q, S - c0);
  if (i0 >= qn) return;
  const int iend = imin(i0 + kT, qn);
  const int pcols = imin(kT, P - p0);
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const size_t row0 = static_cast<size_t>(bh) * S + c0;
  const bool vec_bc = aligned16(B) && aligned16(C) && N % 4 == 0;
  const bool vec_x = aligned16(x) && P % 4 == 0;
  const bool vec_h = aligned16(hc) && P % 4 == 0;
  const bool vec_y = aligned16(y) && P % 4 == 0;

  for (int i = threadIdx.x; i < iend; i += kThreads) {
    cs_s[i] = cs[row0 + i];
    dt_s[i] = dt[row0 + i];
  }
  stage_f32(c_s, ldc, kT, np, C + (row0 + i0) * N, N, iend - i0, N, vec_bc);
  const bool has_h = c > 0;            // chunk 0 starts from H = 0
  if (has_h)
    stage_f32(h_s, kT, np, kT,
              hc + (static_cast<size_t>(bh) * nc + c) * N * P + p0, P, N,
              pcols, vec_h);
  __syncthreads();

  float acc[4][4] = {};
  if (has_h) {
    // exp(cs_i) * (C_i . H)
    for (int n = 0; n < np; n += 4) {
      float4 cv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = ld4(c_s + (4 * ty + r) * ldc + n);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 hv = ld4(h_s + (n + k) * kT + 4 * tx);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][q] = __fmaf_rn(comp(cv[r], k), comp(hv, q), acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
      const float e = i < iend ? expf(cs_s[i]) : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = __fmul_rn(e, acc[r][q]);
    }
  }

  for (int j0 = 0; j0 <= i0; j0 += kT) {
    const int jrows = imin(kT, qn - j0);
    __syncthreads();                   // h_s, or the last tile's readers
    stage_f32(b_s, ldc, kT, np, B + (row0 + j0) * N, N, jrows, N, vec_bc);
    stage_f32(x_s, kT, kT, kT, x + (row0 + j0) * P + p0, P, jrows, pcols,
              vec_x);
    __syncthreads();
    float sc[4][4] = {};
    for (int n = 0; n < np; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = ld4(c_s + (ty + kSide * r) * ldc + n);
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = ld4(b_s + (tx + kSide * q) * ldc + n);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            sc[r][q] = __fmaf_rn(comp(cv[r], k), comp(bv[q], k), sc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int il = ty + kSide * r, jl = tx + kSide * q;
        const int i = i0 + il, j = j0 + jl;
        float m = 0.0f;
        if (j <= i && i < iend)        // j < qn follows
          m = __fmul_rn(__fmul_rn(sc[r][q], expf(__fsub_rn(cs_s[i], cs_s[j]))),
                        dt_s[j]);
        m_s[jl * kLdT + il] = m;
      }
    __syncthreads();
    // y_i += sum_j M_ij x_j; on the diagonal tile M_ij = 0 past j = i
    int jn = imin(jrows, iend - j0);
    if (j0 == i0) jn = imin(jn, 4 * ty + 4);
    for (int jj = 0; jj < jn; ++jj)
      outer4(acc, ld4(m_s + jj * kLdT + 4 * ty), ld4(x_s + jj * kT + 4 * tx));
  }

  float* yb = y + (row0 + i0) * P + p0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    if (i0 + i >= iend) continue;
    if (vec_y && 4 * tx + 4 <= pcols) {
      *reinterpret_cast<float4*>(yb + static_cast<size_t>(i) * P + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * tx + q < pcols) yb[static_cast<size_t>(i) * P + 4 * tx + q] =
            acc[r][q];
    }
  }
}

// bfloat16: on the tensor cores.  Warp w = (wi, wj) = (w % 4, w / 4)
// computes rows 16 wi .. + 15 and columns 32 wj .. + 31 of each tile of
// C B^T (its 16 rows of C kept as A fragments for the whole block), turns
// them into M in registers, and multiplies its M (three bfloat16 parts)
// by the matching 32 rows of x into a partial y of rows 16 wi .. and all
// kT columns; C H (H in three parts) lands in the columns 32 wj .. of that
// partial, and the two warps of each row block add their partials in
// shared memory at the end.  The tiles j go through two buffers, the next
// one copied with cp.async while the MMAs run on this one.  Shared: cs, dt
// (qr floats each), the C tile (kT x (np + 8) bfloat16), buffer 0; then
// the three parts of H paired along n (3 x np / 2 x kLdW words), or
// buffer 1, or the partial y (kT x kLdT floats).  A buffer is a B tile
// (kT x (np + 8) bfloat16) and an x tile (kT x (kT + 8) bfloat16).
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_p3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ dt,
                        const __nv_bfloat16* __restrict__ B,
                        const __nv_bfloat16* __restrict__ C,
                        const float* __restrict__ cs,
                        const float* __restrict__ hc,
                        __nv_bfloat16* __restrict__ y, int S, int P, int N,
                        int Q, int nc, int ntiles_p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int np = n_pad(N);
  const int ldw = (np + 8) / 2;        // words a bfloat16 row of B or C
  const int qr = round_up(imin(Q, S), kT);
  float* cs_s = smem;
  float* dt_s = cs_s + qr;
  uint32_t* c_s = reinterpret_cast<uint32_t*>(dt_s + qr);
  const int buf = kT * ldw + kT * (kT + 8) / 2;   // words of a buffer
  uint32_t* buf0 = c_s + kT * ldw;
  uint32_t* u_s = buf0 + buf;
  const int h_part = (np / 2) * kLdW;
  uint32_t* h2 = u_s;                  // 3 x np / 2 x kLdW
  float* y_s = reinterpret_cast<float*>(u_s);   // kT x kLdT

  const int bh = blockIdx.x;
  const int c = blockIdx.y / ntiles_p;
  const int p0 = (blockIdx.y % ntiles_p) * kT;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kT;
  const int c0 = c * Q, qn = imin(Q, S - c0);
  if (i0 >= qn) return;
  const int iend = imin(i0 + kT, qn);
  const int pcols = imin(kT, P - p0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wi = warp % 4, wj = warp / 4;
  const size_t row0 = static_cast<size_t>(bh) * S + c0;
  const uint16_t* Bu = reinterpret_cast<const uint16_t*>(B);
  const uint16_t* Cu = reinterpret_cast<const uint16_t*>(C);
  const uint16_t* xu = reinterpret_cast<const uint16_t*>(x);
  const bool vec_bc = aligned16(B) && aligned16(C) && N % 8 == 0;
  const bool vec_x = aligned16(x) && P % 8 == 0;
  const bool vec_h = aligned16(hc) && P % 4 == 0;

  for (int i = threadIdx.x; i < iend; i += kThreads) {
    cs_s[i] = cs[row0 + i];
    dt_s[i] = dt[row0 + i];
  }
  // tile jt of B and x into buffer jt % 2 (buffer 1 is u_s)
  auto issue = [&](int jt) {
    const int j0 = jt * kT, jrows = imin(kT, qn - j0);
    uint16_t* bt = reinterpret_cast<uint16_t*>(jt % 2 ? u_s : buf0);
    copy_tile(bt, np + 8, np, Bu + (row0 + j0) * N, N, jrows, N, vec_bc);
    copy_tile(bt + kT * (np + 8), kT + 8, kT, xu + (row0 + j0) * P + p0, P,
              jrows, pcols, vec_x);
    cp_async_commit();
  };
  copy_tile(reinterpret_cast<uint16_t*>(c_s), np + 8, np,
            Cu + (row0 + i0) * N, N, iend - i0, N, vec_bc);
  issue(0);                            // lands while H is split
  const bool has_h = c > 0;            // chunk 0 starts from H = 0
  if (has_h) {
    // H's rows 2 q and 2 q + 1, four columns, each value in three parts
    const float* hb = hc + (static_cast<size_t>(bh) * nc + c) * N * P + p0;
    for (int e = threadIdx.x; e < (np / 2) * (kT / 4); e += kThreads) {
      const int q = e / (kT / 4), cc = (e % (kT / 4)) * 4;
      const float* r0 = hb + static_cast<size_t>(2 * q) * P;
      const float4 a = load4(r0, cc, pcols, 2 * q < N, vec_h);
      const float4 b = load4(r0 + P, cc, pcols, 2 * q + 1 < N, vec_h);
      uint32_t parts[4][3];
#pragma unroll
      for (int k = 0; k < 4; ++k) split3(comp(a, k), comp(b, k), parts[k]);
#pragma unroll
      for (int h = 0; h < 3; ++h)
        *reinterpret_cast<uint4*>(h2 + h * h_part + q * kLdW + cc) =
            make_uint4(parts[0][h], parts[1][h], parts[2][h], parts[3][h]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 rows of C as A fragments, for every tile j
  uint32_t afr[kMaxK][4];
  {
    const uint32_t* r0 = c_s + (16 * wi + g) * ldw + t;
#pragma unroll
    for (int ks = 0; ks < kMaxK; ++ks)
      if (16 * ks < np) {
        afr[ks][0] = r0[8 * ks];
        afr[ks][1] = r0[8 * ldw + 8 * ks];
        afr[ks][2] = r0[8 * ks + 4];
        afr[ks][3] = r0[8 * ldw + 8 * ks + 4];
      }
  }
  // the rows g and g + 8 of the warp's block of 16
  const int ia = i0 + 16 * wi + g, ib = ia + 8;
  float acc[8][4] = {};                // the partial y: 16 rows x kT columns
  if (has_h) {
    // exp(cs_i) * (C_i . H) into the columns 32 wj .. + 31
    float off[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kMaxK; ++ks)
      if (16 * ks < np) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t* p = h2 + (8 * ks + t) * kLdW + 32 * wj + 8 * q + g;
#pragma unroll
          for (int h = 0; h < 3; ++h)
            mma_bf16(off[q], afr[ks], p[h * h_part], p[h * h_part + 4 * kLdW]);
        }
      }
    const float ea = ia < iend ? expf(cs_s[ia]) : 0.0f;
    const float eb = ib < iend ? expf(cs_s[ib]) : 0.0f;
    // (compile-time indices into acc, which keeps it in registers)
#pragma unroll
    for (int pt = 0; pt < 8; ++pt)
      if (pt / 4 == wj) {
        acc[pt][0] = __fmul_rn(ea, off[pt % 4][0]);
        acc[pt][1] = __fmul_rn(ea, off[pt % 4][1]);
        acc[pt][2] = __fmul_rn(eb, off[pt % 4][2]);
        acc[pt][3] = __fmul_rn(eb, off[pt % 4][3]);
      }
  }

  const int ntiles = i0 / kT + 1;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();                   // h2's readers, or tile jt - 1's
    if (jt + 1 < ntiles) issue(jt + 1);
    if (jt > 0) {                      // tile jt has landed
      if (jt + 1 < ntiles)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
    const uint32_t* b_s = jt % 2 ? u_s : buf0;
    const uint16_t* xt = reinterpret_cast<const uint16_t*>(b_s + kT * ldw);
    // a block of 16 columns j of the warp is dead on the diagonal tile
    // when it starts past the warp's last row
    bool live[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      live[kk] = !(j0 == i0 && 32 * wj + 16 * kk > 16 * wi + 15);
    // C B^T: rows 16 wi .., columns 32 wj + 8 nt ..
    float d[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kMaxK; ++ks)
      if (16 * ks < np) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (live[nt / 2]) {
            const uint32_t* p = b_s + (32 * wj + 8 * nt + g) * ldw + 8 * ks + t;
            mma_bf16(d[nt], afr[ks], p[0], p[4]);
          }
      }
    // M in place, then M x: M's fragments of two column blocks of 8 are
    // the A fragment of one step of 16 over j
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = k < 2 ? ia : ib;
        const int j = j0 + 32 * wj + 8 * nt + 2 * t + k % 2;
        d[nt][k] = j <= i && i < iend   // j < qn follows
                       ? __fmul_rn(__fmul_rn(d[nt][k],
                                             expf(__fsub_rn(cs_s[i], cs_s[j]))),
                                   dt_s[j])
                       : 0.0f;
      }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (!live[kk]) continue;
      // the A fragments of M's three parts: a[h] = {rows g, g + 8} x
      // {columns 2 t .., 2 t + 8 ..} of part h
      uint32_t a[3][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t w[3];
        split3(d[2 * kk + r / 2][2 * (r % 2)], d[2 * kk + r / 2][2 * (r % 2) + 1],
               w);
#pragma unroll
        for (int h = 0; h < 3; ++h) a[h][r] = w[h];
      }
      // lanes 0-15 address rows 32 wj + 16 kk .. + 15 at column 16 pp,
      // lanes 16-31 the same rows at column 16 pp + 8
      const uint16_t* xr =
          xt + (32 * wj + 16 * kk + lane % 16) * (kT + 8) + 8 * (lane / 16);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t b[4];
        ldsm_x4_trans(b, xr + 16 * pp);
#pragma unroll
        for (int h = 0; h < 3; ++h) {
          mma_bf16(acc[2 * pp], a[h], b[0], b[1]);
          mma_bf16(acc[2 * pp + 1], a[h], b[2], b[3]);
        }
      }
    }
  }

  // the two partials of each row block, added in shared memory
  __syncthreads();                     // the tiles' readers are done
  float* ya = y_s + (16 * wi + g) * kLdT + 2 * t;
  if (wj == 1)
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      ya[8 * pt] = acc[pt][0];
      ya[8 * pt + 1] = acc[pt][1];
      ya[8 * kLdT + 8 * pt] = acc[pt][2];
      ya[8 * kLdT + 8 * pt + 1] = acc[pt][3];
    }
  __syncthreads();
  if (wj == 0)
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      ya[8 * pt] = __fadd_rn(ya[8 * pt], acc[pt][0]);
      ya[8 * pt + 1] = __fadd_rn(ya[8 * pt + 1], acc[pt][1]);
      ya[8 * kLdT + 8 * pt] = __fadd_rn(ya[8 * kLdT + 8 * pt], acc[pt][2]);
      ya[8 * kLdT + 8 * pt + 1] =
          __fadd_rn(ya[8 * kLdT + 8 * pt + 1], acc[pt][3]);
    }
  __syncthreads();
  // y rounded to bfloat16 once: 8 columns a thread, 16 bytes where allowed
  uint16_t* yu = reinterpret_cast<uint16_t*>(y) + (row0 + i0) * P + p0;
  const bool vec_y = aligned16(y) && P % 8 == 0;
  for (int e = threadIdx.x; e < kT * (kT / 8); e += kThreads) {
    const int r = e / (kT / 8), cc = (e % (kT / 8)) * 8;
    if (i0 + r >= iend || cc >= pcols) continue;
    const float* v = y_s + r * kLdT + cc;
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = pack_bf16x2(v[2 * k], v[2 * k + 1]);
    uint16_t* out = yu + static_cast<size_t>(r) * P + cc;
    if (vec_y && cc + 8 <= pcols) {
      *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int k = 0; k < 8 && cc + k < pcols; ++k)
        out[k] = static_cast<uint16_t>(k % 2 ? w[k / 2] >> 16 : w[k / 2]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the three launches' shapes, then the launches.
// ---------------------------------------------------------------------------

struct Plan {
  dim3 grid[3];
  size_t smem[3];
  int nc;
  int v2;                              // state elements a P2 thread owns
};

Plan make_plan(bool bf16, int BH, int S, int P, int N, int Q) {
  Plan pl;
  const int nc = S > 0 ? (S + Q - 1) / Q : 0;
  const int qe = S > 0 ? imin(Q, S) : 1;
  const int ntn = (N + kT - 1) / kT, ntp = (P + kT - 1) / kT;
  const size_t np = n_pad(N), q4 = round_up(qe, 4), q64 = round_up(qe, kT);
  pl.nc = nc;
  pl.grid[0] = dim3(BH, nc, ntn * ntp);
  pl.smem[0] = 4 * (3 * q4 + (bf16 ? 4 * (kT / 2) * kLdW : 2 * kT * kT));
  pl.v2 = (N * P) % 4 == 0 ? 4 : 1;
  pl.grid[1] = dim3((N * P / pl.v2 + kThreads - 1) / kThreads, BH);
  pl.smem[1] = 0;
  pl.grid[2] = dim3(BH, nc * ntp, (qe + kT - 1) / kT);
  if (bf16) {
    const size_t ldw = (np + 8) / 2;
    const size_t h = 3 * (np / 2) * kLdW, buf = kT * ldw + kT * (kT + 8) / 2;
    size_t u = h > buf ? h : buf;
    u = u > kT * kLdT ? u : kT * kLdT;
    pl.smem[2] = 4 * (2 * q64 + kT * ldw + buf + u);
  } else {
    const size_t ldc = np + 4;
    const size_t tiles = kT * ldc + kT * kT + kT * kLdT;
    const size_t u = tiles > np * kT ? tiles : np * kT;
    pl.smem[2] = 4 * (2 * q64 + kT * ldc + u);
  }
  return pl;
}

bool plan_ok(const Plan& pl) {
  for (int k = 0; k < 3; ++k)
    if (pl.grid[k].y > 65535 || pl.grid[k].z > 65535 ||
        pl.smem[k] > static_cast<size_t>(kMaxSmem))
      return false;
  return true;
}

// The kernels of each phase for one input type.
struct Kernels {
  const void* fn[3];
};

Kernels kernels(bool bf16, int v2) {
  Kernels k;
  k.fn[0] = bf16 ? (const void*)ssd_scan_p1_bf16_kernel
                 : (const void*)ssd_scan_p1_f32_kernel;
  k.fn[1] = v2 == 4 ? (const void*)ssd_scan_p2_kernel<4>
                    : (const void*)ssd_scan_p2_kernel<1>;
  k.fn[2] = bf16 ? (const void*)ssd_scan_p3_bf16_kernel
                 : (const void*)ssd_scan_p3_f32_kernel;
  return k;
}

// Lets P1's and P3's kernels take up to kMaxSmem bytes of dynamic shared
// memory, the most plan_ok admits: once per device, not per launch.
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  for (int bf16 = 0; bf16 < 2; ++bf16) {
    const Kernels k = kernels(bf16 == 1, 4);
    for (int p = 0; p < 3; p += 2) {
      err = cudaFuncSetAttribute(k.fn[p],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return err;
    }
  }
  if (cached) done[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

cudaError_t launch(bool bf16, const void* x, const float* dt, const float* A,
                   const void* B, const void* C, void* y, float* state,
                   float* cs, float* hc, int BH, int S, int P, int N, int Q,
                   cudaStream_t stream) {
  const Plan pl = make_plan(bf16, BH, S, P, N, Q);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  const int ntn = (N + kT - 1) / kT, ntp = (P + kT - 1) / kT;
  using bf = __nv_bfloat16;
  if (pl.nc > 0) {
    if (bf16)
      ssd_scan_p1_bf16_kernel<<<pl.grid[0], kThreads, pl.smem[0], stream>>>(
          static_cast<const bf*>(x), dt, A, static_cast<const bf*>(B), cs, hc,
          S, P, N, Q, pl.nc, ntn);
    else
      ssd_scan_p1_f32_kernel<<<pl.grid[0], kThreads, pl.smem[0], stream>>>(
          static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
          cs, hc, S, P, N, Q, pl.nc, ntn);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (pl.v2 == 4)
    ssd_scan_p2_kernel<4><<<pl.grid[1], kThreads, 0, stream>>>(
        cs, hc, state, S, N * P, Q, pl.nc);
  else
    ssd_scan_p2_kernel<1><<<pl.grid[1], kThreads, 0, stream>>>(
        cs, hc, state, S, N * P, Q, pl.nc);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.nc == 0) return err;
  if (bf16)
    ssd_scan_p3_bf16_kernel<<<pl.grid[2], kThreads, pl.smem[2], stream>>>(
        static_cast<const bf*>(x), dt, static_cast<const bf*>(B),
        static_cast<const bf*>(C), cs, hc, static_cast<bf*>(y), S, P, N, Q,
        pl.nc, ntp);
  else
    ssd_scan_p3_f32_kernel<<<pl.grid[2], kThreads, pl.smem[2], stream>>>(
        static_cast<const float*>(x), dt, static_cast<const float*>(B),
        static_cast<const float*>(C), cs, hc, static_cast<float*>(y), S, P, N,
        Q, pl.nc, ntp);
  return cudaGetLastError();
}

bool args_ok(int dtype, int BH, int S, int P, int N, int Q) {
  return BH >= 0 && S >= 0 && P >= 1 && N >= 1 && N <= kMaxN && Q >= 1 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// Per-head layout, all row-major and contiguous: x (BH, S, P), dt (BH, S)
// float32, A (BH,) float32, B and C (BH, S, N) of x's type; y (BH, S, P)
// of x's type, state (BH, N, P) float32.  Scratch, float32, written and
// read by the three phases: cs (BH, S), the chunks' cumsums; hc (BH,
// ceil(S / Q), N, P), the chunk states and then the state each chunk
// starts from.  dtype: 0 float32, 1 bfloat16.  Q is the chunk length.
// Returns cudaSuccess (0) or the first launch error; an argument the
// kernels do not take (N outside [1, 128], Q < 1, a grid or shared memory
// past the card's limits) returns cudaErrorInvalidValue without launching.
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* B, const void* C, void* y, float* state,
                    float* cs, float* hc, int dtype, int BH, int S, int P,
                    int N, int Q, void* stream) {
  if (!args_ok(dtype, BH, S, P, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  if (!plan_ok(make_plan(dtype == 1, BH, S, P, N, Q)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(dtype == 1, x, dt, A, B, C, y, state, cs, hc,
                                 BH, S, P, N, Q,
                                 static_cast<cudaStream_t>(stream)));
}

// What a launch with these arguments runs, launching nothing: for each
// phase k = 0, 1, 2 (P1, P2, P3), out[4 k] blocks, out[4 k + 1] threads a
// block, out[4 k + 2] bytes of shared memory a block and out[4 k + 3] the
// blocks an SM holds at once (asked of the current card).  Returns 0, or
// cudaErrorInvalidValue for arguments ssd_scan_launch refuses.
int ssd_scan_plan(int dtype, int BH, int S, int P, int N, int Q, int* out) {
  if (!args_ok(dtype, BH, S, P, N, Q) || BH == 0 || S == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = dtype == 1;
  const Plan pl = make_plan(bf16, BH, S, P, N, Q);
  if (!plan_ok(pl)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem();
  const Kernels k = kernels(bf16, pl.v2);
  for (int p = 0; p < 3 && err == cudaSuccess; ++p) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k.fn[p],
                                                        kThreads, pl.smem[p]);
    out[4 * p] = static_cast<int>(pl.grid[p].x * pl.grid[p].y * pl.grid[p].z);
    out[4 * p + 1] = kThreads;
    out[4 * p + 2] = static_cast<int>(pl.smem[p]);
    out[4 * p + 3] = per_sm;
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
