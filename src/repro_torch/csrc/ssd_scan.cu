// Mamba-2 chunked SSD scan (state-space duality, arXiv:2405.21060) for
// sm_90a: the full-sequence scan of every mamba block of the LM engine's
// prefill.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/ssd_scan/kernel.py::_ssd_kernel  (ssd_scan_heads)
// which ran one program per (batch, head), staged the head's whole
// sequence in VMEM, walked the chunks with a fori_loop and carried the
// (N, P) state in a VMEM buffer.  This kernel computes the same function
// (kernels/ssd_scan/kernel.py::plain) per head and chunk of Q rows:
//
//   cs   = cumsum(dt * A)                              (float32)
//   M_ij = (C_i . B_j) * exp(cs_i - cs_j) * dt_j       for j <= i, else 0
//   y_i  = sum_j M_ij x_j  +  exp(cs_i) * (C_i . H)    (float32, one
//                                                       rounding to x's type)
//   H    = exp(cs_last) * H + sum_j (B_j * exp(cs_last - cs_j) * dt_j) x_j
//
// from H = 0, every product and sum in float32 (x, B, C read as float32 or
// bfloat16); it returns y in x's type and the final H in float32.  Against
// the plain version only the order of the float32 sums differs, so the two
// are held to a tolerance (1e-4, the reference's), not bitwise.
//
// Where the TPU layout does not carry over:
//  * Shared memory.  At the model's chunk (Q = 256, N = 128, P = 64) one
//    chunk of x, B and C in float32 and the (Q, Q) decay-weighted score
//    tile are 576 KB, past a block's 227 KB.  So a block walks a chunk in
//    tiles of kR = 64 rows: a C tile (the rows i), a B and an x tile (the
//    columns j <= i), and the (kR, kR) tile of M; the (N, kPT) state stays
//    in shared memory across the whole chunk loop and never goes through
//    device memory.  About 132 KB at N = 128, so one block per SM.
//  * Padding.  The ragged last chunk is masked (rows past the sequence
//    load as zeros, their M entries are zero, cs_last is the last real
//    row's), where the TPU zero-padded S to a multiple of Q.  Padded rows
//    have dt = 0, so both give the same y and final state.
//  * Grid.  One block per (batch*head, tile of kPT = 64 columns of P): at
//    P = 64 that is one block per head, 48 blocks for a batch-1 prefill at
//    mamba2-780m width, on 132 SMs.  The columns of P are independent
//    given M, so narrower P tiles (M recomputed per tile) would fill the
//    card: later work.
//
// Bound.  At the main path's shape (b = 1, S = 1000, 48 heads, P = 64,
// N = 128, one group of B and C) y and the final H do not depend on the
// chunk length, and the least work is the chunked form at about 15 rows:
// C H and the state update (N P multiply-adds per row and head each) and
// M x over the small triangles, about 0.84 G float32 FMAs, 25 us at the
// card's 33.5 T float32 FMA/s, with C B^T once per group on the bf16
// tensor cores (their products are exact in float32).  Inputs and outputs
// are 15 MB (4 us at 3.35 TB/s): operations bound it.  This kernel works
// at the model's Q = 256, where C B^T per head and M x over 256-row
// triangles make about 1.97 G float32 instructions; it issues no FMA (the
// port builds with --fmad=false) and no tensor-core op, so each
// multiply-add is two instructions plus its shared-memory loads; each
// thread keeps a 4 x 4 register tile of outputs so that one load serves
// four products.  FMA, tensor cores (tf32 is not float32, so bf16 tiles
// with float32 sums where the inputs are bf16), TMA and the P-tile grid
// are later work.
//
// Plain C interface (loaded with ctypes); launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // a 16 x 16 grid of threads
constexpr int kSide = 16;
constexpr int kR = 64;               // rows of a tile (i or j)
constexpr int kPT = 64;              // columns of P per block
constexpr int kRT = kR / kSide;      // tile rows per thread
constexpr int kCT = kPT / kSide;     // tile columns per thread
constexpr int kMaxN = 128;           // state rows: kNT per thread
constexpr int kNT = kMaxN / kSide;
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// dst[r * ld + c] = src[r * src_ld + c] as float32 for r < rows and
// c < cols, zero elsewhere in the kR x width tile.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, int width,
                                          const T* __restrict__ src,
                                          int src_ld, int rows, int cols) {
  for (int e = threadIdx.x; e < kR * width; e += kThreads) {
    const int r = e / width, c = e % width;
    float v = 0.0f;
    if (r < rows && c < cols) v = to_f(src[static_cast<size_t>(r) * src_ld + c]);
    dst[r * ld + c] = v;
  }
}

// cs[i] = sum_{k <= i} dt[k] * a over the chunk's qn rows, added left to
// right in float32 by one thread: the plain version's order, so the decays
// agree bit for bit (at a chunk's |cs| of a few hundred one float32 ulp of
// cs is a few 1e-5 of every decay).  About 5 us a chunk.
__device__ __forceinline__ void chunk_cumsum(const float* dt_s, float* cs_s,
                                             int qn, float a) {
  float run = 0.0f;
  for (int i = 0; i < qn; ++i) {
    run = run + dt_s[i] * a;
    cs_s[i] = run;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, T* __restrict__ y,
                float* __restrict__ state, int S, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int ldn = N + 1;               // padded: column reads hit 16 banks
  const int ldm = kR + 1;
  float* c_s = smem;                   // kR x ldn, the rows i of C
  float* b_s = c_s + kR * ldn;         // kR x ldn, the rows j of B
  float* m_s = b_s + kR * ldn;         // kR x ldm, the tile of M
  float* x_s = m_s + kR * ldm;         // kR x kPT, the rows j of x
  float* h_s = x_s + kR * kPT;         // N x kPT, the carried state
  float* dt_s = h_s + N * kPT;         // Q
  float* cs_s = dt_s + Q;              // Q
  float* w_s = cs_s + Q;               // Q: exp(cs_last - cs_j) * dt_j

  const int bh = blockIdx.x;
  const int p0 = blockIdx.y * kPT;
  const int pcols = min(kPT, P - p0);
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const float a = A[bh];
  const T* xb = x + static_cast<size_t>(bh) * S * P + p0;
  const T* Bb = B + static_cast<size_t>(bh) * S * N;
  const T* Cb = C + static_cast<size_t>(bh) * S * N;
  const float* dtb = dt + static_cast<size_t>(bh) * S;
  T* yb = y + static_cast<size_t>(bh) * S * P + p0;

  for (int e = threadIdx.x; e < N * kPT; e += kThreads) h_s[e] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int qn = min(Q, S - c0);
    __syncthreads();                   // the last chunk's readers are done
    for (int i = threadIdx.x; i < qn; i += kThreads) dt_s[i] = dtb[c0 + i];
    __syncthreads();
    if (threadIdx.x == 0) chunk_cumsum(dt_s, cs_s, qn, a);
    __syncthreads();
    const float cs_last = cs_s[qn - 1];
    for (int i = threadIdx.x; i < qn; i += kThreads)
      w_s[i] = expf(cs_last - cs_s[i]) * dt_s[i];

    // y of the chunk's rows, tile by tile, against the state it starts from
    for (int i0 = 0; i0 < qn; i0 += kR) {
      __syncthreads();                 // c_s is free
      load_tile(c_s, ldn, N, Cb + static_cast<size_t>(c0 + i0) * N, N,
                min(kR, qn - i0), N);
      __syncthreads();
      float off[kRT][kCT], diag[kRT][kCT];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int c = 0; c < kCT; ++c) off[r][c] = diag[r][c] = 0.0f;
      // inter-chunk: C_i . H
      for (int n = 0; n < N; ++n) {
        float cv[kRT], hv[kCT];
#pragma unroll
        for (int r = 0; r < kRT; ++r) cv[r] = c_s[(ty + kSide * r) * ldn + n];
#pragma unroll
        for (int c = 0; c < kCT; ++c) hv[c] = h_s[n * kPT + tx + kSide * c];
#pragma unroll
        for (int r = 0; r < kRT; ++r)
#pragma unroll
          for (int c = 0; c < kCT; ++c) off[r][c] = off[r][c] + cv[r] * hv[c];
      }
      // intra-chunk: the tiles j0 <= i0 of M, each times its rows of x
      for (int j0 = 0; j0 <= i0; j0 += kR) {
        const int jrows = min(kR, qn - j0);
        __syncthreads();               // b_s, x_s and m_s are free
        load_tile(b_s, ldn, N, Bb + static_cast<size_t>(c0 + j0) * N, N,
                  jrows, N);
        load_tile(x_s, kPT, kPT, xb + static_cast<size_t>(c0 + j0) * P, P,
                  jrows, pcols);
        __syncthreads();
        float sc[kRT][kCT];
#pragma unroll
        for (int r = 0; r < kRT; ++r)
#pragma unroll
          for (int c = 0; c < kCT; ++c) sc[r][c] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float cv[kRT], bv[kCT];
#pragma unroll
          for (int r = 0; r < kRT; ++r) cv[r] = c_s[(ty + kSide * r) * ldn + n];
#pragma unroll
          for (int c = 0; c < kCT; ++c) bv[c] = b_s[(tx + kSide * c) * ldn + n];
#pragma unroll
          for (int r = 0; r < kRT; ++r)
#pragma unroll
            for (int c = 0; c < kCT; ++c) sc[r][c] = sc[r][c] + cv[r] * bv[c];
        }
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          const int i = i0 + ty + kSide * r;
#pragma unroll
          for (int c = 0; c < kCT; ++c) {
            const int j = j0 + tx + kSide * c;
            float m = 0.0f;
            if (j <= i && i < qn)      // j < qn follows
              m = sc[r][c] * expf(cs_s[i] - cs_s[j]) * dt_s[j];
            m_s[(ty + kSide * r) * ldm + tx + kSide * c] = m;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < jrows; ++jj) {
          float mv[kRT], xv[kCT];
#pragma unroll
          for (int r = 0; r < kRT; ++r) mv[r] = m_s[(ty + kSide * r) * ldm + jj];
#pragma unroll
          for (int c = 0; c < kCT; ++c) xv[c] = x_s[jj * kPT + tx + kSide * c];
#pragma unroll
          for (int r = 0; r < kRT; ++r)
#pragma unroll
            for (int c = 0; c < kCT; ++c)
              diag[r][c] = diag[r][c] + mv[r] * xv[c];
        }
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const int i = i0 + ty + kSide * r;
        if (i >= qn) continue;
        const float e = expf(cs_s[i]);
        T* yrow = yb + static_cast<size_t>(c0 + i) * P;
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
          const int p = tx + kSide * c;
          if (p < pcols) put(yrow + p, diag[r][c] + e * off[r][c]);
        }
      }
    }

    // the state the chunk hands on: thread (ty, tx) owns rows ty + 16 k
    // and columns tx + 16 c of H
    float acc[kNT][kCT];
#pragma unroll
    for (int k = 0; k < kNT; ++k)
#pragma unroll
      for (int c = 0; c < kCT; ++c) acc[k][c] = 0.0f;
    for (int j0 = 0; j0 < qn; j0 += kR) {
      const int jrows = min(kR, qn - j0);
      __syncthreads();                 // b_s and x_s are free
      load_tile(b_s, ldn, N, Bb + static_cast<size_t>(c0 + j0) * N, N, jrows,
                N);
      load_tile(x_s, kPT, kPT, xb + static_cast<size_t>(c0 + j0) * P, P,
                jrows, pcols);
      __syncthreads();
      for (int jj = 0; jj < jrows; ++jj) {
        const float w = w_s[j0 + jj];
        float xv[kCT];
#pragma unroll
        for (int c = 0; c < kCT; ++c) xv[c] = x_s[jj * kPT + tx + kSide * c];
#pragma unroll
        for (int k = 0; k < kNT; ++k) {
          const int n = ty + kSide * k;
          if (n >= N) break;
          const float bw = b_s[jj * ldn + n] * w;
#pragma unroll
          for (int c = 0; c < kCT; ++c) acc[k][c] = acc[k][c] + bw * xv[c];
        }
      }
    }
    __syncthreads();                   // every reader of h_s is done
    const float decay = expf(cs_last);
#pragma unroll
    for (int k = 0; k < kNT; ++k) {
      const int n = ty + kSide * k;
      if (n >= N) break;
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        float* h = h_s + n * kPT + tx + kSide * c;
        *h = decay * *h + acc[k][c];
      }
    }
  }
  __syncthreads();
  float* sb = state + static_cast<size_t>(bh) * N * P + p0;
  for (int e = threadIdx.x; e < N * kPT; e += kThreads) {
    const int n = e / kPT, p = e % kPT;
    if (p < pcols) sb[static_cast<size_t>(n) * P + p] = h_s[e];
  }
}

size_t smem_bytes(int N, int Q) {
  return sizeof(float) * (static_cast<size_t>(2) * kR * (N + 1) +
                          kR * (kR + 1) + kR * kPT +
                          static_cast<size_t>(N) * kPT +
                          static_cast<size_t>(3) * Q);
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* dt, const float* A,
                         const void* B, const void* C, void* y, float* state,
                         int BH, int S, int P, int N, int Q,
                         cudaStream_t stream) {
  const size_t bytes = smem_bytes(N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (P + kPT - 1) / kPT);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), state, S, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-head layout, all row-major and contiguous: x (BH, S, P), dt (BH, S)
// float32, A (BH,) float32, B and C (BH, S, N) of x's type; y (BH, S, P)
// of x's type, state (BH, N, P) float32.  dtype: 0 float32, 1 bfloat16.
// Q is the chunk length.  Returns cudaSuccess (0) or the launch error; an
// argument the kernel does not take (N outside [1, 128], Q < 1, shared
// memory past a block's) returns cudaErrorInvalidValue without launching.
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* B, const void* C, void* y, float* state,
                    int dtype, int BH, int S, int P, int N, int Q,
                    void* stream) {
  if (BH < 0 || S < 0 || P < 1 || N < 1 || N > kMaxN || Q < 1 ||
      (dtype != 0 && dtype != 1) || (P + kPT - 1) / kPT > 65535 ||
      smem_bytes(N, Q) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(x, dt, A, B, C, y, state, BH, S, P, N,
                                       Q, s)
                 : launch_typed<__nv_bfloat16>(x, dt, A, B, C, y, state, BH,
                                               S, P, N, Q, s);
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
