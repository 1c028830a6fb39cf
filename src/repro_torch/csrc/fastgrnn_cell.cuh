// Device code shared by the FastGRNN cell kernels (q15_step.cu,
// q15_step_dense.cu, fastgrnn_window.cu): the nearest-bucket LUT and the
// gate combine, each the op sequence of the plain versions in
// repro_torch/kernels/fastgrnn_cell/qstep.py.  Every multiply and add is
// an explicit round-to-nearest intrinsic (the files build with
// --fmad=false), so the kernels stay bitwise equal to the plain versions.

#pragma once

namespace fastgrnn_cell {

constexpr int kLut = 256;

// Nearest-bucket LUT over [-8, 8] (Appendix C): index (v + 8) * 16
// truncated toward zero (NaN -> 0), clamped to [0, 255], then the
// saturation overrides in the plain version's order (lut_eval_batched).
__device__ __forceinline__ float lut_nearest(const float* t, float v) {
  int idx = __float2int_rz(__fmul_rn(__fsub_rn(v, -8.0f), 16.0f));
  idx = idx < 0 ? 0 : (idx > kLut - 1 ? kLut - 1 : idx);
  float y = t[idx];
  if (v >= 8.0f) y = t[kLut - 1];
  if (v <= -8.0f) y = t[0];
  return y;
}

// (zeta * (1 - z) + nu) * ht + z * h, in this order.
__device__ __forceinline__ float gate(float z, float ht, float h, float zeta,
                                     float nu) {
  float t = __fsub_rn(1.0f, z);
  t = __fmul_rn(zeta, t);
  t = __fadd_rn(t, nu);
  t = __fmul_rn(t, ht);
  return __fadd_rn(t, __fmul_rn(z, h));
}

}  // namespace fastgrnn_cell
