// The phase wrap and the clip of the carrier loops' steps, shared by
// `costas_scan` (sync_loops.cu) and `pll_scan` (seq_loops.cu).
// `identity_kernel` (sync_loops.cu, `costas_identity_check`) sweeps
// `wrap_pi_turn`, in both its forms (the turn's bits an immediate, as
// Costas passes them, and a kernel parameter, as the PLL does), and
// `clip` over every float32; tests/test_torch_sync_loops_cuda.py::
// test_phase_identities_hold_over_every_float32 runs it.
//
// Arithmetic as in the plain loops (kernels/loops.py `_wrap_pi`, the
// clamps): every product and sum rounded on its own, IEEE division,
// rintf (half to even, as jnp.round).

#pragma once

#include <cuda_runtime.h>

constexpr float kTwoPi = 6.28318530717958647692f;
constexpr unsigned kTwoPiBits = 0x40c90fdbu;  // the bits of kTwoPi

__device__ __forceinline__ float wrap_pi(float ph) {
  return __fsub_rn(ph, __fmul_rn(kTwoPi, rintf(__fdiv_rn(ph, kTwoPi))));
}

// wrap_pi(v) for |v| < loops.COSTAS_WRAP_TURN, where round(v / 2pi) is
// -1, +-0 or 1, without the division or a branch: v - 2pi * k, k = +-1
// from |v| >= t (= COSTAS_WRAP_FAST) and the sign of v, and v - (-0) =
// v + 0 for k = +-0.  The turn 2pi * sign(v) is one lop3, (v & sign) |
// two_pi, with ``two_pi`` (kTwoPiBits) in a register where it comes as a
// kernel parameter (the PLL's); with the bits an immediate in C it took
// two, one more dependent op on the PLL's chain (6 % of its step on an
// H100).  The Costas step passes kTwoPiBits itself.
__device__ __forceinline__ float wrap_pi_turn(float v, float t,
                                              unsigned two_pi) {
  unsigned turn;
  asm("lop3.b32 %0, %1, 0x80000000, %2, 0xEA;"  // (a & b) | c
      : "=r"(turn)
      : "r"(__float_as_uint(v)), "r"(two_pi));
  return __fsub_rn(v, fabsf(v) >= t ? __uint_as_float(turn) : -0.f);
}

// clip to [lo, hi], a NaN let through, as torch.clamp on the card:
// max.NaN and min.NaN return NaN if either input is NaN (the bounds of a
// driven row never are)
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(lo));
  asm("min.NaN.f32 %0, %0, %1;" : "+f"(r) : "f"(hi));
  return r;
}
