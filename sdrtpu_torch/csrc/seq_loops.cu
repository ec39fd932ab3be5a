// Sequential feedback loops as scans, for Hopper: the AGC and the PLL.
//
// These have no Pallas counterpart.  In sdrtpu they are per-sample
// `lax.scan` loops (sdrtpu/kernels/loops.py `Agc.__call__` and
// `Pll.__call__`), which XLA compiles into one program; in eager PyTorch
// the same loop is ~10 small kernels per sample, each costing the host
// several microseconds to enqueue, so a 12 500-sample pilot block would
// take seconds.  Here each loop is one launch.
//
//   agc_scan:  gain[r, i], amp[r]  from  |x|[r, i], suffix_max[r, i], amp0[r]
//   pll_scan:  vco[r, i], (phase, freq)[r]  from  x[r, i], (phase0, freq0)[r]
//
// What bounds them: neither bytes nor operations but the dependent
// latency of one step times the number of steps; a row is a serial chain
// (the carry of step i feeds step i+1), and rows are few.  The design
// therefore keeps everything that does not depend on the carry off the
// chain.  One warp owns one row and walks it in tiles of kTile samples:
//
//   1. all 32 lanes load the tile into shared memory (coalesced) and do
//      the carry-free work in parallel (PLL: atan2f of every sample);
//   2. lane 0 runs the recurrence over the tile out of shared memory,
//      leaving one float per step (AGC: the gain; PLL: the phase before
//      the update); it reads kGroup steps' inputs into registers ahead
//      of those steps, so no step waits for a shared-memory load;
//   3. all lanes finish the outputs in parallel (PLL: cosf/sinf of the
//      phases) and store them coalesced.
//
// Arithmetic is that of the reference, step for step, in float32 with
// every product and sum rounded on its own (__fmul_rn/__fadd_rn: no
// fused multiply-add, so the plain PyTorch loops give the same bits),
// IEEE division, rintf (half to even, as jnp.round) in the phase wrap,
// and no fast-math intrinsics.
//
// The C entry points take raw pointers and the stream, launch on that
// stream, neither synchronise nor allocate, and return
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;
constexpr int kWarp = 32;
constexpr int kGroup = 8;  // steps whose inputs lane 0 reads ahead
constexpr float kTwoPi = 6.28318530717958647692f;

// minimum that lets a NaN through, as jnp.minimum and torch.minimum do
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

struct AgcParams {
  float one_m_atk, atk, one_m_dcy, dcy, set_point, max_gain, max_out;
};

// One AGC step: updates the running average, returns the gain.
__device__ __forceinline__ float agc_step(float& amp, float ia, float sm,
                                          const AgcParams& p) {
  const float up = __fadd_rn(__fmul_rn(amp, p.one_m_atk),
                             __fmul_rn(ia, p.atk));
  const float dn = __fadd_rn(__fmul_rn(amp, p.one_m_dcy),
                             __fmul_rn(ia, p.dcy));
  float a = (ia > amp) ? up : dn;
  // a silent sample holds the average and passes at gain 1, so
  // set_point/amp is never formed from amp == 0
  a = (ia != 0.f) ? a : amp;
  float g = (ia != 0.f) ? min_nan(__fdiv_rn(p.set_point, a), p.max_gain)
                        : 1.f;
  if (__fmul_rn(ia, g) > p.max_out) {
    // would clip: jump to the largest amplitude still to come
    a = sm;
    g = min_nan(__fdiv_rn(p.set_point, a), p.max_gain);
  }
  amp = a;
  return g;
}

__global__ void agc_scan_kernel(const float* __restrict__ in_amp,
                                const float* __restrict__ suffix_max,
                                float* __restrict__ gain,
                                const float* __restrict__ amp_in,
                                float* __restrict__ amp_out, long long n,
                                AgcParams p) {
  __shared__ float s_ia[kTile];
  __shared__ float s_sm[kTile];
  __shared__ float s_g[kTile];

  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  const float* ia_row = in_amp + row * n;
  const float* sm_row = suffix_max + row * n;
  float* g_row = gain + row * n;
  float amp = amp_in[row];

  for (long long t0 = 0; t0 < n; t0 += kTile) {
    const int m = (int)((n - t0 < kTile) ? (n - t0) : kTile);
    for (int i = lane; i < m; i += kWarp) {
      s_ia[i] = ia_row[t0 + i];
      s_sm[i] = sm_row[t0 + i];
    }
    __syncwarp();
    if (lane == 0) {
      int i = 0;
      for (; i + kGroup <= m; i += kGroup) {
        float ia[kGroup], sm[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          ia[k] = s_ia[i + k];
          sm[k] = s_sm[i + k];
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          s_g[i + k] = agc_step(amp, ia[k], sm[k], p);
      }
      for (; i < m; ++i) s_g[i] = agc_step(amp, s_ia[i], s_sm[i], p);
    }
    __syncwarp();
    for (int i = lane; i < m; i += kWarp) g_row[t0 + i] = s_g[i];
    __syncwarp();
  }
  if (lane == 0) amp_out[row] = amp;
}

__device__ __forceinline__ float wrap_pi(float ph) {
  return __fsub_rn(ph, __fmul_rn(kTwoPi, rintf(__fdiv_rn(ph, kTwoPi))));
}

struct PllParams {
  float alpha, beta, fmin, fmax;
};

// One PLL step on the pilot's angle: returns the phase the VCO is
// emitted at (the one before the update).
__device__ __forceinline__ float pll_step(float& phase, float& freq,
                                          float ang, const PllParams& p) {
  const float emitted = phase;
  const float err = wrap_pi(__fsub_rn(ang, phase));
  freq = __fadd_rn(freq, __fmul_rn(p.beta, err));
  freq = min_nan(p.fmax, (freq > p.fmin || freq != freq) ? freq : p.fmin);
  phase = wrap_pi(__fadd_rn(__fadd_rn(phase, freq), __fmul_rn(p.alpha, err)));
  return emitted;
}

__global__ void pll_scan_kernel(const float2* __restrict__ x,
                                float2* __restrict__ vco,
                                const float* __restrict__ phase_in,
                                const float* __restrict__ freq_in,
                                float* __restrict__ phase_out,
                                float* __restrict__ freq_out, long long n,
                                PllParams p) {
  __shared__ float s_ang[kTile];
  __shared__ float s_ph[kTile];

  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  const float2* x_row = x + row * n;
  float2* v_row = vco + row * n;
  float phase = phase_in[row];
  float freq = freq_in[row];

  for (long long t0 = 0; t0 < n; t0 += kTile) {
    const int m = (int)((n - t0 < kTile) ? (n - t0) : kTile);
    for (int i = lane; i < m; i += kWarp) {
      const float2 v = x_row[t0 + i];
      s_ang[i] = atan2f(v.y, v.x);
    }
    __syncwarp();
    if (lane == 0) {
      int i = 0;
      for (; i + kGroup <= m; i += kGroup) {
        float ang[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) ang[k] = s_ang[i + k];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          s_ph[i + k] = pll_step(phase, freq, ang[k], p);
      }
      for (; i < m; ++i) s_ph[i] = pll_step(phase, freq, s_ang[i], p);
    }
    __syncwarp();
    for (int i = lane; i < m; i += kWarp) {
      const float ph = s_ph[i];
      v_row[t0 + i] = make_float2(cosf(ph), sinf(ph));
    }
    __syncwarp();
  }
  if (lane == 0) {
    phase_out[row] = phase;
    freq_out[row] = freq;
  }
}

}  // namespace

extern "C" int agc_scan_launch(const void* in_amp, const void* suffix_max,
                               void* gain, const void* amp_in, void* amp_out,
                               long long rows, long long n, float one_m_atk,
                               float atk, float one_m_dcy, float dcy,
                               float set_point, float max_gain, float max_out,
                               void* stream) {
  const AgcParams p{one_m_atk, atk, one_m_dcy, dcy, set_point, max_gain,
                    max_out};
  agc_scan_kernel<<<(unsigned)rows, kWarp, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(in_amp), static_cast<const float*>(suffix_max),
      static_cast<float*>(gain), static_cast<const float*>(amp_in),
      static_cast<float*>(amp_out), n, p);
  return (int)cudaGetLastError();
}

extern "C" int pll_scan_launch(const void* x, void* vco, const void* phase_in,
                               const void* freq_in, void* phase_out,
                               void* freq_out, long long rows, long long n,
                               float alpha, float beta, float fmin, float fmax,
                               void* stream) {
  pll_scan_kernel<<<(unsigned)rows, kWarp, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(x), static_cast<float2*>(vco),
      static_cast<const float*>(phase_in), static_cast<const float*>(freq_in),
      static_cast<float*>(phase_out), static_cast<float*>(freq_out), n,
      PllParams{alpha, beta, fmin, fmax});
  return (int)cudaGetLastError();
}
