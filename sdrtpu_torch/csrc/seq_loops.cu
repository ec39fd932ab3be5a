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
// chain.
//
// pll_scan: one block of kPllWarps warps owns one row, in tiles of
// kPllTile samples.  Lane 0 walks the recurrence over tile k out of shared
// memory (kPllGroup steps' angles read ahead into registers), leaving the
// phase before each update; meanwhile warps 1.. take atan2f of tile k+1
// (loaded straight from device memory: their tile's work is a small share
// of lane 0's walk) and cosf/sinf of tile k-1's phases, stored coalesced;
// one block barrier a tile.  Lane 0's step is the error, its wrap, the
// frequency and its clip, the phase and its wrap.  Each wrap was a
// division (`wrap_pi`); a row whose |phase0| <= kPllPhaseBound, in a loop
// whose alpha and frequency bounds keep both wraps' inputs below
// loops.COSTAS_WRAP_TURN (`pll_params_bounded`), takes `wrap_pi_turn`
// instead, a compare, a select and a subtraction (`phase_wrap.cuh`,
// shared with the Costas step: the same bits as the division's wrap at
// every float32 below COSTAS_WRAP_TURN, by `costas_identity_check`'s
// sweep, tests/test_torch_sync_loops_cuda.py::
// test_phase_identities_hold_over_every_float32); any other row takes
// the division.
//
// agc_scan: one block of kAgcWarps warps owns one row.  The step's gain
// needs an IEEE division, and whether the step clips (ia * gain >
// max_out, the average then jumping to the suffix maximum) needs that
// gain; neither need be on the chain:
//   - the gain after the step is ia != 0 ? min(set_point / a_i, max_gain)
//     : 1 in both branches, a_i the average after the step, so lane 0
//     records a_i and the other warps form the gains behind it;
//   - the clip test RN(ia * min(RN(set_point / a), max_gain)) > max_out
//     is monotone in a, so for each sample one threshold A' (`agc_clip_
//     threshold`, found by a search over the float32 bit patterns from
//     an estimate) gives it as a < A' exactly (-inf: never clips).
// Lane 0's step is then two products (rounded each), an add, the
// ia > amp select, the compare with A' and the select of the suffix
// maximum (a silent sample takes the decay branch with coefficient 1
// and addend +0, which gives the average back).  Warps 1.. copy tile
// k+2 in by cp.async, compute tile k+1's products and thresholds and
// tile k-1's gains while lane 0 walks tile k, each thread on the same
// samples of every tile (no barrier among them); one block barrier a
// tile.  Lane 0 reads kAgcGroup steps' inputs ahead of those steps.
// The identities hold in a domain decided once a row (set_point
// in (0, FLT_MAX], max_out >= 0, the four coefficients in [+0, +inf],
// amp0 and every suffix maximum neither negative nor -0, every |x| not
// negative: the average then stays in [+0, +inf] or NaN), read by every
// thread while the helpers copy in and prepare the first tile; any other
// row walks today's step (`agc_step`: the division and the clip test on
// lane 0, warp 0 alone).  Both walks are the kernel.
//
// Arithmetic is that of the reference, step for step, in float32 with
// every product and sum rounded on its own (__fmul_rn/__fadd_rn: no
// fused multiply-add, so the plain PyTorch loops give the same bits),
// IEEE division, rintf (half to even, as jnp.round) in the phase wrap,
// and no fast-math intrinsics (atan2f, cosf and sinf are the functions
// torch.atan2, torch.cos and torch.sin call on the card);
// tests/test_torch_seq_loops_cuda.py holds both kernels bit-equal to
// their plain loops.
//
// The C entry points take raw pointers and the stream, launch on that
// stream, neither synchronise nor allocate, and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstring>

#include "phase_wrap.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kWarp = 32;
constexpr int kGroup = 8;  // steps whose inputs lane 0 reads ahead
constexpr unsigned kInfBits = 0x7f800000u;

// minimum that lets a NaN through, as jnp.minimum and torch.minimum do
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- agc_scan -----------------------------------------------------------

constexpr int kAgcWarps = 4;  // warp 0 walks, the others prepare and finish
constexpr int kAgcGroup = 16;  // steps whose inputs lane 0 reads ahead
constexpr int kAgcHelpers = (kAgcWarps - 1) * kWarp;

struct AgcParams {
  float one_m_atk, atk, one_m_dcy, dcy, set_point, max_gain, max_out;
  int in_domain;  // the parameters lie in the threshold walk's domain
};

// One AGC step as the reference takes it: updates the running average,
// returns the gain.  The general walk's step.
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

// The first u in (f, t] with pred(u), for a pred monotone in u (false up
// to the answer, true from it on) with pred(f) false and pred(t) true:
// from ``guess``, steps of 1, 2, 4, ... towards the answer, then halving.
template <typename Pred>
__device__ __forceinline__ unsigned first_true(unsigned f, unsigned t,
                                               unsigned guess, Pred pred) {
  if (guess > f && guess < t) {
    if (pred(guess)) {
      t = guess;
      for (unsigned d = 1; t - f > d; d <<= 1) {
        if (!pred(t - d)) {
          f = t - d;
          break;
        }
        t -= d;
      }
    } else {
      f = guess;
      for (unsigned d = 1; t - f > d; d <<= 1) {
        if (pred(f + d)) {
          t = f + d;
          break;
        }
        f += d;
      }
    }
  }
  while (t - f > 1) {
    const unsigned m = f + (t - f) / 2;
    if (pred(m))
      t = m;
    else
      f = m;
  }
  return t;
}

// The clip threshold of a sample: the step clips exactly where the
// average before the clip test, a (in [+0, +inf] or NaN), is below it.
// For ia in (0, FLT_MAX] and a finite max_out, G is the largest float32
// g with RN(ia * g) <= max_out (for ia = +inf, +0: the product exceeds
// max_out exactly where g > +0), so the step clips where min(q,
// max_gain) > G, q = RN(set_point / a); if max_gain > G that is q > G,
// i.e. a < A, the smallest a in [+0, +inf] with RN(set_point / a) <= G.
// Otherwise (ia 0, -0 or NaN, max_out inf, max_gain <= G or NaN) it
// never clips: -inf.
__device__ __forceinline__ float agc_clip_threshold(float ia,
                                                    const AgcParams& p) {
  const float inf = __int_as_float(kInfBits);
  if (!(ia > 0.f && p.max_out < inf)) return -inf;
  const float mo = p.max_out, sp = p.set_point;
  float G = 0.f;
  if (ia < inf) {
    const unsigned guess = __float_as_uint(fminf(__fdiv_rn(mo, ia), FLT_MAX));
    // the first g with RN(ia * g) > max_out: pred(+0) false, pred(inf)
    // true
    G = __uint_as_float(first_true(0u, kInfBits, guess, [&](unsigned u) {
          return __fmul_rn(ia, __uint_as_float(u)) > mo;
        }) - 1u);
  }
  if (!(p.max_gain > G)) return -inf;
  // the first a with RN(sp / a) <= G: pred(+0) false (sp / 0 = inf > G),
  // pred(inf) true (sp / inf = 0)
  const unsigned guess = __float_as_uint(__fdiv_rn(sp, G));
  return __uint_as_float(first_true(0u, kInfBits, guess, [&](unsigned u) {
    return __fdiv_rn(sp, __uint_as_float(u)) <= G;
  }));
}

// neither negative nor -0 (NaN passes)
__device__ __forceinline__ bool agc_state_ok(float v) {
  return !(v < 0.f) && __float_as_uint(v) != 0x80000000u;
}

struct AgcTiles {
  float ia[2][kTile], sm[2][kTile];  // cp.async's copies of tiles k+1, k+2
  // per sample: ia, RN(ia * atk), RN(ia * dcy) (silent: +0), one_m_dcy
  // (silent: 1); and the clip threshold, the suffix maximum
  float4 c[2][kTile];
  float2 t[2][kTile];
  float a[2][kTile];  // the average after each step of tile k (lane 0)
};

__device__ __forceinline__ int agc_tile_len(long long n, int k) {
  const long long left = n - (long long)k * kTile;
  return (int)(left < kTile ? left : kTile);
}

// The helpers' work on one row (``h``: the thread's index among them;
// each thread takes the same samples of every tile, so no barrier is
// needed among them).
struct AgcRow {
  const float* __restrict__ ia_row;
  const float* __restrict__ sm_row;
  float* __restrict__ g_row;
  long long n;
  int h;

  // cp.async's copies of tile k into buffer k & 1
  __device__ __forceinline__ void fetch(AgcTiles& s, int k) const {
    const int m = agc_tile_len(n, k);
    const long long t0 = (long long)k * kTile;
    for (int i = h; i < m; i += kAgcHelpers) {
      cp_async4(&s.ia[k & 1][i], ia_row + t0 + i);
      cp_async4(&s.sm[k & 1][i], sm_row + t0 + i);
    }
  }
  // tile k's products and thresholds, off the chain
  __device__ __forceinline__ void derive(AgcTiles& s, int k,
                                         const AgcParams& p) const {
    const int m = agc_tile_len(n, k), b = k & 1;
    for (int i = h; i < m; i += kAgcHelpers) {
      const float ia = s.ia[b][i];
      const bool live = ia != 0.f;
      s.c[b][i] = make_float4(ia, __fmul_rn(ia, p.atk),
                              live ? __fmul_rn(ia, p.dcy) : 0.f,
                              live ? p.one_m_dcy : 1.f);
      s.t[b][i] = make_float2(agc_clip_threshold(ia, p), s.sm[b][i]);
    }
  }
  // tile k's gains from the averages lane 0 recorded
  __device__ __forceinline__ void gains(AgcTiles& s, int k,
                                        const AgcParams& p) const {
    const int m = agc_tile_len(n, k), b = k & 1;
    float* g = g_row + (long long)k * kTile;
    for (int i = h; i < m; i += kAgcHelpers)
      g[i] = s.c[b][i].x != 0.f
                 ? min_nan(__fdiv_rn(p.set_point, s.a[b][i]), p.max_gain)
                 : 1.f;
  }
};

// Lane 0's walk over one tile of the threshold walk: the chain.
__device__ __forceinline__ float agc_walk_tile(float amp, const float4* sc,
                                               const float2* st, float* sa,
                                               int m, const AgcParams& p) {
  auto step = [&](const float4 c, const float2 t) {
    const float up = __fadd_rn(__fmul_rn(amp, p.one_m_atk), c.y);
    const float dn = __fadd_rn(__fmul_rn(amp, c.w), c.z);
    const float a = (c.x > amp) ? up : dn;
    amp = (a < t.x) ? t.y : a;
  };
  int i = 0;
  for (; i + kAgcGroup <= m; i += kAgcGroup) {
    float4 c[kAgcGroup];
    float2 t[kAgcGroup];
#pragma unroll
    for (int j = 0; j < kAgcGroup; ++j) {
      c[j] = sc[i + j];
      t[j] = st[i + j];
    }
#pragma unroll
    for (int j = 0; j < kAgcGroup; ++j) {
      step(c[j], t[j]);
      sa[i + j] = amp;
    }
  }
  for (; i < m; ++i) {
    step(sc[i], st[i]);
    sa[i] = amp;
  }
  return amp;
}

// The rest of a row in the threshold walk, once tile 0's products and
// thresholds are formed and tile 1's copies are in (the prologue): lane
// 0 walks tile k while the helpers form tile k-1's gains, copy in tile
// k+2 and form tile k+1's products and thresholds; one block barrier a
// tile.
__device__ __forceinline__ float agc_threshold_walk(const AgcRow& r,
                                                    float amp,
                                                    const AgcParams& p,
                                                    AgcTiles& s) {
  const int tiles = (int)((r.n + kTile - 1) / kTile);
  for (int k = 0; k <= tiles; ++k) {
    if (r.h < 0) {
      if (threadIdx.x == 0 && k < tiles) {
        const int m = agc_tile_len(r.n, k), b = k & 1;
        amp = agc_walk_tile(amp, s.c[b], s.t[b], s.a[b], m, p);
      }
    } else {
      // tile k-1's gains first: derive(k+1) writes over its samples
      if (k >= 1) r.gains(s, k - 1, p);
      if (k + 1 < tiles) {
        if (k + 2 < tiles) r.fetch(s, k + 2);  // over tile k's copies
        cp_async_commit();
        cp_async_wait<1>();  // this thread's copies of tile k+1
        r.derive(s, k + 1, p);
      }
    }
    __syncthreads();
  }
  return amp;
}

// One row in the general walk: warp 0 alone, today's step on lane 0,
// over arrays of its own.
__device__ __forceinline__ float agc_general_walk(
    const float* __restrict__ ia_row, const float* __restrict__ sm_row,
    float* __restrict__ g_row, long long n, float amp, const AgcParams& p) {
  __shared__ float s_ia[kTile];
  __shared__ float s_sm[kTile];
  __shared__ float s_g[kTile];
  const int lane = threadIdx.x;
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
  return amp;
}

__global__ void __launch_bounds__(kAgcWarps * kWarp)
    agc_scan_kernel(const float* __restrict__ in_amp,
                    const float* __restrict__ suffix_max,
                    float* __restrict__ gain,
                    const float* __restrict__ amp_in,
                    float* __restrict__ amp_out, long long n, AgcParams p) {
  __shared__ __align__(16) AgcTiles s;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const AgcRow r{in_amp + row * n, suffix_max + row * n, gain + row * n, n,
                 tid - kWarp};
  float amp = amp_in[row];
  // the walk, decided once a row and the same on every thread.  While
  // every thread reads its share of the row (its loads independent of
  // each other), the helpers copy in tiles 0 and 1 and form tile 0's
  // products and thresholds, which the threshold walk starts from (and
  // the general walk does not read)
  int out = !(p.in_domain && agc_state_ok(amp));
  if (!out) {
    if (r.h >= 0) {
      r.fetch(s, 0);
      cp_async_commit();
      if (n > kTile) r.fetch(s, 1);
      cp_async_commit();
    }
#pragma unroll 8
    for (long long i = tid; i < n; i += kAgcWarps * kWarp)
      out |= (r.ia_row[i] < 0.f) | !agc_state_ok(r.sm_row[i]);
    if (r.h >= 0) {
      cp_async_wait<0>();
      r.derive(s, 0, p);
    }
  }
  out = __syncthreads_or(out);
  if (!out) {
    amp = agc_threshold_walk(r, amp, p, s);
  } else {
    if (tid >= kWarp) return;
    amp = agc_general_walk(r.ia_row, r.sm_row, r.g_row, n, amp, p);
  }
  if (tid == 0) amp_out[row] = amp;
}

// -- pll_scan -----------------------------------------------------------

constexpr int kPllWarps = 4;   // warp 0 walks, the others prepare and finish
constexpr int kPllTile = 512;
constexpr int kPllGroup = 16;  // steps whose inputs lane 0 reads ahead
constexpr int kPllHelpers = (kPllWarps - 1) * kWarp;
// a row whose |phase| starts at most this, in a loop whose frequency
// bounds and alpha keep every |phase + freq + alpha * err| below
// COSTAS_WRAP_TURN (`bounded`), keeps |phase| below it at every step
constexpr float kPllPhaseBound = 3.2f;

struct PllParams {
  float alpha, beta, fmin, fmax;
  float wrap_fast;     // loops.COSTAS_WRAP_FAST: below it the wrap is v + 0
  unsigned two_pi;     // kTwoPiBits, a parameter: see `wrap_pi_turn`
  int bounded;         // the parameters keep a bounded row's wraps in a turn
};

template <bool kBounded>
__device__ __forceinline__ float pll_wrap(float v, const PllParams& p) {
  if constexpr (kBounded)
    return wrap_pi_turn(v, p.wrap_fast, p.two_pi);
  else
    return wrap_pi(v);
}

// One PLL step on the pilot's angle: returns the phase the VCO is
// emitted at (the one before the update).  kBounded: both wraps' inputs
// lie within a turn (see `bounded`), so they take `wrap_pi_turn`, no
// division.
template <bool kBounded>
__device__ __forceinline__ float pll_step(float& phase, float& freq,
                                          float ang, const PllParams& p) {
  const float emitted = phase;
  const float err = pll_wrap<kBounded>(__fsub_rn(ang, phase), p);
  freq = clip(__fadd_rn(freq, __fmul_rn(p.beta, err)), p.fmin, p.fmax);
  phase = pll_wrap<kBounded>(
      __fadd_rn(__fadd_rn(phase, freq), __fmul_rn(p.alpha, err)), p);
  return emitted;
}

__device__ __forceinline__ int pll_tile_len(long long n, int k) {
  const long long left = n - (long long)k * kPllTile;
  return (int)(left < kPllTile ? left : kPllTile);
}

// tile k's angles into ``ang``, thread ``h`` of ``stride`` taking every
// stride-th sample
__device__ __forceinline__ void pll_angles(const float2* __restrict__ x_row,
                                           long long n, int k, float* ang,
                                           int h, int stride) {
  const int m = pll_tile_len(n, k);
  const float2* x = x_row + (long long)k * kPllTile;
#pragma unroll 4
  for (int i = h; i < m; i += stride) {
    const float2 v = x[i];
    ang[i] = atan2f(v.y, v.x);
  }
}

// tile k's VCO phasors from the phases lane 0 left in ``ph``
__device__ __forceinline__ void pll_phasors(const float* ph,
                                            float2* __restrict__ v_row,
                                            long long n, int k, int h) {
  const int m = pll_tile_len(n, k);
  float2* v = v_row + (long long)k * kPllTile;
  for (int i = h; i < m; i += kPllHelpers)
    v[i] = make_float2(cosf(ph[i]), sinf(ph[i]));
}

// Lane 0's walk over one tile: the chain.
template <bool kBounded>
__device__ __forceinline__ void pll_walk_tile(float& phase, float& freq,
                                              const float* sa, float* sp,
                                              int m, const PllParams& p) {
  int i = 0;
  for (; i + kPllGroup <= m; i += kPllGroup) {
    float a[kPllGroup];
#pragma unroll
    for (int j = 0; j < kPllGroup; ++j) a[j] = sa[i + j];
#pragma unroll
    for (int j = 0; j < kPllGroup; ++j)
      sp[i + j] = pll_step<kBounded>(phase, freq, a[j], p);
  }
  for (; i < m; ++i) sp[i] = pll_step<kBounded>(phase, freq, sa[i], p);
}

__global__ void __launch_bounds__(kPllWarps * kWarp)
    pll_scan_kernel(const float2* __restrict__ x, float2* __restrict__ vco,
                    const float* __restrict__ phase_in,
                    const float* __restrict__ freq_in,
                    float* __restrict__ phase_out,
                    float* __restrict__ freq_out, long long n, PllParams p) {
  __shared__ float s_ang[2][kPllTile];  // the angles of tiles k, k+1
  __shared__ float s_ph[2][kPllTile];   // the phases of tiles k-1, k
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const float2* x_row = x + row * n;
  float2* v_row = vco + row * n;
  float phase = phase_in[row];
  float freq = freq_in[row];
  // the walk, decided once a row
  const bool bounded = p.bounded && fabsf(phase) <= kPllPhaseBound;
  const int tiles = (int)((n + kPllTile - 1) / kPllTile);
  pll_angles(x_row, n, 0, s_ang[0], tid, kPllWarps * kWarp);
  __syncthreads();
  // lane 0 walks tile k while the helpers form tile k-1's phasors and
  // tile k+1's angles; one block barrier a tile
  for (int k = 0; k <= tiles; ++k) {
    const int b = k & 1;
    if (tid == 0) {
      if (k < tiles) {
        const int m = pll_tile_len(n, k);
        if (bounded)
          pll_walk_tile<true>(phase, freq, s_ang[b], s_ph[b], m, p);
        else
          pll_walk_tile<false>(phase, freq, s_ang[b], s_ph[b], m, p);
      }
    } else if (tid >= kWarp) {
      const int h = tid - kWarp;
      if (k >= 1) pll_phasors(s_ph[b ^ 1], v_row, n, k - 1, h);
      if (k + 1 < tiles) pll_angles(x_row, n, k + 1, s_ang[b ^ 1], h,
                                    kPllHelpers);
    }
    __syncthreads();
  }
  if (tid == 0) {
    phase_out[row] = phase;
    freq_out[row] = freq;
  }
}

}  // namespace

// The threshold walk's domain of the parameters: set_point in (0,
// FLT_MAX], max_out >= 0, the four coefficients in [+0, +inf].
static int agc_params_in_domain(float one_m_atk, float atk, float one_m_dcy,
                                float dcy, float set_point, float max_out) {
  auto plus = [](float v) {  // +0 .. +inf, not NaN
    unsigned u;
    memcpy(&u, &v, sizeof u);
    return u <= kInfBits;
  };
  return set_point > 0.f && set_point <= FLT_MAX && max_out >= 0.f &&
         plus(one_m_atk) && plus(atk) && plus(one_m_dcy) && plus(dcy);
}

extern "C" int agc_scan_launch(const void* in_amp, const void* suffix_max,
                               void* gain, const void* amp_in, void* amp_out,
                               long long rows, long long n, float one_m_atk,
                               float atk, float one_m_dcy, float dcy,
                               float set_point, float max_gain, float max_out,
                               void* stream) {
  const AgcParams p{one_m_atk,
                    atk,
                    one_m_dcy,
                    dcy,
                    set_point,
                    max_gain,
                    max_out,
                    agc_params_in_domain(one_m_atk, atk, one_m_dcy, dcy,
                                         set_point, max_out)};
  agc_scan_kernel<<<(unsigned)rows, kAgcWarps * kWarp, 0,
                    (cudaStream_t)stream>>>(
      static_cast<const float*>(in_amp), static_cast<const float*>(suffix_max),
      static_cast<float*>(gain), static_cast<const float*>(amp_in),
      static_cast<float*>(amp_out), n, p);
  return (int)cudaGetLastError();
}

// A bounded row (|phase0| <= kPllPhaseBound) keeps every wrap's input
// within one turn when kPllPhaseBound + max|fmin, fmax| + |alpha| *
// kPllPhaseBound stays below COSTAS_WRAP_TURN: |ang| <= float32(pi) (atan2f),
// so |ang - phase| <= pi + kPllPhaseBound; each wrap within a turn leaves
// |.| <= float32(pi), so |err| <= pi and |phase| stays within the bound;
// |freq| <= max|fmin, fmax| after the clip; the 0.999 covers the sums'
// rounding.  NaN bounds or alpha: the general walk.  Mirrored by
// loops.pll_bounded.
static int pll_params_bounded(float alpha, float fmin, float fmax,
                              float wrap_turn) {
  const float reach = kPllPhaseBound + fmaxf(fabsf(fmin), fabsf(fmax)) +
                      fabsf(alpha) * kPllPhaseBound;
  return fmin == fmin && fmax == fmax && reach < 0.999f * wrap_turn;
}

extern "C" int pll_scan_launch(const void* x, void* vco, const void* phase_in,
                               const void* freq_in, void* phase_out,
                               void* freq_out, long long rows, long long n,
                               float alpha, float beta, float fmin, float fmax,
                               void* stream) {
  // loops.COSTAS_WRAP_FAST and COSTAS_WRAP_TURN, formed as loops forms
  // them: float32(pi)'s successor and float32(3) * float32(pi)
  const float pi = (float)3.14159265358979323846;
  const float wrap_fast = nextafterf(pi, FLT_MAX);
  const float wrap_turn = 3.0f * pi;
  const PllParams p{alpha,
                    beta,
                    fmin,
                    fmax,
                    wrap_fast,
                    kTwoPiBits,
                    pll_params_bounded(alpha, fmin, fmax, wrap_turn)};
  pll_scan_kernel<<<(unsigned)rows, kPllWarps * kWarp, 0,
                    (cudaStream_t)stream>>>(
      static_cast<const float2*>(x), static_cast<float2*>(vco),
      static_cast<const float*>(phase_in), static_cast<const float*>(freq_in),
      static_cast<float*>(phase_out), static_cast<float*>(freq_out), n, p);
  return (int)cudaGetLastError();
}
