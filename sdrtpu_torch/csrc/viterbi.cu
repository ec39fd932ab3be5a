// Soft-decision Viterbi decoder of a rate-1/R convolutional code (R = 2, 3
// or 4; K <= 7), for Hopper.
//
// No Pallas counterpart: in sdrtpu the decoder is two `lax.scan`s
// (`ViterbiDecoder.decode`, sdrtpu/fec/viterbi.py:104-140): the
// add-compare-select recursion over time with all 2^(K-1) states updated
// at once (:128), then the traceback over the stored decisions (:138).
// Eager PyTorch would spend ~10 small kernels per step on it; here one
// launch decodes a whole block (one CTA per row).
//
//   viterbi_decode: bits[r, i], metrics[r, s]  from  sym[r, i, 0..R-1]
//
// What bounds it: the dependent latency of one step times the steps.
// Each step's metrics feed the next step's, and the normalisation takes
// the maximum over all states, so the add-compare-select is a serial
// chain; the traceback is another chain of a few integer operations per
// step.  Bytes and operations are far below what the card moves in that
// time.  The design keeps the chain in registers:
//
//   - one warp, state s on lane s % 32 (two states a lane at K = 7).  The
//     states s and s + 32 of a lane have the same two predecessors,
//     p0 = (s << 1) & (S-1) and p0 | 1, which sit on lanes p0 % 32 and
//     (p0 | 1) % 32 in half p0 / 32: each step fetches them with
//     independent shuffles (two at K < 7, four and a select at K = 7);
//   - a lane carries its states' metrics unnormalised (nm) beside the
//     step's maximum (mx); a predecessor's metric is the shuffled
//     nm - mx, the same rounded subtract the plain version makes, so the
//     shuffles run while the maximum is reduced;
//   - the maximum in one instruction: each metric maps to an int32 key
//     that orders as the floats do (the magnitude bits of a negative
//     flipped), __reduce_max_sync (redux.sync.max.s32) takes the largest
//     key, and the key maps back to that metric's bits; absent states
//     (lanes past S at K < 7) offer INT_MIN;
//   - each step's decisions are packed with __ballot_sync into two 32-bit
//     words (states 0-31 and 32-63); lane i % 32 keeps step i's, and the
//     warp stores 32 steps' words at once (coalesced, 8 bytes a step)
//     to the caller's scratch;
//   - the soft symbols come in tiles of kSymTile steps through two shared
//     buffers, the cp.async copies of tile k+1 in flight while tile k is
//     decoded;
//   - the traceback in 32 chunks, one a lane (steps [l L, (l+1) L), L =
//     ceil(n / 32)), all walked at once: the lane of the newest chunk
//     starts from the first-argmax final state; every other lane starts
//     kWarmup steps above its chunk (or at the final state, if that is
//     nearer) from state 0 and walks down to its chunk without writing,
//     by when survivor paths have merged.  Then, from the newest chunk
//     down, each lane's start is held against the state the lane above
//     reached below its chunk; a lane whose start differs walks its chunk
//     again from that state.  The path is a function of its state at one
//     step, so the bits are the serial traceback's, always; only how
//     often a chunk is walked twice depends on the data.  Each lane keeps
//     kAhead steps' decision words in flight ahead of its walk (a word's
//     address depends only on the step, never on the state).
//
// The trellis is the reference's shift register (newest bit at the MSB):
// the predecessors of state s are ((s << 1) & (S-1)) | j for j = 0, 1,
// and the bit that led to s is s >> (K-2).  The expected symbols come in
// as the reference's ``expected[prev, prev_bit]`` table (S, 2, R) of +-1.
//
// Arithmetic is the plain version's (`viterbi_decode_ref`), to the bit:
// each branch metric is the sum of R exact products (the expected
// symbols are +-1) in r order, ((p0 + p1) + p2) + p3, each add rounded
// on its own; each candidate one rounded add, the pick the first maximum
// (c1 > c0, as jnp.argmax), the normalisation one rounded subtract of the
// maximum over the states (the key's maximum is that metric, bit for bit;
// no metric is ever -0, so the key's -0 < +0 never decides).  So kernel
// and plain PyTorch loop produce the same bits and final metrics; at R = 2
// they are also the JAX package's (its einsum over two products has one
// order), at R = 3 and 4 whenever that einsum's order gives the same sums
// (always for DAB's +-1 and 0 soft symbols).
//
// tests/test_torch_viterbi_cuda.py holds the kernel bit-equal to the
// plain loop over K x R x n x rows.
//
// The C entry point takes raw pointers and the stream, launches on that
// stream, neither synchronises nor allocates (the decision scratch comes
// from the caller), and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSymTile = 512;   // steps of soft symbols a tile, two tiles
constexpr int kWarmup = 512;    // steps a traceback lane walks before its chunk
constexpr int kAhead = 16;      // decision words a traceback lane loads ahead

// An int32 key that orders as the float32 does (for all but NaN; -0
// below +0), and its inverse, which is the same map.
__device__ __forceinline__ int key_of(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float float_of(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
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

// the warp's cp.async copies of the soft symbols of steps t0 .. t0+m-1
template <int R>
__device__ __forceinline__ void sym_fetch(float* s, const float* sr,
                                          long long t0, int m, int lane) {
  for (int i = lane; i < R * m; i += kWarp) cp_async4(s + i, sr + R * t0 + i);
  cp_async_commit();
}

// The traceback from ``state`` at step ``top`` down to step ``bottom``:
// with kEmit, each step's bit (its state's top bit) into br; returns the
// state at step bottom - 1.  The words of the next kAhead steps are
// loaded while the current kAhead are walked.
template <bool kEmit>
__device__ __forceinline__ int walk_back(const uint2* __restrict__ ch,
                                         unsigned char* __restrict__ br,
                                         long long top, long long bottom,
                                         int state, int mask, int top_shift) {
  uint2 cur[kAhead], nxt[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    if (top - k >= bottom) cur[k] = ch[top - k];
  for (long long i = top; i >= bottom; i -= kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (i - kAhead - k >= bottom) nxt[k] = ch[i - kAhead - k];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (i - k < bottom) break;
      if (kEmit) br[i - k] = (unsigned char)(state >> top_shift);
      const unsigned word = (state & 32) ? cur[k].y : cur[k].x;
      state = ((state << 1) | ((word >> (state & 31)) & 1)) & mask;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) cur[k] = nxt[k];
  }
  return state;
}

// kTwo: S = 64, two states a lane; else S <= 32, one state a lane
template <int R, bool kTwo>
__global__ void __launch_bounds__(kWarp)
    viterbi_kernel(const float* __restrict__ sym,
                   const float* __restrict__ exp_prev,
                   uint2* __restrict__ choices,
                   unsigned char* __restrict__ bits,
                   float* __restrict__ metrics_out, long long n, int S,
                   int top_shift) {
  constexpr int H = kTwo ? 2 : 1;
  __shared__ __align__(16) float s_sym[2][R * kSymTile];

  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  const float* sr = sym + row * n * R;
  uint2* ch = choices + row * n;
  unsigned char* br = bits + row * n;

  // this lane's states lane + 32 h, their expected symbols, and the lanes
  // and half that hold their predecessors
  const bool has = kTwo || lane < S;
  const int p0 = (lane << 1) & (S - 1);
  const int src0 = p0 & 31, src1 = (p0 | 1) & 31;
  const bool upper = kTwo && p0 >= kWarp;
  float e[H][2][R];
  float nm[H];  // unnormalised metrics; the metrics are nm - mx
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int s = lane + kWarp * h;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r)
        e[h][j][r] = has ? exp_prev[(s * 2 + j) * R + r] : 0.f;
    nm[h] = (s == 0) ? 0.f : -1e9f;
  }
  float mx = 0.f;
  unsigned w_lo = 0, w_hi = 0;  // this lane's step's decision words

  // add-compare-select
  sym_fetch<R>(s_sym[0], sr, 0, (int)(n < kSymTile ? n : kSymTile), lane);
  int b = 0;
  for (long long t0 = 0; t0 < n; t0 += kSymTile, b ^= 1) {
    const int m = (int)((n - t0 < kSymTile) ? (n - t0) : kSymTile);
    // tile k+1 in flight while tile k is decoded; s_sym[b ^ 1] was last
    // read in tile k-1, which the __syncwarp of its last word store closed
    const long long t1 = t0 + kSymTile;
    if (t1 < n)
      sym_fetch<R>(s_sym[b ^ 1], sr, t1,
                   (int)((n - t1 < kSymTile) ? (n - t1) : kSymTile), lane);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const float* ss = s_sym[b];
    for (int i0 = 0; i0 < m; i0 += kWarp) {
      const int kn = (m - i0 < kWarp) ? (m - i0) : kWarp;
#pragma unroll 8
      for (int k = 0; k < kn; ++k) {
        float rs[R];
#pragma unroll
        for (int r = 0; r < R; ++r) rs[r] = ss[R * (i0 + k) + r];
        // the predecessors' unnormalised metrics, then their metrics
        float q0 = __shfl_sync(kFull, nm[0], src0);
        float q1 = __shfl_sync(kFull, nm[0], src1);
        if constexpr (kTwo) {
          const float u0 = __shfl_sync(kFull, nm[H - 1], src0);
          const float u1 = __shfl_sync(kFull, nm[H - 1], src1);
          q0 = upper ? u0 : q0;
          q1 = upper ? u1 : q1;
        }
        const float m0 = __fsub_rn(q0, mx), m1 = __fsub_rn(q1, mx);
        bool pick[H];
        int key = INT_MIN;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float bm0 = __fmul_rn(rs[0], e[h][0][0]);
          float bm1 = __fmul_rn(rs[0], e[h][1][0]);
#pragma unroll
          for (int r = 1; r < R; ++r) {
            bm0 = __fadd_rn(bm0, __fmul_rn(rs[r], e[h][0][r]));
            bm1 = __fadd_rn(bm1, __fmul_rn(rs[r], e[h][1][r]));
          }
          const float c0 = __fadd_rn(m0, bm0);
          const float c1 = __fadd_rn(m1, bm1);
          pick[h] = has && c1 > c0;  // the first maximum, as jnp.argmax
          nm[h] = pick[h] ? c1 : c0;
          if (has) key = max(key, key_of(nm[h]));
        }
        mx = float_of(__reduce_max_sync(kFull, key));
        const unsigned lo = __ballot_sync(kFull, pick[0]);
        const unsigned hi = kTwo ? __ballot_sync(kFull, pick[H - 1]) : 0u;
        if (lane == k) {
          w_lo = lo;
          w_hi = hi;
        }
      }
      if (lane < kn) ch[t0 + i0 + lane] = make_uint2(w_lo, w_hi);
      __syncwarp();
    }
  }

  // final metrics; the traceback starts at their first maximum
  int key[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float fm = __fsub_rn(nm[h], mx);
    if (has) metrics_out[row * S + lane + kWarp * h] = fm;
    key[h] = has ? key_of(fm) : INT_MIN;
  }
  const int best = __reduce_max_sync(kFull, max(key[0], key[H - 1]));
  const unsigned at0 = __ballot_sync(kFull, key[0] == best);
  const unsigned at1 = __ballot_sync(kFull, kTwo && key[H - 1] == best);
  int state = at0 ? __ffs(at0) - 1 : kWarp + __ffs(at1) - 1;

  // traceback: chunk [lo, hi) on this lane, the newest on top_lane
  const long long L = (n + kWarp - 1) / kWarp;
  const long long lo = lane * L, hi = (lo + L < n) ? lo + L : n;
  const int top_lane = (int)((n - 1) / L);
  int start = state;  // this lane's state at step hi - 1
  int below = 0;      // and at step lo - 1, its chunk walked
  if (lo < n) {
    if (lane != top_lane) {
      const long long from = hi - 1 + kWarmup;
      start = from < n - 1 ? walk_back<false>(ch, br, from, hi, 0, S - 1,
                                              top_shift)
                           : walk_back<false>(ch, br, n - 1, hi, state,
                                              S - 1, top_shift);
    }
    below = walk_back<true>(ch, br, hi - 1, lo, start, S - 1, top_shift);
  }
  // a start that differs from the state the lane above left is walked
  // again, newest chunk first (each rewalk can change the next check)
  const int next = __shfl_down_sync(kFull, below, 1);
  if (__ballot_sync(kFull, lane < top_lane && start != next)) {
    for (int l = top_lane - 1; l >= 0; --l) {
      const int above = __shfl_sync(kFull, below, l + 1);
      const bool again = lane == l && start != above;
      if (again)
        below = walk_back<true>(ch, br, hi - 1, lo, above, S - 1, top_shift);
    }
  }
}

}  // namespace

// ``sym``: (rows, n, R) float32 soft symbols (positive = bit 0);
// ``exp_prev``: (S, 2, R) float32, the expected symbols of the two
// branches into each state; ``choices``: (rows, n) scratch of 8 bytes a
// step; ``bits``: (rows, n) bytes; ``metrics``: (rows, S) float32.
// S = 2^(K-1) <= 64, R in {2, 3, 4}.
template <int R>
static void launch(const void* sym, const void* exp_prev, void* choices,
                   void* bits, void* metrics, long long rows, long long n,
                   int K, cudaStream_t stream) {
  const auto* s = static_cast<const float*>(sym);
  const auto* e = static_cast<const float*>(exp_prev);
  auto* c = static_cast<uint2*>(choices);
  auto* b = static_cast<unsigned char*>(bits);
  auto* m = static_cast<float*>(metrics);
  if (K == 7)
    viterbi_kernel<R, true><<<(unsigned)rows, kWarp, 0, stream>>>(
        s, e, c, b, m, n, 64, 5);
  else
    viterbi_kernel<R, false><<<(unsigned)rows, kWarp, 0, stream>>>(
        s, e, c, b, m, n, 1 << (K - 1), K - 2);
}

extern "C" int viterbi_decode_launch(const void* sym, const void* exp_prev,
                                     void* choices, void* bits, void* metrics,
                                     long long rows, long long n, int K,
                                     int R, void* stream) {
  if (K < 2 || K > 7) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  switch (R) {
    case 2:
      launch<2>(sym, exp_prev, choices, bits, metrics, rows, n, K, st);
      break;
    case 3:
      launch<3>(sym, exp_prev, choices, bits, metrics, rows, n, K, st);
      break;
    case 4:
      launch<4>(sym, exp_prev, choices, bits, metrics, rows, n, K, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
