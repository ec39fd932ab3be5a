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
// chain of ~200 cycles (a shared-memory read of the predecessors'
// metrics, two adds and a select, a 5-level warp-shuffle maximum, a
// subtract and a shared-memory write); the traceback is another chain of
// a few integer operations per step.  Bytes and operations are far below
// what the card moves in that time.  The design:
//
//   - one warp, two states per lane (state s on lane s % 32), metrics
//     double-buffered in shared memory; the soft symbols staged in tiles
//     of kSymTile steps (R * kSymTile floats) by all lanes;
//   - each step's decisions packed with __ballot_sync into two 32-bit
//     words (8 bytes a step, states 0-31 and 32-63) and stored to global
//     scratch by lane 0;
//   - the traceback: lane 0 walks the states back from the first-argmax
//     final state out of a shared-memory tile of decision words while the
//     other lanes stage the next (older) tile; a word's address depends
//     only on the step, never on the state.
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
// maximum over the states.  So kernel and plain PyTorch loop produce the
// same bits and final metrics; at R = 2 they are also the JAX package's
// (its einsum over two products has one order), at R = 3 and 4 whenever
// that einsum's order gives the same sums (always for DAB's +-1 and 0
// soft symbols).
//
// The C entry point takes raw pointers and the stream, launches on that
// stream, neither synchronises nor allocates (the decision scratch comes
// from the caller), and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxStates = 64;
constexpr int kSymTile = 1024;  // steps of soft symbols staged at a time
constexpr int kTbTile = 1024;   // steps of decision words per traceback tile

template <int R>
__global__ void viterbi_kernel(const float* __restrict__ sym,
                               const float* __restrict__ exp_prev,
                               uint2* __restrict__ choices,
                               unsigned char* __restrict__ bits,
                               float* __restrict__ metrics_out, long long n,
                               int S, int top_shift) {
  __shared__ float s_sym[R * kSymTile];
  __shared__ float s_m[2][kMaxStates];
  __shared__ uint2 s_ch[2][kTbTile];

  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  const float* sr = sym + row * n * R;
  uint2* ch = choices + row * n;
  unsigned char* br = bits + row * n;

  // this lane's states, their predecessors and expected symbols
  bool has[2];
  int pred[2];
  float e[2][2][R];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lane + kWarp * h;
    has[h] = s < S;
    pred[h] = (s << 1) & (S - 1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r)
        e[h][j][r] = has[h] ? exp_prev[(s * 2 + j) * R + r] : 0.f;
    if (has[h]) s_m[0][s] = (s == 0) ? 0.f : -1e9f;
  }
  __syncwarp();

  // add-compare-select
  int cur = 0;
  for (long long t0 = 0; t0 < n; t0 += kSymTile) {
    const int m = (int)((n - t0 < kSymTile) ? (n - t0) : kSymTile);
    for (int i = lane; i < R * m; i += kWarp) s_sym[i] = sr[R * t0 + i];
    __syncwarp();
    for (int i = 0; i < m; ++i) {
      float rs[R];
#pragma unroll
      for (int r = 0; r < R; ++r) rs[r] = s_sym[R * i + r];
      float nm[2];
      bool pick[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (has[h]) {
          float bm0 = __fmul_rn(rs[0], e[h][0][0]);
          float bm1 = __fmul_rn(rs[0], e[h][1][0]);
#pragma unroll
          for (int r = 1; r < R; ++r) {
            bm0 = __fadd_rn(bm0, __fmul_rn(rs[r], e[h][0][r]));
            bm1 = __fadd_rn(bm1, __fmul_rn(rs[r], e[h][1][r]));
          }
          const float c0 = __fadd_rn(s_m[cur][pred[h]], bm0);
          const float c1 = __fadd_rn(s_m[cur][pred[h] | 1], bm1);
          pick[h] = c1 > c0;  // the first maximum, as jnp.argmax
          nm[h] = pick[h] ? c1 : c0;
        } else {
          pick[h] = false;
          nm[h] = -INFINITY;
        }
      }
      float mx = fmaxf(nm[0], nm[1]);
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const unsigned lo = __ballot_sync(kFull, pick[0]);
      const unsigned hi = __ballot_sync(kFull, pick[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (has[h]) s_m[cur ^ 1][lane + kWarp * h] = __fsub_rn(nm[h], mx);
      if (lane == 0) ch[t0 + i] = make_uint2(lo, hi);
      cur ^= 1;
      __syncwarp();
    }
  }

  // final metrics; the traceback starts at their first maximum
  for (int s = lane; s < S; s += kWarp) metrics_out[row * S + s] = s_m[cur][s];
  int state = 0;
  if (lane == 0) {
    float best = s_m[cur][0];
    for (int s = 1; s < S; ++s)
      if (s_m[cur][s] > best) {
        best = s_m[cur][s];
        state = s;
      }
  }

  // traceback, newest tile first; lanes 1..31 stage the next tile
  long long hi = n;
  {
    const long long lo = hi > kTbTile ? hi - kTbTile : 0;
    for (long long i = lo + lane; i < hi; i += kWarp) s_ch[0][i - lo] = ch[i];
  }
  __syncwarp();
  int buf = 0;
  while (hi > 0) {
    const long long lo = hi > kTbTile ? hi - kTbTile : 0;
    const long long nlo = lo > kTbTile ? lo - kTbTile : 0;
    if (lane == 0) {
      for (long long i = hi - 1; i >= lo; --i) {
        const uint2 w = s_ch[buf][i - lo];
        const unsigned word = (state & 32) ? w.y : w.x;
        const int j = (word >> (state & 31)) & 1;
        br[i] = (unsigned char)(state >> top_shift);
        state = ((state << 1) | j) & (S - 1);
      }
    } else {
      for (long long i = nlo + lane - 1; i < lo; i += kWarp - 1)
        s_ch[buf ^ 1][i - nlo] = ch[i];
    }
    __syncwarp();
    buf ^= 1;
    hi = lo;
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
  viterbi_kernel<R><<<(unsigned)rows, kWarp, 0, stream>>>(
      static_cast<const float*>(sym), static_cast<const float*>(exp_prev),
      static_cast<uint2*>(choices), static_cast<unsigned char*>(bits),
      static_cast<float*>(metrics), n, 1 << (K - 1), K - 2);
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
