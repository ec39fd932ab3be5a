// Fused multi-channel mix + decimate (K2), for Hopper.
//
// Replaces sdrtpu/kernels/pallas_channelizer.py `_kernel` / `_run` (the
// Pallas TPU kernel).  For each channel c, with ext = tail(T-1) ++ x:
//
//     y[c, j] = sum_t ext[jM + t] * rot_c(jM + t) * h[t],   j < n/M
//     rot_c(e) = (coarse[c, e/1024] * e^{i phase[c]}) * fine[c, e%1024]
//
// complex64 (float2) in and out; the rotation comes only from the
// float32 host tables (no float32 angle of a large sample index is ever
// formed), the carried phase rotates the coarse row in float32 as the
// reference does, and every sum is plain fp32 FFMA (no TF32).
//
// What bounds it: at the 8-VFO flagship (n=500000, C=8, M=8, T=36) one
// launch reads ~4.0 MB of ext and writes 8 x 62500 x 8 B = 4.0 MB: ~2.4
// us at 3.35 TB/s, against ~0.12 GFLOP (~1.8 us of fp32 issue), so
// bytes.  At the 64-VFO plan (n=2.5M, C=64, T=31) the 160 MB write and
// ~4.4 GFLOP put it near the balance point.
//
// Design: the TPU kernel ran the FIR as a dense banded-Toeplitz matmul
// on the MXU (about 28 of every 29 terms multiply by zero); here it is a
// direct polyphase FIR.  Each CTA takes 256 consecutive outputs of 2
// channels.  It forms the mixed window (256*M + T - 1 samples) of both
// channels once, reading ext straight from tail and x (no concatenated
// copy), and stores it in shared memory in polyphase layout,
// mix[r][k] = mixed[k*M + r], so that thread j's taps t = q*M + r read
// mix[r][j + q]: consecutive threads, consecutive addresses.  The row
// pitch KW is = 32/M mod 16 (in float2), which spreads a warp's strided
// polyphase stores over all bank pairs.  Outputs past n/M are masked;
// offsets are 64-bit; the grid is one dimension of (output tile,
// channel pair) with the channel pair fastest, so CTAs that share an ext
// window run together and the re-reads hit L2.
//
// The C entry point takes raw pointers and the stream, launches on that
// stream, does not synchronise or allocate, and returns the launch's
// cudaError_t (cudaErrorInvalidConfiguration for an unsupported plan).

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 1024;
constexpr int kOut = 256;      // outputs per CTA = threads per CTA
constexpr int kChan = 2;       // channels per CTA
constexpr int kMaxT = 40;      // T <= M + 32 <= 40
constexpr int kMaxRows = 4;    // coarse rows one window can touch
constexpr int kMaxBuf = 8 * 276;  // M * KW at its largest (M=8, T<=40)

__host__ __device__ constexpr int row_pitch(int M, int T) {
  // >= kOut + ceil((T-1)/M) columns, = (32/M) mod 16
  const int need = kOut + (T - 1 + M - 1) / M;
  return (need + 15) / 16 * 16 + (32 / M) % 16;
}

template <int M>
__global__ void __launch_bounds__(kOut)
    mix_decimate_kernel(const float2* __restrict__ tail,
                        const float2* __restrict__ x,
                        const float2* __restrict__ coarse,
                        const float2* __restrict__ fine,
                        const float* __restrict__ taps,
                        const float* __restrict__ phase,
                        float2* __restrict__ out, long long n, int halo,
                        int rows, int C, int T, int n_pairs) {
  __shared__ float2 mix[kChan * kMaxBuf];
  __shared__ float2 crow[kChan][kMaxRows];
  __shared__ float h[kMaxT];

  const int tid = threadIdx.x;
  const int pair = blockIdx.x % n_pairs;
  const long long tile = blockIdx.x / n_pairs;
  const long long n_out = n / M;
  const long long j0 = tile * kOut;
  const long long e0 = j0 * M;
  const int c0 = pair * kChan;
  const int nch = min(kChan, C - c0);
  const int KW = row_pitch(M, T);
  const int span = kOut * M + T - 1;
  const long long row0 = e0 >> 10;

  if (tid < T) h[tid] = taps[tid];
  if (tid < kChan * kMaxRows) {
    const int ci = tid / kMaxRows;
    const long long g = row0 + tid % kMaxRows;
    float2 v = make_float2(0.f, 0.f);
    if (ci < nch && g < rows) {
      // the reference's float32 rotation of the coarse row by the phase
      float s, co;
      sincosf(phase[c0 + ci], &s, &co);
      const float2 cr = coarse[(long long)(c0 + ci) * rows + g];
      v = make_float2(cr.x * co - cr.y * s, cr.x * s + cr.y * co);
    }
    crow[ci][tid % kMaxRows] = v;
  }
  __syncthreads();

  // mixed window of both channels, in polyphase layout
  for (int el = tid; el < span; el += kOut) {
    const long long e = e0 + el;
    float2 v = make_float2(0.f, 0.f);
    if (e < halo) {
      v = tail[e];
    } else if (e - halo < n) {
      v = x[e - halo];
    }
    const int r = (int)((e >> 10) - row0);
    const int lane = (int)(e & (kRow - 1));
    float2* dst = mix + (el % M) * KW + el / M;
#pragma unroll
    for (int ci = 0; ci < kChan; ++ci) {
      if (ci < nch) {
        const float2 c = crow[ci][r];
        const float2 f = fine[(long long)(c0 + ci) * kRow + lane];
        const float rr = c.x * f.x - c.y * f.y;
        const float ri = c.x * f.y + c.y * f.x;
        dst[ci * kMaxBuf] = make_float2(v.x * rr - v.y * ri,
                                        v.x * ri + v.y * rr);
      }
    }
  }
  __syncthreads();

  const long long j = j0 + tid;
  if (j >= n_out) return;
#pragma unroll
  for (int ci = 0; ci < kChan; ++ci) {
    if (ci < nch) {
      const float2* src = mix + ci * kMaxBuf + tid;
      float ar = 0.f, ai = 0.f;
      for (int t = 0; t < T; ++t) {
        const float2 m = src[(t % M) * KW + t / M];
        ar = fmaf(m.x, h[t], ar);
        ai = fmaf(m.y, h[t], ai);
      }
      out[(long long)(c0 + ci) * n_out + j] = make_float2(ar, ai);
    }
  }
}

static_assert(8 * row_pitch(8, kMaxT) <= kMaxBuf, "M=8 window");
static_assert(4 * row_pitch(4, kMaxT) <= kMaxBuf, "M=4 window");
static_assert(2 * row_pitch(2, kMaxT) <= kMaxBuf, "M=2 window");

}  // namespace

extern "C" int mix_decimate_launch(const void* tail, const void* x,
                                   const void* coarse, const void* fine,
                                   const void* taps, const void* phase,
                                   void* out, long long n, int halo, int rows,
                                   int C, int M, int T, void* stream) {
  if (T < 1 || T > kMaxT || halo != T - 1 || C < 1 || n < M || n % M) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const int n_pairs = (C + kChan - 1) / kChan;
  const long long tiles = (n / M + kOut - 1) / kOut;
  if (tiles * n_pairs >= (1LL << 31)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)(tiles * n_pairs));
  const cudaStream_t s = (cudaStream_t)stream;
  const float2* t2 = static_cast<const float2*>(tail);
  const float2* x2 = static_cast<const float2*>(x);
  const float2* c2 = static_cast<const float2*>(coarse);
  const float2* f2 = static_cast<const float2*>(fine);
  const float* h = static_cast<const float*>(taps);
  const float* ph = static_cast<const float*>(phase);
  float2* o2 = static_cast<float2*>(out);
  switch (M) {
    case 2:
      mix_decimate_kernel<2><<<grid, kOut, 0, s>>>(t2, x2, c2, f2, h, ph, o2,
                                                   n, halo, rows, C, T,
                                                   n_pairs);
      break;
    case 4:
      mix_decimate_kernel<4><<<grid, kOut, 0, s>>>(t2, x2, c2, f2, h, ph, o2,
                                                   n, halo, rows, C, T,
                                                   n_pairs);
      break;
    case 8:
      mix_decimate_kernel<8><<<grid, kOut, 0, s>>>(t2, x2, c2, f2, h, ph, o2,
                                                   n, halo, rows, C, T,
                                                   n_pairs);
      break;
    default:
      return (int)cudaErrorInvalidConfiguration;
  }
  return (int)cudaGetLastError();
}
