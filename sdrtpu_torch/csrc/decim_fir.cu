// One stage of a strided decimating FIR as one launch, for Hopper.
//
// Replaces no TPU kernel.  In sdrtpu a decimating stage
// (sdrtpu/kernels/fir.py `DecimatingFir`, through `correlate_valid`) is a
// shift-and-add over the taps that XLA fuses into one program.  In eager
// PyTorch the same sum is one `cat` of the tail and the block, then one
// multiply and one add a tap, each a kernel that reads a strided slice of
// the block: a 30-tap decimate-by-8 stage over a 2 000 000-sample block is
// 60 launches that read the block about 30 times, and the mixed receiver's
// per-VFO DDCs (apps/receiver.py `Vfo`: `RationalResampler` ->
// `IntegerDecimator`) run 13 such stages a block.  Here a stage is one
// launch that reads each input sample once.  It computes
//
//     y[r, i]        = sum_t ext[r, i*M + t] * h[t]     (i < A)
//     tail_out[r, k] = ext[r, n + k]                    (k < T - 1)
//
// with ext = tail ++ x (the row's T - 1 carried samples, then its n new
// ones), x complex64 (float2) or float32 with any number of rows, a stride
// M >= 1 and T >= 1 real float32 taps.  tail_out, the last T - 1 samples of
// ext, is the stage's next state, written here so that no launch copies it
// and no state aliases the caller's block.  The sum runs in tap order with
// every product and every sum rounded on its own (__fmul_rn, __fadd_rn: no
// FMA contraction), as the shift-and-add's one PyTorch kernel a product
// and one a sum do: the result is the same to the bit.
//
// What bounds it: bytes.  The receiver's first stage (decimate by 8, 30
// taps, 2 000 000 complex64 samples) reads 16 MB and writes 2 MB, 5.4 us
// at the H100 SXM's 3.35 TB/s; its 30 taps cost 120 flops an output,
// 30 MFLOP in all.  The later stages move a few hundred KB or less and
// are bound by the launch.
//
// Design: a block owns `ob` consecutive outputs of one row.  It stages the
// (ob - 1)*M + T input samples they read in shared memory, loaded
// coalesced (8-byte loads for complex64, four in flight a thread), the
// tail and the block read through their own pointers.  The tile is kept
// in polyphase order, sample j at [j % M][j / M]: output k's tap t reads
// [t % M][k + t / M], so the 32 outputs of a warp read 32 consecutive
// entries of one phase row (no bank conflict), where in sample order they
// would lie M samples apart.  The taps sit behind the tile and are read
// as a broadcast.  One thread an output.  The wrapper plans `ob` (256 at
// most), the phase row's length `qw` and the shared bytes
// (kernels/fir.py `decim_fir_plan`) so that the tile fits 48 KB, or, for
// a tap count too long for that, the card's 227 KB of dynamic shared
// memory.  Offsets are 64-bit.
//
// The C entry point takes raw pointers and the stream, launches on that
// stream, does not synchronise or allocate, and returns the first
// nonzero cudaError_t (or 0) so the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoadBatch = 4;   // loads in flight a thread while staging
constexpr int kStaticSmem = 48 * 1024;

__device__ __forceinline__ float2 fir_mul(float2 v, float h) {
  return make_float2(__fmul_rn(v.x, h), __fmul_rn(v.y, h));
}
__device__ __forceinline__ float fir_mul(float v, float h) {
  return __fmul_rn(v, h);
}
__device__ __forceinline__ float2 fir_add(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float fir_add(float a, float b) {
  return __fadd_rn(a, b);
}

// ext[g] of one row: the carried tail, then the block
template <typename E>
__device__ __forceinline__ E ext_at(const E* tail, const E* x, long long g,
                                    int tm1) {
  return g < tm1 ? tail[g] : x[g - tm1];
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
decim_fir_kernel(const E* __restrict__ tail, long long tail_rs,
                 const E* __restrict__ x, long long x_rs, long long n,
                 const float* __restrict__ h, int taps, int M,
                 E* __restrict__ y, long long A, E* __restrict__ tail_out,
                 int ob, int qw) {
  extern __shared__ __align__(16) unsigned char smem[];
  E* tile = reinterpret_cast<E*>(smem);
  float* hs = reinterpret_cast<float*>(tile + M * qw);

  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const int tm1 = taps - 1;
  const E* tr = tail + r * tail_rs;
  const E* xr = x + r * x_rs;

  if (blockIdx.x == 0) {
    E* to = tail_out + (long long)r * tm1;
    for (int k = tid; k < tm1; k += kThreads) to[k] = ext_at(tr, xr, n + k, tm1);
  }

  const long long i0 = (long long)blockIdx.x * ob;
  const int nout = (int)min((long long)ob, A - i0);
  const int span = (nout - 1) * M + taps;  // samples the block's outputs read
  const long long g0 = i0 * M;
  for (int t = tid; t < taps; t += kThreads) hs[t] = h[t];
  for (int j0 = tid; j0 < span; j0 += kThreads * kLoadBatch) {
    E v[kLoadBatch];
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int j = j0 + b * kThreads;
      if (j < span) v[b] = ext_at(tr, xr, g0 + j, tm1);
    }
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int j = j0 + b * kThreads;
      if (j < span) tile[(j % M) * qw + j / M] = v[b];
    }
  }
  __syncthreads();

  // tap t of output k is tile[(t % M) * qw + k + t / M]: one phase row on,
  // or back to row 0 and one column on after the last row
  const int wrap = (M - 1) * qw - 1;
  E* yr = y + r * A + i0;
  for (int k = tid; k < nout; k += kThreads) {
    E acc = fir_mul(tile[k], hs[0]);
    int p = 0;
    int idx = k;
    for (int t = 1; t < taps; ++t) {
      if (++p == M) {
        p = 0;
        idx -= wrap;
      } else {
        idx += qw;
      }
      acc = fir_add(acc, fir_mul(tile[idx], hs[t]));
    }
    yr[k] = acc;
  }
}

template <typename E>
int decim_fir_run(const void* tail, long long tail_rs, const void* x,
                  long long x_rs, long long n, const void* h, int taps, int M,
                  void* y, long long A, void* tail_out, int rows, int ob,
                  int qw, int smem, cudaStream_t stream) {
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        decim_fir_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((A + ob - 1) / ob), (unsigned)rows);
  decim_fir_kernel<E><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(tail), tail_rs, static_cast<const E*>(x), x_rs,
      n, static_cast<const float*>(h), taps, M, static_cast<E*>(y), A,
      static_cast<E*>(tail_out), ob, qw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decim_fir_launch(const void* tail, long long tail_rs,
                                const void* x, long long x_rs, long long n,
                                const void* h, int taps, int M, void* y,
                                long long A, void* tail_out, int rows,
                                int is_complex, int ob, int qw, int smem,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_complex) {
    return decim_fir_run<float2>(tail, tail_rs, x, x_rs, n, h, taps, M, y, A,
                                 tail_out, rows, ob, qw, smem, s);
  }
  return decim_fir_run<float>(tail, tail_rs, x, x_rs, n, h, taps, M, y, A,
                              tail_out, rows, ob, qw, smem, s);
}
