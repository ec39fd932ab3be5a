// One-pass overlap-save chunk builder in polyphase layout, for Hopper.
//
// Replaces sdrtpu/kernels/pallas_chunks.py `chunk_poly` (the Pallas TPU
// kernel).  Computes, for complex64 `ext` of length L,
//
//     ct[p, s, q] = ext[p*valid + q*R + s]    (0 past the end of ext)
//
// with ct of shape (P, R, nif), interleaved complex64 — the input layout
// of the length-nif cuFFT batch in FftDecimatorChain.  The TPU kernel
// wrote planar re/im because Mosaic has no complex type; this one moves
// 8-byte float2 elements.
//
// What bounds it: it is pure data movement, so memory.  Per 500k-sample
// block of the 8-VFO flagship plan (valid=4000, R=40, nif=128, P=125) it
// reads ~4.0 MB of ext and writes 125*40*128*8 B = 5.12 MB: ~2.7 us at
// the H100 SXM's 3.35 TB/s.  Per 2.5M-sample block of the 64-VFO plan
// (valid=20000, R=200, P=125) it reads ~20.0 MB and writes 25.6 MB:
// ~13.6 us.
//
// Design: for a fixed chunk p, ct[p] is the transpose of the row-major
// (nif, R) matrix that starts at ext[p*valid].  Each block transposes one
// 32x32 tile of it through shared memory: it reads 32 rows q of 32
// consecutive samples s (coalesced along s) and writes 32 rows s of 32
// consecutive q (coalesced along q), so every byte crosses device memory
// once each way.  The tile is padded by one float2 per row: a half-warp
// reading a column then hits 16 distinct bank pairs.  Ragged edges (R or
// nif not a multiple of 32, samples past L) are masked in the kernel;
// any (valid, R, nif, P) works, with no limit on nif relative to
// valid/R.  Offsets are 64-bit.
//
// The C entry point takes raw pointers and the stream, launches on that
// stream, does not synchronise or allocate, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // threads per block: kTile x kRows

__global__ void chunk_poly_kernel(const float2* __restrict__ ext,
                                  float2* __restrict__ out, long long L,
                                  long long valid, int R, int nif,
                                  int q_tiles) {
  __shared__ float2 tile[kTile][kTile + 1];

  const long long p = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kTile;
  const int s0 = blockIdx.y * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long base = p * valid;

  // load: tile[q - q0][s - s0] = ext[base + q*R + s]
  const int s_in = s0 + tx;
#pragma unroll
  for (int j = 0; j < kTile; j += kRows) {
    const int q = q0 + ty + j;
    float2 v = make_float2(0.f, 0.f);
    if (q < nif && s_in < R) {
      const long long g = base + (long long)q * R + s_in;
      if (g < L) v = ext[g];
    }
    tile[ty + j][tx] = v;
  }
  __syncthreads();

  // store: out[p, s, q] for s in [s0, s0+32), q in [q0, q0+32)
  const int q_out = q0 + tx;
  float2* dst = out + p * (long long)R * nif;
#pragma unroll
  for (int j = 0; j < kTile; j += kRows) {
    const int s = s0 + ty + j;
    if (s < R && q_out < nif) {
      dst[(long long)s * nif + q_out] = tile[tx][ty + j];
    }
  }
}

}  // namespace

extern "C" int chunk_poly_launch(const void* ext, void* out, long long L,
                                 long long valid, int R, int nif, int P,
                                 void* stream) {
  const int q_tiles = (nif + kTile - 1) / kTile;
  const int s_tiles = (R + kTile - 1) / kTile;
  const dim3 grid((unsigned)((long long)P * q_tiles), (unsigned)s_tiles);
  const dim3 block(kTile, kRows);
  chunk_poly_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(ext), static_cast<float2*>(out), L, valid,
      R, nif, q_tiles);
  return (int)cudaGetLastError();
}
