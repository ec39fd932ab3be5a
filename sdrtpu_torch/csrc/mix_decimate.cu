// Fused multi-channel mix + decimate (K2), for Hopper.
//
// Replaces sdrtpu/kernels/pallas_channelizer.py `_kernel` / `_run` (the
// Pallas TPU kernel).  For each channel c, with ext = tail(T-1) ++ x:
//
//     y[c, j] = sum_t ext[jM + t] * rot_c(jM + t) * h[t],   j < n/M
//     rot_c(e) = (coarse[c, e/1024] * e^{i phase[c]}) * fine[c, e%1024]
//
// complex64 (float2) in and out, every sum in plain fp32 FFMA (no TF32,
// no tensor cores: one reduced-precision pass is what broke the
// reference's SINAD floors, and the work is far too thin for them).
//
// What bounds it: instruction throughput, not bytes.  At the 8-VFO
// flagship (n=500000, C=8, M=8, T=36) one launch moves 8.1 MB (2.4 us at
// 3.35 TB/s), but a kernel that mixes every input sample for every channel
// (two complex products, a table load and index arithmetic per sample
// and channel) and then runs a load-bound FIR executes 6.5-7.7 M
// warp-instructions, 8 us or more on 132 SMs x 4 schedulers: it took
// 15.7 us there (NVIDIA H100 80GB HBM3, 700 W; so every time in this
// note).  The design below executes about a third of that and takes 7.8
// us, and 0.139 ms instead of 0.458 at 64 channels over 2.5 M samples:
//
// 1. Rotation at the outputs.  The tables are those of a rotation,
//    coarse[c, g] = e^{i w_c (1024 g - halo)} and fine[c, r] = e^{i w_c r},
//    so rot_c(jM + t) = rot_c(jM) * fine[c, t] for t < T <= 40, and
//
//        y[c, j] = rot_c(jM) * sum_t ext[jM + t] * g_c[t],
//        g_c[t] = h[t] * fine[c, t].
//
//    g is formed once per CTA in shared memory from the tables the kernel
//    already receives; one table product per output replaces M per
//    output and the mix pass is gone.  The FIR is complex by complex (4
//    FFMA per tap).  No angle of a sample index is ever formed in
//    float32; the carried phase rotates the coarse row in float32 as the
//    reference does.  The result differs from the per-sample rotation by
//    float32 rounding only (three table factors instead of two).
// 2. One raw ext window per tile, shared by the 8 channels of a CTA: the
//    window no longer depends on the channel.  With more than 8 channels
//    the channel group is the fastest grid index, so CTAs on one window
//    run together and ext comes from device memory once.
// 3. Each warp owns its tiles.  It copies a tile's window global ->
//    shared with 8-byte cp.async (the window starts halo = T-1 samples
//    before the tile, so it is 8- but not 16-byte aligned), zero-filled
//    past the block's end, into one of its two buffers: the next tile's
//    copy overlaps this tile's FIR, and a warp waits for its own copies
//    only (one CTA barrier, after the tables).  Neighbouring warps copy
//    the T-1 samples they share twice (14 % at 64 outputs a tile).  The
//    first window of a block straddles tail and x (two pointers, no
//    concatenated copy).
// 4. Register tiling.  A lane holds the complex accumulators of 8
//    channels x 2 or 4 outputs; per tap it loads one sample (8 bytes) per
//    output and g_c[t] of all 8 channels as four warp-broadcast 16-byte
//    loads, and runs 32 FFMA per output.  Taps run in chunks of 4,
//    fully unrolled (g is zero-padded to a multiple of 4 and the window
//    to the padded length, so a zero tap never meets uninitialised
//    memory).  Lane j reads ext[jM + t]: the window is stored linearly
//    with one pad slot after every M samples, index i -> i + i/M, so
//    that consecutive lanes are M+1 float2 apart; M+1 is odd, and a
//    half-warp's 8-byte loads then fall in 16 distinct bank pairs
//    (conflict-free for M = 2, 4, 8), while the cp.async stores stay
//    consecutive.
// 5. Grid sized to the card.  The outputs are cut into balanced
//    contiguous ranges, one per warp of a persistent CTA per (range,
//    channel group); the number of CTAs per SM (up to what fits) is the
//    largest whose idle lane slots stay within 5 % of the least, and all
//    CTAs are resident at once.  Two tile shapes are built: 256 threads x
//    2 outputs for a block that is a few tiles per warp (the flagship:
//    132 CTAs, one per SM, one tile per warp), and, for M = 8, 128
//    threads x 4 outputs for one of 8 tiles per warp or more (64
//    channels: 264 CTAs, two per SM, 19 tiles per warp), where the FIR
//    loop is all that matters and four outputs share each load of g.
//
// What is left: the FIR loop is bound by its shared-memory loads, not by
// the FFMA rate.  This loop's load pattern alone, timed without the rest
// of the kernel, reaches about 47 (2 outputs) and 50 TFLOP/s (4 outputs)
// where plain FFMA reach 64; the 64 bytes of g per tap are what costs.
// See PERF.md.
//
// The C entry points take raw pointers and the stream, launch on that
// stream, do not synchronise or allocate, and return a cudaError_t
// (cudaErrorInvalidConfiguration for an unsupported plan).

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 1024;
constexpr int kCh = 8;       // channels per CTA
constexpr int kMaxT = 40;    // T <= M + 32 <= 40
constexpr int kChunk = 4;    // taps per unrolled chunk
constexpr int kLongTiles = 8;  // tiles per warp that take the second shape
constexpr int kMaxDevices = 64;

// a tile shape: threads per CTA, outputs per lane
template <int THREADS, int OUT>
struct Shape {
  static constexpr int kThreads = THREADS;
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kOut = OUT;
  static constexpr int kTile = 32 * OUT;  // outputs per warp tile
};
using ShapeA = Shape<256, 2>;  // a block of a few tiles per warp
using ShapeB = Shape<128, 4>;  // a long block (M = 8 only)

template <int M>
__host__ __device__ constexpr int padded(int i) { return i + i / M; }

// one warp's window buffer, in float2: its last output's padded taps included
template <int M, class S>
__host__ __device__ constexpr int buf_len() {
  return padded<M>((S::kTile - 1) * M + kMaxT - 1) + 1;
}

// coarse rows the outputs of one warp tile can touch
template <int M, class S>
__host__ __device__ constexpr int tile_rows() {
  return S::kTile * M / kRow + 2;
}

template <int M, class S>
constexpr int smem_bytes() {
  return S::kWarps * 2 * buf_len<M, S>() * (int)sizeof(float2);
}

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 8 : 0;  // 0: nothing is read, zeros are stored
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc += s * g, complex
__device__ __forceinline__ void cmac(float2& acc, float2 s, float gx,
                                     float gy) {
  acc.x = fmaf(s.x, gx, acc.x);
  acc.x = fmaf(-s.y, gy, acc.x);
  acc.y = fmaf(s.x, gy, acc.y);
  acc.y = fmaf(s.y, gx, acc.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

template <int M, class S>
__global__ void __launch_bounds__(S::kThreads)
    mix_decimate_kernel(const float2* __restrict__ tail,
                        const float2* __restrict__ x,
                        const float2* __restrict__ coarse,
                        const float2* __restrict__ fine,
                        const float* __restrict__ taps,
                        const float* __restrict__ phase,
                        float2* __restrict__ out, long long n, int halo,
                        int rows, int C, int T, int n_groups, int n_ranges) {
  constexpr int kThreads = S::kThreads, kWarps = S::kWarps;
  constexpr int kOut = S::kOut, kTile = S::kTile;
  constexpr int kP = M + 1;
  constexpr int kBuf = buf_len<M, S>();
  constexpr int kRows = tile_rows<M, S>();
  constexpr int kLanes = kRow / M;  // fine lanes an output can hit
  static_assert(kCh * kRows <= 32, "one lane per coarse entry");
  extern __shared__ float2 windows[];           // two buffers per warp
  __shared__ float4 g4[kMaxT * kCh / 2];        // g[t][c], two channels each
  __shared__ float2 fout[kCh][kLanes];          // fine[c, lM]
  __shared__ float2 crows[kWarps][kCh][kRows];  // coarse * e^{i phase}

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int grp = blockIdx.x % n_groups;
  const int c0 = grp * kCh;
  const int nch = min(kCh, C - c0);
  const long long n_out = n / M;
  // this warp's outputs: one of n_ranges * kWarps balanced ranges
  const long long wid = (long long)(blockIdx.x / n_groups) * kWarps + warp;
  const long long n_wranges = (long long)n_ranges * kWarps;
  const long long lo = n_out * wid / n_wranges;
  const long long hi = n_out * (wid + 1) / n_wranges;
  const int n_tiles = (int)((hi - lo + kTile - 1) / kTile);
  const int Tp = (T + kChunk - 1) / kChunk * kChunk;
  float2* win = windows + warp * 2 * kBuf;
  float2(*crow)[kRows] = crows[warp];

  // window of tile `it` into buffer `b`: ext[j0*M, j0*M + span), padded
  auto load = [&](int it, int b) {
    const long long j0 = lo + (long long)it * kTile;
    const long long s0 = j0 * M - halo;  // the window's first sample, in x
    const int cnt = (int)min((long long)kTile, hi - j0);
    const int span = (cnt - 1) * M + Tp;
    float2* dst = win + b * kBuf;
    if (s0 >= 0 && s0 + span <= n) {  // inside the block
      const float2* src = x + s0;
      for (int el = lane; el < span; el += 32) {
        cp_async8(dst + padded<M>(el), src + el, true);
      }
    } else {  // over the tail, or past the block's end (zeros)
      for (int el = lane; el < span; el += 32) {
        const long long sidx = s0 + el;
        const float2* src = x;
        if (sidx < 0) {
          src = tail + (sidx + halo);
        } else if (sidx < n) {
          src = x + sidx;
        }
        cp_async8(dst + padded<M>(el), src, sidx < n);
      }
    }
  };

  // This lane's entry (c, r) of the coarse rows of tile `it`; rotated
  // by the phase when it is stored (the reference's float32 rotation).
  const int my_c = lane / kRows, my_r = lane % kRows;
  const bool crow_lane = lane < kCh * kRows && my_c < nch;
  auto coarse_entry = [&](int it) {
    const long long g = (((lo + (long long)it * kTile) * M) >> 10) + my_r;
    if (!crow_lane || g >= rows) return make_float2(0.f, 0.f);
    return coarse[(long long)(c0 + my_c) * rows + g];
  };

  // First the copies, then every other global load, and only then what
  // depends on them: one memory latency in all, beside the copies'.
  for (int i = tid; i < kCh * kLanes; i += kThreads) {
    const int c = i / kLanes, l = i % kLanes;
    const bool valid = c < nch;
    cp_async8(&fout[c][l],
              fine + (valid ? (long long)(c0 + c) * kRow + l * M : 0), valid);
  }
  cp_async_commit();
  if (n_tiles > 0) load(0, 0);
  cp_async_commit();
  // g_c[t] = h[t] * fine[c, t]; zero for padded taps and absent channels
  constexpr int kGPer = (kMaxT * kCh + kThreads - 1) / kThreads;
  float gh[kGPer];
  float2 gf[kGPer];
#pragma unroll
  for (int q = 0; q < kGPer; ++q) {
    const int i = tid + q * kThreads;
    const int t = i / kCh, c = i % kCh;
    const bool live = t < T && c < nch;
    gh[q] = live ? taps[t] : 0.f;
    gf[q] = live ? fine[(long long)(c0 + c) * kRow + t] : make_float2(0.f, 0.f);
  }
  const float my_phase = crow_lane ? phase[c0 + my_c] : 0.f;
  const float2 crow_first = coarse_entry(0);
#pragma unroll
  for (int q = 0; q < kGPer; ++q) {
    const int i = tid + q * kThreads;
    if (i < kMaxT * kCh) {
      reinterpret_cast<float2*>(g4)[i] =
          make_float2(gh[q] * gf[q].x, gh[q] * gf[q].y);
    }
  }
  float2 my_cs;  // cos, sin of the carried phase
  sincosf(my_phase, &my_cs.y, &my_cs.x);
  if (lane < kCh * kRows) crow[my_c][my_r] = cmul(crow_first, my_cs);
  cp_async_wait<1>();  // fout; the first window may be in flight
  __syncthreads();     // g4 and fout are in place: the CTA's only barrier

  for (int it = 0; it < n_tiles; ++it) {
    const long long j0 = lo + (long long)it * kTile;
    const long long row0 = (j0 * M) >> 10;
    if (it + 1 < n_tiles) load(it + 1, (it + 1) & 1);
    cp_async_commit();
    // the next tile's coarse rows: loaded now, stored after this tile
    const float2 crow_next =
        it + 1 < n_tiles ? coarse_entry(it + 1) : make_float2(0.f, 0.f);
    cp_async_wait<1>();  // this tile's window; the next may be in flight
    __syncwarp();        // the window and crow are in place

    if (j0 + lane < hi) {
      float2 acc[kOut][kCh];
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
#pragma unroll
        for (int c = 0; c < kCh; ++c) acc[o][c] = make_float2(0.f, 0.f);
      }
      const float2* w = win + (it & 1) * kBuf + lane * kP;
#pragma unroll 2
      for (int tb = 0; tb < Tp; tb += kChunk) {
        // padded(jM + tb + v) = j(M+1) + padded(tb) + padded(v), v < 4
        const float2* wu = w + padded<M>(tb);
        const float4* gu = g4 + tb * (kCh / 2);
#pragma unroll
        for (int v = 0; v < kChunk; ++v) {
          float4 g[kCh / 2];
#pragma unroll
          for (int k = 0; k < kCh / 2; ++k) g[k] = gu[v * (kCh / 2) + k];
#pragma unroll
          for (int o = 0; o < kOut; ++o) {
            const float2 s = wu[o * 32 * kP + padded<M>(v)];
#pragma unroll
            for (int k = 0; k < kCh / 2; ++k) {
              cmac(acc[o][2 * k], s, g[k].x, g[k].y);
              cmac(acc[o][2 * k + 1], s, g[k].z, g[k].w);
            }
          }
        }
      }
      // one rotation per output, anchored at ext index jM
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const long long j = j0 + lane + o * 32;
        if (j < hi) {
          const int r = (int)(((j * M) >> 10) - row0);
          const int fl = (int)(j & (kLanes - 1));
          float2* po = out + (long long)c0 * n_out + j;
          if (nch == kCh) {  // no test per channel: the stores go out together
#pragma unroll
            for (int c = 0; c < kCh; ++c) {
              po[c * n_out] = cmul(cmul(crow[c][r], fout[c][fl]), acc[o][c]);
            }
          } else {
#pragma unroll
            for (int c = 0; c < kCh; ++c) {
              if (c < nch) {
                po[c * n_out] = cmul(cmul(crow[c][r], fout[c][fl]), acc[o][c]);
              }
            }
          }
        }
      }
    }
    __syncwarp();  // the buffer and crow are rewritten next
    if (lane < kCh * kRows) crow[my_c][my_r] = cmul(crow_next, my_cs);
  }
}

struct Plan {
  int groups, ranges, tiles_per_warp, per_sm;
};

// Ranges for k CTAs per SM: all CTAs resident at once.  The cost is the
// lane slots an SM spends, tiles per warp x CTAs per SM.
template <class S>
Plan plan_for(long long n_out, int C, int sms, int k) {
  Plan p;
  p.groups = (C + kCh - 1) / kCh;
  const long long half_cta = (long long)S::kTile * S::kWarps / 2;
  const long long most = (n_out + half_cta - 1) / half_cta;
  const long long r = max(1LL, min((long long)sms * k / p.groups, most));
  const long long len = (n_out + r * S::kWarps - 1) / (r * S::kWarps);
  p.ranges = (int)r;
  p.tiles_per_warp = (int)((len + S::kTile - 1) / S::kTile);
  p.per_sm = (int)((r * p.groups + sms - 1) / sms);
  return p;
}

// The most CTAs per SM whose cost is within 5 % of the least: a block
// that is one tile per warp takes the fewest CTAs that cover it, a long
// one fills the SMs with warps.
template <class S>
Plan make_plan(long long n_out, int C, int sms, int resident) {
  long long least = -1;
  for (int k = 1; k <= resident; ++k) {
    const Plan p = plan_for<S>(n_out, C, sms, k);
    const long long cost = (long long)p.tiles_per_warp * p.per_sm;
    if (least < 0 || cost < least) least = cost;
  }
  for (int k = resident; k > 1; --k) {
    const Plan p = plan_for<S>(n_out, C, sms, k);
    if ((long long)p.tiles_per_warp * p.per_sm * 20 <= least * 21) return p;
  }
  return plan_for<S>(n_out, C, sms, 1);
}

struct Args {
  const float2 *tail, *x, *coarse, *fine;
  const float *taps, *phase;
  float2* out;
  long long n;
  int halo, rows, C, T;
};

struct Card {
  int sms, resident;  // SMs; CTAs of this kernel that fit on one
};

// the card's SM count and this kernel's fit, read once per device
template <int M, class S>
cudaError_t card_for(Card* card) {
  static Card cards[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cards[dev].resident) {
    constexpr int smem = smem_bytes<M, S>();
    rc = cudaFuncSetAttribute(mix_decimate_kernel<M, S>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
    if (rc != cudaSuccess) return rc;
    int sms = 0, fit = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, mix_decimate_kernel<M, S>, S::kThreads, smem);
    if (rc != cudaSuccess) return rc;
    if (fit < 1 || sms < 1) return cudaErrorInvalidConfiguration;
    cards[dev].sms = sms;
    cards[dev].resident = fit;
  }
  *card = cards[dev];
  return cudaSuccess;
}

// launch with tile shape S, or only report the grid:
// report = {CTAs, SMs, CTAs that fit on one SM, channel groups, ranges,
//           tiles per warp, dynamic shared bytes, threads, outputs per lane}
template <int M, class S>
cudaError_t run_shape(const Args& a, const Card& card, const Plan& p,
                      cudaStream_t s, int* report) {
  constexpr int smem = smem_bytes<M, S>();
  const long long ctas = (long long)p.ranges * p.groups;
  if (ctas >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  if (report) {
    const int r[9] = {(int)ctas, card.sms,    card.resident,
                      p.groups,  p.ranges,    p.tiles_per_warp,
                      smem,      S::kThreads, S::kOut};
    for (int i = 0; i < 9; ++i) report[i] = r[i];
    return cudaSuccess;
  }
  mix_decimate_kernel<M, S><<<(unsigned)ctas, S::kThreads, smem, s>>>(
      a.tail, a.x, a.coarse, a.fine, a.taps, a.phase, a.out, a.n, a.halo,
      a.rows, a.C, a.T, p.groups, p.ranges);
  return cudaGetLastError();
}

// the second shape for a block that gives its warps kLongTiles tiles
// or more, else the first; the second is built for M = 8 only, the
// decimation of every first stage from 10 and 50 Msps (build time)
template <int M>
cudaError_t run(const Args& a, cudaStream_t s, int* report) {
  const long long n_out = a.n / M;
  Card card;
  cudaError_t rc;
  if constexpr (M == 8) {
    rc = card_for<M, ShapeB>(&card);
    if (rc != cudaSuccess) return rc;
    const Plan p = make_plan<ShapeB>(n_out, a.C, card.sms, card.resident);
    if (p.tiles_per_warp >= kLongTiles) {
      return run_shape<M, ShapeB>(a, card, p, s, report);
    }
  }
  rc = card_for<M, ShapeA>(&card);
  if (rc != cudaSuccess) return rc;
  const Plan p = make_plan<ShapeA>(n_out, a.C, card.sms, card.resident);
  return run_shape<M, ShapeA>(a, card, p, s, report);
}

cudaError_t dispatch(const Args& a, int M, cudaStream_t s, int* report) {
  if (a.T < 1 || a.T > kMaxT || a.halo != a.T - 1 || a.C < 1 || a.n < M ||
      a.n % M) {
    return cudaErrorInvalidConfiguration;
  }
  switch (M) {
    case 2:
      return run<2>(a, s, report);
    case 4:
      return run<4>(a, s, report);
    case 8:
      return run<8>(a, s, report);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

}  // namespace

extern "C" int mix_decimate_launch(const void* tail, const void* x,
                                   const void* coarse, const void* fine,
                                   const void* taps, const void* phase,
                                   void* out, long long n, int halo, int rows,
                                   int C, int M, int T, void* stream) {
  const Args a = {static_cast<const float2*>(tail),
                  static_cast<const float2*>(x),
                  static_cast<const float2*>(coarse),
                  static_cast<const float2*>(fine),
                  static_cast<const float*>(taps),
                  static_cast<const float*>(phase),
                  static_cast<float2*>(out),
                  n,
                  halo,
                  rows,
                  C,
                  T};
  return (int)dispatch(a, M, (cudaStream_t)stream, nullptr);
}

// The grid a launch of this plan would take on the current card, without
// launching: report[9] = {CTAs, SMs, CTAs that fit on one SM, channel
// groups, output ranges, tiles per warp, dynamic shared bytes, threads,
// outputs per lane}.
extern "C" int mix_decimate_plan(long long n, int C, int M, int T,
                                 int* report) {
  Args a = {};
  a.n = n;
  a.C = C;
  a.T = T;
  a.halo = T - 1;
  return (int)dispatch(a, M, nullptr, report);
}
