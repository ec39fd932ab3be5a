// Latency probe of the scan kernels: cycles per part of one step.
//
// A kernel built with -DSDRTPU_PROBE (`_build.load(name, probe=True)`)
// carries a `Probe` on the lane that walks the recurrence; built without
// it, the kernel carries a `NoProbe`, whose calls compile to nothing.
// `mark(part, v)` first stores ``v`` to a volatile shared-memory word (the
// store waits until ``v`` is in its register, so the part's latency, not
// only its issue, lands before the clock read), then reads clock64() and
// adds the cycles since the previous mark to ``part``'s counter.  Each
// mark costs a store and a clock read, and no two parts overlap as they
// do in the plain build, so the probe's sum per step is longer than the
// plain kernel's step: the table ranks the parts, it does not time the
// kernel.  At the end the lane adds its counters to the buffer that the
// library's `*_probe_target` entry was last given.

#pragma once

#include <cuda_runtime.h>

struct NoProbe {
  __device__ __forceinline__ void start() {}
  template <typename T>
  __device__ __forceinline__ void mark(int, T) {}
  __device__ __forceinline__ void count(int, long long) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

#ifdef SDRTPU_PROBE

template <int N>
struct Probe {
  volatile float* sink;  // one word of shared memory
  long long last;
  long long cyc[N];

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int k = 0; k < N; ++k) cyc[k] = 0;
    last = clock64();
  }
  __device__ __forceinline__ void wait(float v) { *sink = v; }
  __device__ __forceinline__ void wait(int v) { *sink = __int_as_float(v); }
  __device__ __forceinline__ void wait(unsigned v) {
    *sink = __uint_as_float(v);
  }
  __device__ __forceinline__ void wait(float2 v) {
    *sink = v.x;
    *sink = v.y;
  }
  template <typename T>
  __device__ __forceinline__ void mark(int part, T v) {
    wait(v);
    const long long t = clock64();
    cyc[part] += t - last;
    last = t;
  }
  // an event count (steps, tiles) kept beside the cycles
  __device__ __forceinline__ void count(int part, long long n) {
    cyc[part] += n;
  }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if (out == nullptr) return;
#pragma unroll
    for (int k = 0; k < N; ++k)
      atomicAdd(out + k, (unsigned long long)cyc[k]);
  }
};

// The entry points of a probe build: the part names (comma-separated,
// in counter order) and the device buffer of int64 counters, one a part,
// that the next launches add to; `SDRTPU_PROBE_OUT(prefix)` is that
// buffer (nullptr in a plain build), which the launch hands its kernel.
#define SDRTPU_PROBE_ENTRIES(prefix, names)                                \
  static unsigned long long* prefix##_probe_out = nullptr;                 \
  extern "C" const char* prefix##_probe_parts() { return names; }          \
  extern "C" void prefix##_probe_target(void* out) {                       \
    prefix##_probe_out = static_cast<unsigned long long*>(out);            \
  }
#define SDRTPU_PROBE_OUT(prefix) prefix##_probe_out

#else

#define SDRTPU_PROBE_ENTRIES(prefix, names)
#define SDRTPU_PROBE_OUT(prefix) nullptr

#endif
