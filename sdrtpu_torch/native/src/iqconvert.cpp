// High-throughput IQ format conversion (native ingest edge).
//
// The reference's ingest path does int->float conversion with VOLK SIMD
// kernels on a worker thread (e.g. file_source/src/main.cpp:154-181,
// network_source).  This library is the equivalent for sdrtpu_torch's host
// edge: interleaved wire formats (u8/i8/i16/i32/f32) to planar float32 I/Q
// and back.  Plain C loops written to
// autovectorize under -O3; no external dependencies.

#include <cstdint>
#include <cstring>

extern "C" {

// interleaved signed/unsigned ints -> planar float32 (re, im), scaled to ~[-1, 1)
void iq_u8_to_planar_f32(const uint8_t* in, float* re, float* im, int64_t n) {
    const float s = 1.0f / 128.0f;
    for (int64_t i = 0; i < n; i++) {
        re[i] = ((float)in[2 * i] - 128.0f) * s;
        im[i] = ((float)in[2 * i + 1] - 128.0f) * s;
    }
}

void iq_i8_to_planar_f32(const int8_t* in, float* re, float* im, int64_t n) {
    const float s = 1.0f / 128.0f;
    for (int64_t i = 0; i < n; i++) {
        re[i] = (float)in[2 * i] * s;
        im[i] = (float)in[2 * i + 1] * s;
    }
}

void iq_i16_to_planar_f32(const int16_t* in, float* re, float* im, int64_t n) {
    const float s = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; i++) {
        re[i] = (float)in[2 * i] * s;
        im[i] = (float)in[2 * i + 1] * s;
    }
}

void iq_i32_to_planar_f32(const int32_t* in, float* re, float* im, int64_t n) {
    const float s = 1.0f / 2147483648.0f;
    for (int64_t i = 0; i < n; i++) {
        re[i] = (float)in[2 * i] * s;
        im[i] = (float)in[2 * i + 1] * s;
    }
}

void iq_f32_to_planar_f32(const float* in, float* re, float* im, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        re[i] = in[2 * i];
        im[i] = in[2 * i + 1];
    }
}

// planar float32 -> interleaved wire formats (with clipping)
static inline float clipf(float v, float lo, float hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

void planar_f32_to_iq_i8(const float* re, const float* im, int8_t* out, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        out[2 * i] = (int8_t)clipf(re[i] * 128.0f, -128.0f, 127.0f);
        out[2 * i + 1] = (int8_t)clipf(im[i] * 128.0f, -128.0f, 127.0f);
    }
}

void planar_f32_to_iq_i16(const float* re, const float* im, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        out[2 * i] = (int16_t)clipf(re[i] * 32768.0f, -32768.0f, 32767.0f);
        out[2 * i + 1] = (int16_t)clipf(im[i] * 32768.0f, -32768.0f, 32767.0f);
    }
}

void planar_f32_to_iq_f32(const float* re, const float* im, float* out, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        out[2 * i] = re[i];
        out[2 * i + 1] = im[i];
    }
}

}  // extern "C"
