// Lock-free single-producer single-consumer byte ring buffer.
//
// Native equivalent of the reference's SampleFrameBuffer
// (core/src/dsp/buffer/frame_buffer.h): decouples a network/file reader
// thread from the device feeder without the reference's mutex+condvar
// rendezvous.  Busy-waiting is avoided by the Python side (it polls with
// a timeout); the native layer is pure atomics.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

struct SpscRing {
    uint8_t* data;
    int64_t capacity;  // power of two
    std::atomic<int64_t> head;  // write index (producer)
    std::atomic<int64_t> tail;  // read index (consumer)
};

extern "C" {

SpscRing* ring_create(int64_t capacity) {
    // round up to power of two
    int64_t cap = 1;
    while (cap < capacity) cap <<= 1;
    auto* r = new SpscRing();
    r->data = (uint8_t*)malloc(cap);
    if (!r->data) { delete r; return nullptr; }
    r->capacity = cap;
    r->head.store(0);
    r->tail.store(0);
    return r;
}

void ring_destroy(SpscRing* r) {
    if (!r) return;
    free(r->data);
    delete r;
}

int64_t ring_write_available(SpscRing* r) {
    return r->capacity - (r->head.load(std::memory_order_acquire) -
                          r->tail.load(std::memory_order_acquire));
}

int64_t ring_read_available(SpscRing* r) {
    return r->head.load(std::memory_order_acquire) -
           r->tail.load(std::memory_order_acquire);
}

// Returns bytes written (may be < len if full).
int64_t ring_write(SpscRing* r, const uint8_t* src, int64_t len) {
    int64_t head = r->head.load(std::memory_order_relaxed);
    int64_t tail = r->tail.load(std::memory_order_acquire);
    int64_t avail = r->capacity - (head - tail);
    if (len > avail) len = avail;
    int64_t mask = r->capacity - 1;
    int64_t idx = head & mask;
    int64_t first = len < (r->capacity - idx) ? len : (r->capacity - idx);
    memcpy(r->data + idx, src, first);
    if (len > first) memcpy(r->data, src + first, len - first);
    r->head.store(head + len, std::memory_order_release);
    return len;
}

// Returns bytes read (may be < len if empty).
int64_t ring_read(SpscRing* r, uint8_t* dst, int64_t len) {
    int64_t tail = r->tail.load(std::memory_order_relaxed);
    int64_t head = r->head.load(std::memory_order_acquire);
    int64_t avail = head - tail;
    if (len > avail) len = avail;
    int64_t mask = r->capacity - 1;
    int64_t idx = tail & mask;
    int64_t first = len < (r->capacity - idx) ? len : (r->capacity - idx);
    memcpy(dst, r->data + idx, first);
    if (len > first) memcpy(dst + first, r->data, len - first);
    r->tail.store(tail + len, std::memory_order_release);
    return len;
}

}  // extern "C"
