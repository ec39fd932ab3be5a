// Native socket ingest pump: reader thread -> SPSC ring.
//
// The reference's source modules each run a C++ worker thread that reads
// the device/socket and swaps buffers into the DSP stream
// (source_modules/network_source, rtl_tcp_source;
// core/src/dsp/buffer/frame_buffer.h decouples reader jitter).  This is
// the equivalent for sdrtpu_torch's host edge: a detached reader thread drains
// a connected socket fd into the lock-free ring (ringbuffer.cpp) with
// overrun accounting; Python fetches fixed-size blocks and converts them
// to planar f32 with the iqconvert kernels — no Python-thread GIL churn
// on the wire path.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <thread>

#include <unistd.h>
#include <sys/socket.h>

// opaque ring API from ringbuffer.cpp
struct SpscRing;
extern "C" {
SpscRing* ring_create(int64_t capacity);
void ring_destroy(SpscRing* r);
int64_t ring_write(SpscRing* r, const uint8_t* src, int64_t len);
int64_t ring_read(SpscRing* r, uint8_t* dst, int64_t len);
int64_t ring_read_available(SpscRing* r);
int64_t ring_write_available(SpscRing* r);
}

namespace {

struct IngestPump {
    int fd = -1;
    SpscRing* ring = nullptr;
    int64_t item_size = 1;  // bytes per IQ sample (wire format)
    std::thread reader;
    std::atomic<bool> stop{false};
    std::atomic<int64_t> total_bytes{0};
    std::atomic<int64_t> dropped_bytes{0};
    std::atomic<int> state{0};  // 0 running, 1 EOF, 2 error

    void run() {
        // The ring holds WHOLE wire samples only: recv() returns byte
        // counts at arbitrary boundaries, so a sub-sample remainder is
        // carried to the next recv instead of entering the ring, and any
        // overflow drop is a whole number of samples starting at a sample
        // boundary.  A misaligned write or drop would shift the
        // interleaved I/Q framing of every later byte in the stream.
        constexpr int64_t CHUNK = 256 * 1024;
        uint8_t* buf = new uint8_t[CHUNK];
        int64_t carry = 0;  // sub-sample bytes carried between recvs
        while (!stop.load(std::memory_order_relaxed)) {
            // recv at most the remaining buffer: carry can approach
            // item_size, so a fixed CHUNK-length recv at offset `carry`
            // would overflow the allocation for large wire samples
            ssize_t n = recv(fd, buf + carry, CHUNK - carry, 0);
            if (n == 0) { state.store(1); break; }
            if (n < 0) {
                if (stop.load()) break;
                if (errno == EINTR) continue;  // interrupted, not an error
                state.store(2);
                break;
            }
            total_bytes.fetch_add(n, std::memory_order_relaxed);
            int64_t total = carry + n;
            int64_t aligned = (total / item_size) * item_size;
            // live-source overflow policy: drop whole samples from the
            // chunk's tail and count them (SampleFrameBuffer drops whole
            // frames on full)
            int64_t space =
                (ring_write_available(ring) / item_size) * item_size;
            int64_t accept = aligned <= space ? aligned : space;
            if (accept > 0) ring_write(ring, buf, accept);
            if (accept < aligned) {
                dropped_bytes.fetch_add(aligned - accept,
                                        std::memory_order_relaxed);
            }
            carry = total - aligned;
            if (carry > 0) memmove(buf, buf + aligned, carry);
        }
        delete[] buf;
    }
};

}  // namespace

extern "C" {

// Takes ownership of `fd` (Python should socket.detach()).
// `item_size`: bytes per wire sample — drops stay sample-aligned.
IngestPump* pump_create(int fd, int64_t ring_capacity, int64_t item_size) {
    auto* p = new IngestPump();
    p->fd = fd;
    p->item_size = item_size > 0 ? item_size : 1;
    p->ring = ring_create(ring_capacity);
    if (!p->ring) {
        close(fd);  // we own it; don't leak on failure
        delete p;
        return nullptr;
    }
    p->reader = std::thread([p] { p->run(); });
    return p;
}

// Non-blocking: returns bytes copied into dst (<= len).
int64_t pump_read(IngestPump* p, uint8_t* dst, int64_t len) {
    return ring_read(p->ring, dst, len);
}

int64_t pump_available(IngestPump* p) { return ring_read_available(p->ring); }

// state: 0 running, 1 clean EOF, 2 socket error
int pump_state(IngestPump* p) { return p->state.load(); }
int64_t pump_total_bytes(IngestPump* p) { return p->total_bytes.load(); }
int64_t pump_dropped_bytes(IngestPump* p) { return p->dropped_bytes.load(); }

void pump_destroy(IngestPump* p) {
    if (!p) return;
    p->stop.store(true);
    shutdown(p->fd, SHUT_RDWR);  // unblock recv()
    if (p->reader.joinable()) p->reader.join();
    close(p->fd);
    ring_destroy(p->ring);
    delete p;
}

}  // extern "C"
