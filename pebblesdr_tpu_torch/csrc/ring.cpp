// Host runtime of pebblesdr_tpu_torch: IQ ring buffer, wire-format decode
// and the UDP pump.  A copy of the JAX package's runtime/ring.cpp.
//
// Capability parity with the reference's C++ runtime layer:
//   * ProducerConsumer (pebblelib/producerconsumer.{h,cpp}): N fixed-size
//     buffers cycled between a producer thread (device/socket IO) and a
//     consumer (the DSP chain feeder), free/filled semaphores, overrun
//     accounting.  Here: std::mutex + condition_variable ring exposed
//     through a C ABI for ctypes.
//   * DeviceInterfaceBase::normalizeIQ (pebblelib/deviceinterfacebase.h:
//     105-117) wire formats: interleaved u8/i8/u16/i16/f32 -> deinterleaved
//     float32 re/im planes, with optional I/Q swap -- the host-side hot
//     path of the input pipeline.
//
// Built at first use by pebblesdr_tpu_torch/kernels/build.py (build_host:
// g++ -O3 -std=c++17 -fPIC -shared -pthread, no -march=native) into
// build/kernels/libring_<hash>.so; pebblesdr_tpu_torch/runtime binds it.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Ring {
    size_t n_buffers;
    size_t buf_bytes;
    std::vector<std::vector<uint8_t>> buffers;
    // indices into `buffers`; [tail, head) are filled
    size_t head = 0;   // next write slot
    size_t tail = 0;   // next read slot
    size_t filled = 0;
    uint64_t overruns = 0;
    uint64_t produced = 0;
    uint64_t consumed = 0;
    bool write_held = false;
    bool read_held = false;
    std::mutex mu;
    std::condition_variable cv_free;
    std::condition_variable cv_filled;
};

}  // namespace

extern "C" {

Ring* ring_create(size_t n_buffers, size_t buf_bytes) {
    Ring* r = new Ring();
    r->n_buffers = n_buffers;
    r->buf_bytes = buf_bytes;
    r->buffers.resize(n_buffers);
    for (auto& b : r->buffers) b.resize(buf_bytes);
    return r;
}

void ring_destroy(Ring* r) { delete r; }

// Producer: get a pointer to the next free buffer.  timeout_ms < 0 blocks
// forever; on timeout with drop_oldest != 0, the oldest filled buffer is
// dropped (overrun semantics of the reference's POLL mode) and its slot
// reused.  Returns nullptr on timeout without drop.
void* ring_acquire_write(Ring* r, int timeout_ms, int drop_oldest) {
    std::unique_lock<std::mutex> lk(r->mu);
    auto free_slot = [&] { return r->filled < r->n_buffers && !r->write_held; };
    if (timeout_ms < 0) {
        r->cv_free.wait(lk, free_slot);
    } else if (!r->cv_free.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                    free_slot)) {
        if (!drop_oldest || r->read_held) return nullptr;
        // drop oldest filled
        r->tail = (r->tail + 1) % r->n_buffers;
        r->filled--;
        r->overruns++;
    }
    r->write_held = true;
    return r->buffers[r->head].data();
}

void ring_commit_write(Ring* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    if (!r->write_held) return;
    r->write_held = false;
    r->head = (r->head + 1) % r->n_buffers;
    r->filled++;
    r->produced++;
    r->cv_filled.notify_one();
}

void* ring_acquire_read(Ring* r, int timeout_ms) {
    std::unique_lock<std::mutex> lk(r->mu);
    auto have = [&] { return r->filled > 0 && !r->read_held; };
    if (timeout_ms < 0) {
        r->cv_filled.wait(lk, have);
    } else if (!r->cv_filled.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                      have)) {
        return nullptr;
    }
    r->read_held = true;
    return r->buffers[r->tail].data();
}

void ring_release_read(Ring* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    if (!r->read_held) return;
    r->read_held = false;
    r->tail = (r->tail + 1) % r->n_buffers;
    r->filled--;
    r->consumed++;
    r->cv_free.notify_one();
}

size_t ring_filled(Ring* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    return r->filled;
}

uint64_t ring_overruns(Ring* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    return r->overruns;
}

// ---------------------------------------------------------------- decode
// Interleaved wire formats -> deinterleaved float32 re/im planes.
// n = number of complex samples.  swap_iq exchanges the I/Q order.

#define DECODE_LOOP(READ_I, READ_Q)            \
    if (swap_iq) {                             \
        for (size_t k = 0; k < n; ++k) {       \
            re[k] = (READ_Q);                  \
            im[k] = (READ_I);                  \
        }                                      \
    } else {                                   \
        for (size_t k = 0; k < n; ++k) {       \
            re[k] = (READ_I);                  \
            im[k] = (READ_Q);                  \
        }                                      \
    }

void decode_u8(const uint8_t* in, size_t n, float* re, float* im, int swap_iq) {
    constexpr float s = 1.0f / 128.0f;
    DECODE_LOOP((in[2 * k] - 128.0f) * s, (in[2 * k + 1] - 128.0f) * s)
}

void decode_i8(const int8_t* in, size_t n, float* re, float* im, int swap_iq) {
    constexpr float s = 1.0f / 128.0f;
    DECODE_LOOP(in[2 * k] * s, in[2 * k + 1] * s)
}

void decode_i16(const int16_t* in, size_t n, float* re, float* im, int swap_iq) {
    constexpr float s = 1.0f / 32768.0f;
    DECODE_LOOP(in[2 * k] * s, in[2 * k + 1] * s)
}

void decode_u16(const uint16_t* in, size_t n, float* re, float* im, int swap_iq) {
    constexpr float s = 1.0f / 32768.0f;
    DECODE_LOOP((in[2 * k] - 32768.0f) * s, (in[2 * k + 1] - 32768.0f) * s)
}

void decode_f32(const float* in, size_t n, float* re, float* im, int swap_iq) {
    DECODE_LOOP(in[2 * k], in[2 * k + 1])
}

// i16 PASSTHROUGH deinterleave: int16 wire -> int16 re/im planes (no float
// conversion — the chain accepts i16 entry planes and dequantizes
// in-kernel, so the host ships half the bytes and skips this conversion).
// i8/u8/u16 wire formats rescale to full-scale i16 (lossless for i8: <<8).
void deint_i16(const int16_t* in, size_t n, int16_t* re, int16_t* im,
               int swap_iq) {
    if (swap_iq) {
        for (size_t k = 0; k < n; ++k) {
            re[k] = in[2 * k + 1];
            im[k] = in[2 * k];
        }
    } else {
        for (size_t k = 0; k < n; ++k) {
            re[k] = in[2 * k];
            im[k] = in[2 * k + 1];
        }
    }
}

void deint_i8_to_i16(const int8_t* in, size_t n, int16_t* re, int16_t* im,
                     int swap_iq) {
    if (swap_iq) {
        for (size_t k = 0; k < n; ++k) {
            re[k] = (int16_t)(in[2 * k + 1] << 8);
            im[k] = (int16_t)(in[2 * k] << 8);
        }
    } else {
        for (size_t k = 0; k < n; ++k) {
            re[k] = (int16_t)(in[2 * k] << 8);
            im[k] = (int16_t)(in[2 * k + 1] << 8);
        }
    }
}

void deint_u8_to_i16(const uint8_t* in, size_t n, int16_t* re, int16_t* im,
                     int swap_iq) {
    if (swap_iq) {
        for (size_t k = 0; k < n; ++k) {
            re[k] = (int16_t)(((int)in[2 * k + 1] - 128) << 8);
            im[k] = (int16_t)(((int)in[2 * k] - 128) << 8);
        }
    } else {
        for (size_t k = 0; k < n; ++k) {
            re[k] = (int16_t)(((int)in[2 * k] - 128) << 8);
            im[k] = (int16_t)(((int)in[2 * k + 1] - 128) << 8);
        }
    }
}

// Audio encode: float32 [-1,1] mono/stereo planes -> interleaved int16 PCM.
void encode_pcm16(const float* const* chans, size_t n_chan, size_t n,
                  int16_t* out) {
    for (size_t k = 0; k < n; ++k) {
        for (size_t c = 0; c < n_chan; ++c) {
            float v = chans[c][k] * 32767.0f;
            if (v > 32767.0f) v = 32767.0f;
            if (v < -32768.0f) v = -32768.0f;
            out[k * n_chan + c] = (int16_t)(v >= 0 ? v + 0.5f : v - 0.5f);
        }
    }
}

}  // extern "C"

// ----------------------------------------------------------------- UDP pump
// High-rate UDP IQ receiver: drains datagrams on a dedicated C++ thread,
// strips a fixed header, tracks a little-endian 16-bit sequence number
// (a gap under 1024 -> dropped-datagram count + zero fill; 1024 or more is
// taken as the radio's restart and counted in resyncs), decodes the
// interleaved wire format into deinterleaved float32 re/im planes, and
// commits whole blocks into a Ring with drop-oldest overrun semantics (a
// block that finds no slot — the pump stopped while the ring was full — is
// counted in discarded, never dropped silently).  On
// destroy it first drains what the socket already holds, so the counters
// cover every datagram sent before the radio was stopped.  This is the native data
// plane for Msps-rate network sources (SDR-IP pushes ~8 k datagrams/s at
// 2 Msps — a per-datagram Python loop cannot keep ahead of the chain); the
// ProducerConsumer producer-thread role of the reference
// (pebblelib/producerconsumer.h:18-96) filled with a socket pump.

#include <arpa/inet.h>
#include <cerrno>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <thread>
#include <unistd.h>

namespace {

enum WireFmt { FMT_I16 = 0, FMT_U8 = 1, FMT_I8 = 2, FMT_U16 = 3, FMT_F32 = 4 };

struct UdpPump {
    int fd = -1;
    uint16_t port = 0;
    int header_bytes = 0;
    int seq_le16_offset = -1;   // -1: no sequence tracking
    int fmt = FMT_I16;
    int swap_iq = 0;
    int drop_oldest = 0;        // 0: backpressure to the socket buffer
    size_t block_samples = 0;
    Ring* ring = nullptr;       // each slot: [re plane | im plane] float32
    std::thread thread;
    std::atomic<bool> stop{false};
    std::atomic<uint64_t> datagrams{0};
    std::atomic<uint64_t> dropped{0};
    std::atomic<uint64_t> resyncs{0};  // gaps of 1024+: taken as restarts
    std::atomic<uint64_t> discarded{0};  // whole blocks no slot took: the
                                         // pump stopped while the ring was
                                         // full, or drop-oldest found the
                                         // oldest slot held by the reader
    std::atomic<uint64_t> bytes{0};
    // partial-block assembly (pump thread only)
    std::vector<float> re, im;
    size_t have = 0;
    uint32_t last_seq = 0;
    bool seq_valid = false;
};

size_t bytes_per_sample(int fmt) {
    switch (fmt) {
        case FMT_U8: case FMT_I8: return 2;
        case FMT_F32: return 8;
        default: return 4;  // i16/u16
    }
}

void decode_payload(int fmt, const uint8_t* p, size_t n, float* re, float* im,
                    int swap_iq) {
    switch (fmt) {
        case FMT_U8: decode_u8(p, n, re, im, swap_iq); break;
        case FMT_I8: decode_i8((const int8_t*)p, n, re, im, swap_iq); break;
        case FMT_U16: decode_u16((const uint16_t*)p, n, re, im, swap_iq); break;
        case FMT_F32: decode_f32((const float*)p, n, re, im, swap_iq); break;
        default: decode_i16((const int16_t*)p, n, re, im, swap_iq); break;
    }
}

void pump_flush_blocks(UdpPump* p) {
    while (p->have >= p->block_samples) {
        // drop_oldest: real-time mode, freshness beats completeness (the
        // ProducerConsumer POLL semantics).  Otherwise: WAIT for a slot —
        // backpressure falls to the 8 MB socket buffer, and any kernel-level
        // datagram loss surfaces as a tracked sequence gap instead of a
        // silent splice.
        void* slot = nullptr;
        while (!slot && !p->stop.load(std::memory_order_relaxed)) {
            slot = ring_acquire_write(p->ring, p->drop_oldest ? 0 : 200,
                                      p->drop_oldest);
            if (p->drop_oldest) break;
        }
        if (slot) {
            float* out = (float*)slot;
            std::memcpy(out, p->re.data(), p->block_samples * sizeof(float));
            std::memcpy(out + p->block_samples, p->im.data(),
                        p->block_samples * sizeof(float));
            ring_commit_write(p->ring);
        } else {
            p->discarded.fetch_add(1, std::memory_order_relaxed);
        }
        size_t rest = p->have - p->block_samples;
        std::memmove(p->re.data(), p->re.data() + p->block_samples,
                     rest * sizeof(float));
        std::memmove(p->im.data(), p->im.data() + p->block_samples,
                     rest * sizeof(float));
        p->have = rest;
    }
}

void pump_loop(UdpPump* p) {
    std::vector<uint8_t> buf(65536);
    const size_t bps = bytes_per_sample(p->fmt);
    // after stop, drain: every datagram already queued on the socket is
    // still received and counted, until a poll finds it empty (or 1 s)
    std::chrono::steady_clock::time_point drain_until{};
    bool draining = false;
    for (;;) {
        if (p->stop.load(std::memory_order_relaxed) && !draining) {
            draining = true;
            drain_until = std::chrono::steady_clock::now() +
                          std::chrono::seconds(1);
        }
        if (draining && std::chrono::steady_clock::now() > drain_until) break;
        ssize_t got = recv(p->fd, buf.data(), buf.size(),
                           draining ? MSG_DONTWAIT : 0);
        if (got < 0) {  // timeout / EINTR; empty while draining: done
            if (draining && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
            continue;
        }
        if ((size_t)got <= (size_t)p->header_bytes) continue;
        p->datagrams.fetch_add(1, std::memory_order_relaxed);
        p->bytes.fetch_add((uint64_t)got, std::memory_order_relaxed);
        size_t n = ((size_t)got - p->header_bytes) / bps;
        if (p->seq_le16_offset >= 0 &&
            (size_t)p->seq_le16_offset + 2 <= (size_t)p->header_bytes) {
            uint32_t seq = (uint32_t)buf[p->seq_le16_offset] |
                           ((uint32_t)buf[p->seq_le16_offset + 1] << 8);
            if (p->seq_valid) {
                uint32_t gap = (seq - p->last_seq - 1) & 0xFFFF;
                if (gap >= 1024) {
                    p->resyncs.fetch_add(1, std::memory_order_relaxed);
                } else if (gap > 0) {
                    p->dropped.fetch_add(gap, std::memory_order_relaxed);
                    size_t fill = gap * n;
                    if (p->re.size() < p->have + fill + n)
                        { p->re.resize(p->have + fill + n);
                          p->im.resize(p->have + fill + n); }
                    std::memset(p->re.data() + p->have, 0, fill * sizeof(float));
                    std::memset(p->im.data() + p->have, 0, fill * sizeof(float));
                    p->have += fill;
                    pump_flush_blocks(p);
                }
            }
            p->last_seq = seq;
            p->seq_valid = true;
        }
        if (p->re.size() < p->have + n)
            { p->re.resize(p->have + n); p->im.resize(p->have + n); }
        decode_payload(p->fmt, buf.data() + p->header_bytes, n,
                       p->re.data() + p->have, p->im.data() + p->have,
                       p->swap_iq);
        p->have += n;
        pump_flush_blocks(p);
    }
}

}  // namespace

extern "C" {

UdpPump* udp_pump_create(const char* bind_host, int port, int header_bytes,
                         int seq_le16_offset, int fmt, int swap_iq,
                         size_t block_samples, size_t ring_buffers,
                         int drop_oldest) {
    UdpPump* p = new UdpPump();
    p->header_bytes = header_bytes;
    p->seq_le16_offset = seq_le16_offset;
    p->fmt = fmt;
    p->swap_iq = swap_iq;
    p->drop_oldest = drop_oldest;
    p->block_samples = block_samples;
    p->re.resize(2 * block_samples);
    p->im.resize(2 * block_samples);
    p->fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (p->fd < 0) { delete p; return nullptr; }
    int one = 1;
    setsockopt(p->fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    int rcvbuf = 8 << 20;  // ride out consumer stalls (jit compiles)
    setsockopt(p->fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
    struct timeval tv = {0, 100000};  // 100 ms poll for the stop flag
    setsockopt(p->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    addr.sin_addr.s_addr = bind_host && *bind_host ? inet_addr(bind_host)
                                                   : INADDR_ANY;
    if (bind(p->fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
        close(p->fd); delete p; return nullptr;
    }
    socklen_t alen = sizeof(addr);
    getsockname(p->fd, (sockaddr*)&addr, &alen);
    p->port = ntohs(addr.sin_port);
    p->ring = ring_create(ring_buffers, 2 * block_samples * sizeof(float));
    p->thread = std::thread(pump_loop, p);
    return p;
}

int udp_pump_port(UdpPump* p) { return p->port; }

// Read one [re plane | im plane] block (2*block_samples floats) into out.
// Returns 1 on success, 0 on timeout.
int udp_pump_read(UdpPump* p, float* out, int timeout_ms) {
    void* slot = ring_acquire_read(p->ring, timeout_ms);
    if (!slot) return 0;
    std::memcpy(out, slot, 2 * p->block_samples * sizeof(float));
    ring_release_read(p->ring);
    return 1;
}

void udp_pump_counters(UdpPump* p, uint64_t* datagrams, uint64_t* dropped,
                       uint64_t* overruns, uint64_t* bytes,
                       uint64_t* resyncs, uint64_t* discarded) {
    if (discarded) *discarded = p->discarded.load();
    if (datagrams) *datagrams = p->datagrams.load();
    if (dropped) *dropped = p->dropped.load();
    if (resyncs) *resyncs = p->resyncs.load();
    if (overruns) *overruns = ring_overruns(p->ring);
    if (bytes) *bytes = p->bytes.load();
}

// Stop the pump thread once it has drained the socket (counters stay valid).
void udp_pump_stop(UdpPump* p) {
    p->stop.store(true);
    if (p->thread.joinable()) p->thread.join();
}

void udp_pump_destroy(UdpPump* p) {
    if (!p) return;
    udp_pump_stop(p);
    if (p->fd >= 0) close(p->fd);
    if (p->ring) ring_destroy(p->ring);
    delete p;
}

}  // extern "C"
