// solid_runtime — native runtime for solid_dsp_tpu.
//
// Equivalent of the reference's runtime-side pieces
// (juliantos/solid-dsp src/circular_buffer/mod.rs:55-628 — the O(1) ring
// buffer that backs streaming IO), extended with what a production SDR
// framework needs around the JAX compute path:
//
//   * a lock-free single-producer/single-consumer ring buffer
//     (reference CircularBuffer parity: push / append / pop / release /
//     linearized read, error codes for over/underflow),
//   * IQ sample-format conversion (ci8 / ci16 / cf32 / cf64 -> cf32),
//   * a threaded file pump: a reader thread prefetches+converts blocks from
//     an IQ recording into the ring while the Python/JAX consumer computes —
//     the double-buffered host-side half of the block pipeline.
//
// Built as a plain C ABI shared library; Python binds via ctypes
// (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cerrno>
#include <cstring>
#include <cmath>
#include <new>
#include <thread>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netdb.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// SPSC ring buffer (byte oriented; element framing is the caller's business)
// ---------------------------------------------------------------------------

struct Ring {
  uint8_t* buf = nullptr;
  size_t capacity = 0;            // power of two
  size_t mask = 0;
  std::atomic<uint64_t> head{0};  // write position (producer)
  std::atomic<uint64_t> tail{0};  // read position (consumer)

  explicit Ring(size_t cap_request) {
    capacity = 1;
    while (capacity < cap_request) capacity <<= 1;
    mask = capacity - 1;
    buf = static_cast<uint8_t*>(::malloc(capacity));
    if (!buf) capacity = mask = 0;  // allocation failure -> zero-capacity
  }

  bool ok() const { return buf != nullptr; }
  ~Ring() { ::free(buf); }

  size_t size() const {
    return static_cast<size_t>(head.load(std::memory_order_acquire) -
                               tail.load(std::memory_order_acquire));
  }
  size_t space() const { return capacity - size(); }

  // Append up to n bytes; returns bytes written (0..n).
  size_t push(const uint8_t* src, size_t n) {
    size_t avail = space();
    if (n > avail) n = avail;
    uint64_t h = head.load(std::memory_order_relaxed);
    size_t off = static_cast<size_t>(h) & mask;
    size_t first = capacity - off;
    if (first > n) first = n;
    std::memcpy(buf + off, src, first);
    if (n > first) std::memcpy(buf, src + first, n - first);
    head.store(h + n, std::memory_order_release);
    return n;
  }

  // Pop up to n bytes into dst; returns bytes read.
  size_t pop(uint8_t* dst, size_t n) {
    size_t avail = size();
    if (n > avail) n = avail;
    uint64_t t = tail.load(std::memory_order_relaxed);
    size_t off = static_cast<size_t>(t) & mask;
    size_t first = capacity - off;
    if (first > n) first = n;
    std::memcpy(dst, buf + off, first);
    if (n > first) std::memcpy(dst + first, buf, n - first);
    tail.store(t + n, std::memory_order_release);
    return n;
  }

  // Copy up to n bytes without consuming (linearized view — reference
  // CircularBuffer::linearize semantics without the in-place shuffle).
  size_t peek(uint8_t* dst, size_t n) const {
    size_t avail = size();
    if (n > avail) n = avail;
    uint64_t t = tail.load(std::memory_order_acquire);
    size_t off = static_cast<size_t>(t) & mask;
    size_t first = capacity - off;
    if (first > n) first = n;
    std::memcpy(dst, buf + off, first);
    if (n > first) std::memcpy(dst + first, buf, n - first);
    return n;
  }

  // Drop n bytes (reference CircularBuffer::release).
  size_t release(size_t n) {
    size_t avail = size();
    if (n > avail) n = avail;
    tail.fetch_add(n, std::memory_order_release);
    return n;
  }

  void reset() {
    tail.store(head.load(std::memory_order_acquire),
               std::memory_order_release);
  }
};

// ---------------------------------------------------------------------------
// IQ format conversion -> interleaved float32 (re, im)
// ---------------------------------------------------------------------------

enum IQFormat : int { CF32 = 0, CI16 = 1, CI8 = 2, CF64 = 3,
                      CU8 = 4 /* rtl_tcp: unsigned, 127.5 center */ };

size_t iq_sample_bytes(int fmt) {
  switch (fmt) {
    case CF32: return 8;
    case CI16: return 4;
    case CI8: return 2;
    case CF64: return 16;
    case CU8: return 2;
  }
  return 0;
}

// Convert n_samples raw samples to cf32; returns bytes produced.
size_t iq_to_cf32(const uint8_t* raw, size_t n_samples, int fmt, float* out) {
  switch (fmt) {
    case CF32:
      std::memcpy(out, raw, n_samples * 8);
      break;
    case CI16: {
      const int16_t* p = reinterpret_cast<const int16_t*>(raw);
      constexpr float k = 1.0f / 32767.0f;
      for (size_t i = 0; i < 2 * n_samples; ++i) out[i] = p[i] * k;
      break;
    }
    case CI8: {
      const int8_t* p = reinterpret_cast<const int8_t*>(raw);
      constexpr float k = 1.0f / 127.0f;
      for (size_t i = 0; i < 2 * n_samples; ++i) out[i] = p[i] * k;
      break;
    }
    case CF64: {
      const double* p = reinterpret_cast<const double*>(raw);
      for (size_t i = 0; i < 2 * n_samples; ++i)
        out[i] = static_cast<float>(p[i]);
      break;
    }
    case CU8: {
      // rtl_tcp convention: unsigned bytes centered at 127.5
      constexpr float k = 1.0f / 127.5f;
      for (size_t i = 0; i < 2 * n_samples; ++i)
        out[i] = (static_cast<float>(raw[i]) - 127.5f) * k;
      break;
    }
    default:
      return 0;
  }
  return n_samples * 8;
}

// Convert cf32 -> raw fmt; returns bytes produced.
size_t cf32_to_iq(const float* in, size_t n_samples, int fmt, uint8_t* raw) {
  switch (fmt) {
    case CF32:
      std::memcpy(raw, in, n_samples * 8);
      return n_samples * 8;
    case CI16: {
      int16_t* p = reinterpret_cast<int16_t*>(raw);
      for (size_t i = 0; i < 2 * n_samples; ++i) {
        float v = in[i] * 32767.0f;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        p[i] = static_cast<int16_t>(::lrintf(v));
      }
      return n_samples * 4;
    }
    case CI8: {
      int8_t* p = reinterpret_cast<int8_t*>(raw);
      for (size_t i = 0; i < 2 * n_samples; ++i) {
        float v = in[i] * 127.0f;
        if (v > 127.0f) v = 127.0f;
        if (v < -128.0f) v = -128.0f;
        p[i] = static_cast<int8_t>(::lrintf(v));
      }
      return n_samples * 2;
    }
    case CF64: {
      double* p = reinterpret_cast<double*>(raw);
      for (size_t i = 0; i < 2 * n_samples; ++i)
        p[i] = static_cast<double>(in[i]);
      return n_samples * 16;
    }
    case CU8: {
      for (size_t i = 0; i < 2 * n_samples; ++i) {
        float v = in[i] * 127.5f + 127.5f;
        if (v > 255.0f) v = 255.0f;
        if (v < 0.0f) v = 0.0f;
        raw[i] = static_cast<uint8_t>(::lrintf(v));
      }
      return n_samples * 2;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// File pump: reader thread -> ring of cf32 samples
// ---------------------------------------------------------------------------

struct Pump {
  FILE* f = nullptr;
  int fmt = CF32;
  Ring ring;
  std::thread reader;
  std::atomic<bool> eof{false};
  std::atomic<bool> stop{false};
  std::atomic<long> io_error{0};

  Pump(FILE* file, int format, size_t ring_bytes)
      : f(file), fmt(format), ring(ring_bytes) {
    reader = std::thread([this] { run(); });
  }

  ~Pump() {
    stop.store(true);
    if (reader.joinable()) reader.join();
    if (f) ::fclose(f);
  }

  void run() {
    // poll()-based loop (not blocking fread): a stalled FIFO/pipe source
    // (the CLI's `rx -` stdin path) must not wedge ~Pump's join — stop is
    // re-checked every poll tick.
    const size_t CHUNK = 1 << 16;  // samples per read
    size_t sb = iq_sample_bytes(fmt);
    uint8_t* raw = static_cast<uint8_t*>(::malloc(CHUNK * sb));
    float* conv = static_cast<float*>(::malloc(CHUNK * 8));
    if (!raw || !conv) {
      io_error.store(-2);
      eof.store(true, std::memory_order_release);
      ::free(raw);
      ::free(conv);
      return;
    }
    int fd = ::fileno(f);
    size_t pend = 0;  // bytes of a partial sample carried between reads
    while (!stop.load(std::memory_order_relaxed)) {
      struct pollfd pfd {fd, POLLIN, 0};
      int pr = ::poll(&pfd, 1, 100 /* ms */);
      if (pr < 0) {
        if (errno == EINTR) continue;  // benign signal (SIGCHLD etc.)
        io_error.store(-1);
        break;
      }
      if (pr == 0) continue;  // timeout: re-check stop
      ssize_t r = ::read(fd, raw + pend, CHUNK * sb - pend);
      if (r < 0) {
        if (errno == EINTR) continue;
        io_error.store(-1);
        break;
      }
      if (r == 0) break;  // EOF
      size_t avail = pend + static_cast<size_t>(r);
      size_t got = avail / sb;  // whole samples only
      pend = avail - got * sb;
      size_t nbytes = iq_to_cf32(raw, got, fmt, conv);
      const uint8_t* src = reinterpret_cast<const uint8_t*>(conv);
      size_t pushed = 0;
      while (pushed < nbytes && !stop.load(std::memory_order_relaxed)) {
        size_t k = ring.push(src + pushed, nbytes - pushed);
        pushed += k;
        if (k == 0) std::this_thread::yield();
      }
      if (pend) ::memmove(raw, raw + got * sb, pend);
    }
    eof.store(true, std::memory_order_release);
    ::free(raw);
    ::free(conv);
  }

  // Blocking read of exactly n bytes unless EOF truncates; returns bytes.
  long next(uint8_t* dst, size_t n) {
    size_t got = 0;
    while (got < n) {
      size_t k = ring.pop(dst + got, n - got);
      got += k;
      if (k == 0) {
        if (eof.load(std::memory_order_acquire) && ring.size() == 0) break;
        std::this_thread::yield();
      }
    }
    if (io_error.load() != 0 && got == 0) return -1;
    return static_cast<long>(got);
  }
};

// ---------------------------------------------------------------------------
// UDP live IQ source: receiver thread -> ring of cf32 samples
// ---------------------------------------------------------------------------

struct UdpSource {
  int sock = -1;
  int fmt = CF32;
  Ring ring;
  std::thread reader;
  std::atomic<bool> stop{false};
  std::atomic<long> io_error{0};
  std::atomic<uint64_t> dropped{0};  // datagrams lost to a full ring

  UdpSource(int fd, int format, size_t ring_bytes)
      : sock(fd), fmt(format), ring(ring_bytes) {
    reader = std::thread([this] { run(); });
  }

  ~UdpSource() {
    stop.store(true);
    if (reader.joinable()) reader.join();
    if (sock >= 0) ::close(sock);
  }

  void run() {
    const size_t MAXDG = 65536;  // max UDP datagram
    size_t sb = iq_sample_bytes(fmt);
    uint8_t* raw = static_cast<uint8_t*>(::malloc(MAXDG + sb));
    float* conv = static_cast<float*>(::malloc((MAXDG / sb + 1) * 8));
    if (!raw || !conv) {
      io_error.store(-2);
      ::free(raw);
      ::free(conv);
      return;
    }
    while (!stop.load(std::memory_order_relaxed)) {
      struct pollfd pfd {sock, POLLIN, 0};
      int pr = ::poll(&pfd, 1, 100 /* ms */);
      if (pr < 0) {
        if (errno == EINTR) continue;
        io_error.store(-1);
        break;
      }
      if (pr == 0) continue;
      ssize_t r = ::recv(sock, raw, MAXDG, 0);
      if (r < 0) {
        if (errno == EINTR) continue;
        io_error.store(-1);
        break;
      }
      size_t got = static_cast<size_t>(r) / sb;  // whole samples only
      if (got == 0) continue;
      size_t nbytes = iq_to_cf32(raw, got, fmt, conv);
      // live source: a full ring DROPS the datagram (counted) rather than
      // back-pressuring the radio — matching SDR receiver semantics
      if (ring.space() < nbytes) {
        dropped.fetch_add(1, std::memory_order_relaxed);
        continue;
      }
      ring.push(reinterpret_cast<const uint8_t*>(conv), nbytes);
    }
  }

  // Read up to n bytes without blocking; returns bytes copied.
  long read_available(uint8_t* dst, size_t n) {
    if (io_error.load() != 0 && ring.size() == 0) return -1;
    return static_cast<long>(ring.pop(dst, n));
  }
};

// ---------------------------------------------------------------------------
// TCP stream IQ source (rtl_tcp client or raw TCP IQ): reader thread -> ring
// ---------------------------------------------------------------------------

struct TcpSource {
  int sock = -1;
  int fmt = CU8;
  Ring ring;
  std::thread reader;
  std::atomic<bool> stop{false};
  std::atomic<long> io_error{0};
  std::atomic<uint64_t> dropped{0};   // bytes lost to a full ring
  std::atomic<int> eof{0};
  uint32_t tuner_type = 0;            // from the rtl_tcp header
  uint32_t tuner_gains = 0;

  TcpSource(int fd, int format, size_t ring_bytes)
      : sock(fd), fmt(format), ring(ring_bytes) {
    reader = std::thread([this] { run(); });
  }

  ~TcpSource() {
    stop.store(true);
    ::shutdown(sock, SHUT_RDWR);      // interrupt a blocked recv
    if (reader.joinable()) reader.join();
    if (sock >= 0) ::close(sock);
  }

  void run() {
    const size_t CHUNK = 65536;
    size_t sb = iq_sample_bytes(fmt);
    uint8_t* raw = static_cast<uint8_t*>(::malloc(CHUNK + sb));
    float* conv = static_cast<float*>(::malloc((CHUNK / sb + 1) * 8));
    if (!raw || !conv) {
      io_error.store(-2);
      ::free(raw);
      ::free(conv);
      return;
    }
    size_t carry = 0;                 // partial-sample remainder bytes
    while (!stop.load(std::memory_order_relaxed)) {
      struct pollfd pfd {sock, POLLIN, 0};
      int pr = ::poll(&pfd, 1, 100 /* ms */);
      if (pr < 0) {
        if (errno == EINTR) continue;
        io_error.store(-1);
        break;
      }
      if (pr == 0) continue;
      ssize_t r = ::recv(sock, raw + carry, CHUNK - carry, 0);
      if (r < 0) {
        if (errno == EINTR) continue;
        io_error.store(-1);
        break;
      }
      if (r == 0) {                   // orderly remote close
        eof.store(1);
        break;
      }
      size_t have = carry + static_cast<size_t>(r);
      size_t got = have / sb;         // whole samples only
      carry = have - got * sb;
      if (got == 0) continue;
      size_t nbytes = iq_to_cf32(raw, got, fmt, conv);
      if (carry) std::memmove(raw, raw + got * sb, carry);
      // live source semantics: a full ring drops (counted), no
      // back-pressure onto the radio's TCP window
      if (ring.space() < nbytes) {
        dropped.fetch_add(nbytes, std::memory_order_relaxed);
        continue;
      }
      ring.push(reinterpret_cast<const uint8_t*>(conv), nbytes);
    }
    ::free(raw);
    ::free(conv);
  }

  long read_available(uint8_t* dst, size_t n) {
    if (ring.size() == 0) {
      if (io_error.load() != 0) return -1;
      if (eof.load()) return -2;
    }
    return static_cast<long>(ring.pop(dst, n));
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* sdsp_ring_create(size_t capacity_bytes) {
  Ring* r = new (std::nothrow) Ring(capacity_bytes);
  if (r && !r->ok()) {  // buffer allocation failed: fail construction
    delete r;
    return nullptr;
  }
  return r;
}
void sdsp_ring_destroy(void* r) { delete static_cast<Ring*>(r); }
size_t sdsp_ring_capacity(void* r) { return static_cast<Ring*>(r)->capacity; }
size_t sdsp_ring_size(void* r) { return static_cast<Ring*>(r)->size(); }
size_t sdsp_ring_space(void* r) { return static_cast<Ring*>(r)->space(); }
size_t sdsp_ring_push(void* r, const void* src, size_t n) {
  return static_cast<Ring*>(r)->push(static_cast<const uint8_t*>(src), n);
}
size_t sdsp_ring_pop(void* r, void* dst, size_t n) {
  return static_cast<Ring*>(r)->pop(static_cast<uint8_t*>(dst), n);
}
size_t sdsp_ring_peek(void* r, void* dst, size_t n) {
  return static_cast<Ring*>(r)->peek(static_cast<uint8_t*>(dst), n);
}
size_t sdsp_ring_release(void* r, size_t n) {
  return static_cast<Ring*>(r)->release(n);
}
void sdsp_ring_reset(void* r) { static_cast<Ring*>(r)->reset(); }

int sdsp_iq_sample_bytes(int fmt) {
  return static_cast<int>(iq_sample_bytes(fmt));
}

// One-shot file conversion read: read up to n_samples from offset_samples,
// converting to cf32 into out. Returns samples read, or -1 on error.
long sdsp_iq_read(const char* path, int fmt, long offset_samples,
                  long n_samples, float* out) {
  size_t sb = iq_sample_bytes(fmt);
  if (sb == 0) return -1;
  FILE* f = ::fopen(path, "rb");
  if (!f) return -1;
  if (offset_samples > 0 &&
      ::fseek(f, static_cast<long>(offset_samples * sb), SEEK_SET) != 0) {
    ::fclose(f);
    return -1;
  }
  uint8_t* raw = static_cast<uint8_t*>(::malloc(n_samples * sb));
  if (!raw) {
    ::fclose(f);
    return -1;
  }
  size_t got = ::fread(raw, sb, static_cast<size_t>(n_samples), f);
  ::fclose(f);
  iq_to_cf32(raw, got, fmt, out);
  ::free(raw);
  return static_cast<long>(got);
}

// Write n_samples cf32 samples as fmt (append=0 truncates). Returns samples
// written or -1.
long sdsp_iq_write(const char* path, int fmt, const float* data,
                   long n_samples, int append) {
  size_t sb = iq_sample_bytes(fmt);
  if (sb == 0) return -1;
  FILE* f = ::fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  uint8_t* raw = static_cast<uint8_t*>(::malloc(n_samples * sb));
  if (!raw) {
    ::fclose(f);
    return -1;
  }
  size_t nb = cf32_to_iq(data, static_cast<size_t>(n_samples), fmt, raw);
  size_t wrote = ::fwrite(raw, 1, nb, f);
  ::free(raw);
  ::fclose(f);
  if (wrote != nb) return -1;
  return n_samples;
}

void* sdsp_pump_create(const char* path, int fmt, size_t ring_samples) {
  FILE* f = ::fopen(path, "rb");
  if (!f) return nullptr;
  Pump* p = new (std::nothrow) Pump(f, fmt, ring_samples * 8);
  if (p && !p->ring.ok()) {  // ring allocation failed: fail construction
    delete p;
    return nullptr;
  }
  return p;
}
void sdsp_pump_destroy(void* p) { delete static_cast<Pump*>(p); }
// Blocking: fill out with n_samples cf32 samples; returns samples delivered
// (< n_samples only at EOF), or -1 on IO error.
long sdsp_pump_next(void* p, float* out, long n_samples) {
  long b = static_cast<Pump*>(p)->next(reinterpret_cast<uint8_t*>(out),
                                       static_cast<size_t>(n_samples) * 8);
  return b < 0 ? -1 : b / 8;
}
int sdsp_pump_eof(void* p) {
  Pump* pp = static_cast<Pump*>(p);
  return pp->eof.load() && pp->ring.size() == 0;
}

// UDP live source: binds bind_addr:port and converts datagrams into the
// ring. Returns NULL on bind/allocation failure.
void* sdsp_udp_create(const char* bind_addr, int port, int fmt,
                      size_t ring_samples) {
  if (iq_sample_bytes(fmt) == 0) return nullptr;
  int fd = ::socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  if (::bind(fd, reinterpret_cast<struct sockaddr*>(&addr),
             sizeof(addr)) != 0) {
    ::close(fd);
    return nullptr;
  }
  UdpSource* s = new (std::nothrow) UdpSource(fd, fmt, ring_samples * 8);
  if (!s) {  // allocation failure: the bound fd must not leak
    ::close(fd);
    return nullptr;
  }
  if (!s->ring.ok()) {
    delete s;  // ~UdpSource closes fd
    return nullptr;
  }
  return s;
}
void sdsp_udp_destroy(void* s) { delete static_cast<UdpSource*>(s); }
// Non-blocking: copies up to n_samples available cf32 samples; returns
// samples copied, or -1 after an IO error once the ring drains.
long sdsp_udp_read(void* s, float* out, long n_samples) {
  long b = static_cast<UdpSource*>(s)->read_available(
      reinterpret_cast<uint8_t*>(out), static_cast<size_t>(n_samples) * 8);
  return b < 0 ? -1 : b / 8;
}
size_t sdsp_udp_available(void* s) {
  return static_cast<UdpSource*>(s)->ring.size() / 8;
}
unsigned long long sdsp_udp_dropped(void* s) {
  return static_cast<UdpSource*>(s)->dropped.load();
}

// TCP stream source: connects to host:port.  expect_rtl_header != 0 reads
// and validates the 12-byte rtl_tcp greeting ("RTL0" + tuner type + gain
// count) before streaming.  Returns NULL on connect/handshake failure.
void* sdsp_tcp_create(const char* host, int port, int fmt,
                      size_t ring_samples, int expect_rtl_header) {
  if (iq_sample_bytes(fmt) == 0) return nullptr;
  // resolve hostnames AND numeric addresses (the Python API documents
  // the parameter simply as "host")
  char portstr[16];
  std::snprintf(portstr, sizeof(portstr), "%d", port);
  struct addrinfo hints;
  std::memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  if (::getaddrinfo(host, portstr, &hints, &res) != 0 || !res)
    return nullptr;
  int fd = -1;
  for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  ::freeaddrinfo(res);
  if (fd < 0) return nullptr;
  uint32_t tuner_type = 0, tuner_gains = 0;
  if (expect_rtl_header) {
    // bounded handshake: a server that accepts but never greets must
    // not hang the constructor (the reader thread polls; so do we)
    uint8_t hdr[12];
    size_t got = 0;
    int waited_ms = 0;
    while (got < sizeof(hdr)) {
      struct pollfd pfd {fd, POLLIN, 0};
      int pr = ::poll(&pfd, 1, 100);
      if (pr < 0 && errno != EINTR) {
        ::close(fd);
        return nullptr;
      }
      if (pr <= 0) {
        waited_ms += 100;
        if (waited_ms >= 5000) {      // 5 s handshake deadline
          ::close(fd);
          return nullptr;
        }
        continue;
      }
      ssize_t r = ::recv(fd, hdr + got, sizeof(hdr) - got, 0);
      if (r <= 0) {
        ::close(fd);
        return nullptr;
      }
      got += static_cast<size_t>(r);
    }
    if (std::memcmp(hdr, "RTL0", 4) != 0) {
      ::close(fd);
      return nullptr;
    }
    tuner_type = (uint32_t(hdr[4]) << 24) | (uint32_t(hdr[5]) << 16) |
                 (uint32_t(hdr[6]) << 8) | uint32_t(hdr[7]);
    tuner_gains = (uint32_t(hdr[8]) << 24) | (uint32_t(hdr[9]) << 16) |
                  (uint32_t(hdr[10]) << 8) | uint32_t(hdr[11]);
  }
  TcpSource* s = new (std::nothrow) TcpSource(fd, fmt, ring_samples * 8);
  if (!s) {
    ::close(fd);
    return nullptr;
  }
  if (!s->ring.ok()) {
    delete s;
    return nullptr;
  }
  s->tuner_type = tuner_type;
  s->tuner_gains = tuner_gains;
  return s;
}
void sdsp_tcp_destroy(void* s) { delete static_cast<TcpSource*>(s); }
long sdsp_tcp_read(void* s, float* out, long n_samples) {
  long b = static_cast<TcpSource*>(s)->read_available(
      reinterpret_cast<uint8_t*>(out), static_cast<size_t>(n_samples) * 8);
  return b < 0 ? b : b / 8;
}
size_t sdsp_tcp_available(void* s) {
  return static_cast<TcpSource*>(s)->ring.size() / 8;
}
unsigned long long sdsp_tcp_dropped(void* s) {
  return static_cast<TcpSource*>(s)->dropped.load();
}
int sdsp_tcp_eof(void* s) {
  TcpSource* t = static_cast<TcpSource*>(s);
  return (t->eof.load() || t->io_error.load()) && t->ring.size() == 0;
}
unsigned int sdsp_tcp_tuner_type(void* s) {
  return static_cast<TcpSource*>(s)->tuner_type;
}
// rtl_tcp 5-byte command: cmd byte + big-endian u32 parameter (e.g.
// 0x01 = set center freq Hz, 0x02 = sample rate, 0x04 = gain).
int sdsp_tcp_command(void* s, int cmd, unsigned int param) {
  TcpSource* t = static_cast<TcpSource*>(s);
  uint8_t msg[5];
  msg[0] = static_cast<uint8_t>(cmd);
  msg[1] = static_cast<uint8_t>(param >> 24);
  msg[2] = static_cast<uint8_t>(param >> 16);
  msg[3] = static_cast<uint8_t>(param >> 8);
  msg[4] = static_cast<uint8_t>(param);
  ssize_t w = ::send(t->sock, msg, sizeof(msg), MSG_NOSIGNAL);
  return w == sizeof(msg) ? 0 : -1;
}

}  // extern "C"
