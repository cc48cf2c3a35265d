// Native I/O runtime for gr_bluetooth_tpu_torch: the port's own copy of
// the JAX package's native/btio.cc, the same C ABI.
//
// Counterpart of the reference's C++ runtime pieces:
//   * TAP device creation + pseudo-ethernet framing for live Wireshark
//     dissection (lib/tun.cc:6-123; ether_type 0xFFF0 frames carrying the
//     9-byte meta+header tun_format payload, lib/packet_impl.cc:1175-1202)
//   * pcap file writer with the same framing — the portable offline
//     equivalent (the reference only has the live TAP path)
//   * a lock-free single-producer/single-consumer ring buffer fed by a
//     reader thread, for streaming IQ from an fd (stdin / SDR pipe)
//     without GIL involvement — the ingest role GNU Radio's scheduler
//     buffers play in the reference (apps/btrx:121-126 stdin source).
//
// Exposed as a plain C ABI for ctypes (no pybind11 needed).
//
// Build: io/native.py compiles it at first use into the package's _build/
//   (g++ -O2 -fPIC -shared -pthread -std=c++17), named by a digest of this file.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>

#include <fcntl.h>
#include <unistd.h>

#ifdef __linux__
#include <linux/if.h>
#include <linux/if_tun.h>
#include <net/ethernet.h>
#include <sys/ioctl.h>
#include <sys/socket.h>
#include <arpa/inet.h>
#endif

extern "C" {

// ------------------------------------------------------------------ TAP

// Create a persistent TAP interface; returns fd or -1 (lib/tun.cc:6-81).
int bt_mktun(const char *name, unsigned char ether_addr[6]) {
#ifdef __linux__
  struct ifreq ifr;
  int fd, one = 1;
  if ((fd = open("/dev/net/tun", O_RDWR)) == -1) return -1;
  memset(&ifr, 0, sizeof(ifr));
  ifr.ifr_flags = IFF_TAP | IFF_NO_PI;
  snprintf(ifr.ifr_name, IFNAMSIZ, "%s", name);
  if (ioctl(fd, TUNSETIFF, (void *)&ifr) == -1) { close(fd); return -1; }
  char if_name[IFNAMSIZ];
  memcpy(if_name, ifr.ifr_name, IFNAMSIZ);
  memset(&ifr, 0, sizeof(ifr));
  memcpy(ifr.ifr_name, if_name, IFNAMSIZ);
  if (ioctl(fd, SIOCGIFHWADDR, (void *)&ifr) == -1) { close(fd); return -1; }
  if (ether_addr) memcpy(ether_addr, ifr.ifr_hwaddr.sa_data, 6);
  if (ioctl(fd, TUNSETPERSIST, (void *)&one) == -1) { close(fd); return -1; }
  return fd;
#else
  (void)name; (void)ether_addr;
  return -1;
#endif
}

// Frame payload as pseudo-ethernet and write (lib/tun.cc:91-123).
int bt_write_frame(int fd, const unsigned char *data, unsigned int len,
                   uint64_t src_addr, uint64_t dst_addr,
                   unsigned short ether_type) {
  unsigned char frame[1514];
  if (fd < 0) return (int)len;
  if (len > sizeof(frame) - 14) len = sizeof(frame) - 14;
  for (int i = 0; i < 6; i++) {
    int shift = 8 * (5 - i);
    frame[i] = (unsigned char)((dst_addr >> shift) & 0xff);
    frame[6 + i] = (unsigned char)((src_addr >> shift) & 0xff);
  }
  frame[12] = (unsigned char)(ether_type >> 8);
  frame[13] = (unsigned char)(ether_type & 0xff);
  if (len && data) memcpy(frame + 14, data, len);
  if (write(fd, frame, 14 + len) == -1) return -1;
  return (int)len;
}

// ------------------------------------------------------------------ pcap

struct BtPcap {
  FILE *f;
};

// Open a pcap file (classic format, microsecond ts); dlt 1 = EN10MB so
// the 0xFFF0 frames dissect like the TAP path.
void *bt_pcap_open(const char *path, uint32_t dlt) {
  FILE *f = fopen(path, "wb");
  if (!f) return nullptr;
  uint32_t hdr[6] = {0xa1b2c3d4u, 0, 65535u, 0, 0, dlt};
  hdr[1] = (2u << 16) | 4u;  // version 2.4
  if (fwrite(hdr, sizeof(hdr), 1, f) != 1) { fclose(f); return nullptr; }
  BtPcap *p = new BtPcap{f};
  return p;
}

int bt_pcap_write(void *handle, uint32_t ts_sec, uint32_t ts_usec,
                  const unsigned char *data, uint32_t len) {
  BtPcap *p = (BtPcap *)handle;
  if (!p || !p->f) return -1;
  uint32_t rec[4] = {ts_sec, ts_usec, len, len};
  if (fwrite(rec, sizeof(rec), 1, p->f) != 1) return -1;
  if (len && fwrite(data, len, 1, p->f) != 1) return -1;
  return (int)len;
}

void bt_pcap_close(void *handle) {
  BtPcap *p = (BtPcap *)handle;
  if (!p) return;
  if (p->f) fclose(p->f);
  delete p;
}

// ----------------------------------------------------------- ring buffer

// SPSC byte ring fed by a detached reader thread pumping an fd; the
// consumer (Python) pops without holding the GIL against the producer.
struct BtRing {
  unsigned char *buf;
  size_t cap;
  std::atomic<uint64_t> head{0};  // written by producer
  std::atomic<uint64_t> tail{0};  // consumer advances; in drop mode the
                                  // producer also CASes it forward (see below)
  std::atomic<int> eof{0};
  std::atomic<int> overrun{0};          // drop events
  std::atomic<uint64_t> dropped{0};     // dropped bytes
  int fd;
  int drop_on_full;  // 1 = drop oldest (live source), 0 = backpressure
  std::thread thr;
  // Wakeup for blocking consumers: the pump signals after each write and
  // at EOF, so bt_ring_pop_wait sleeps instead of spinning a host core
  // (the wake-fd role the Kismet plugin's socketpair plays,
  // kismet/plugin-bluetooth/bluetooth_kismet_block.cc:107-120).
  std::mutex mtx;
  std::condition_variable cv;
};

// Drop-oldest semantics make the ring no longer strictly SPSC: both sides
// move `tail`, so both use compare-exchange.  If the producer steals a
// region the consumer is mid-copy, the consumer's CAS fails and it retries
// (seqlock-style: torn reads are discarded, never returned).
static void bt_ring_notify(BtRing *r) {
  // lock/unlock pairs the notify with any waiter's predicate check, so a
  // waiter that just saw "empty" cannot miss the wakeup
  { std::lock_guard<std::mutex> g(r->mtx); }
  r->cv.notify_all();
}

static void bt_ring_pump(BtRing *r) {
  unsigned char tmp[1 << 16];
  for (;;) {
    ssize_t n = read(r->fd, tmp, sizeof(tmp));
    if (n <= 0) { r->eof.store(1); bt_ring_notify(r); return; }
    size_t off = 0;
    while (off < (size_t)n) {
      uint64_t head = r->head.load(std::memory_order_relaxed);
      uint64_t tail = r->tail.load(std::memory_order_acquire);
      size_t free_b = r->cap - (size_t)(head - tail);
      size_t chunk = (size_t)n - off;
      if (chunk > r->cap) chunk = r->cap;
      if (free_b == 0 || (r->drop_on_full && free_b < chunk)) {
        if (r->drop_on_full) {
          // live mode: drop exactly the shortfall of oldest bytes so this
          // chunk fits; CAS so a concurrent pop is never overwritten AND
          // acknowledged (its CAS fails and it retries instead)
          uint64_t want_tail = head + chunk - r->cap;
          if (r->tail.compare_exchange_strong(
                  tail, want_tail, std::memory_order_acq_rel,
                  std::memory_order_relaxed)) {
            r->dropped.fetch_add(want_tail - tail);
            r->overrun.fetch_add(1);
          }
          continue;  // re-read head/tail
        }
        std::this_thread::yield();
        continue;
      }
      if (chunk > free_b) chunk = free_b;
      size_t pos = (size_t)(head % r->cap);
      size_t first = r->cap - pos;
      if (first > chunk) first = chunk;
      memcpy(r->buf + pos, tmp + off, first);
      if (chunk > first) memcpy(r->buf, tmp + off + first, chunk - first);
      r->head.store(head + chunk, std::memory_order_release);
      bt_ring_notify(r);
      off += chunk;
    }
  }
}

void *bt_ring_create(int fd, size_t capacity, int drop_on_full) {
  BtRing *r = new BtRing();
  r->buf = (unsigned char *)malloc(capacity);
  if (!r->buf) { delete r; return nullptr; }
  r->cap = capacity;
  r->fd = fd;
  r->drop_on_full = drop_on_full;
  r->thr = std::thread(bt_ring_pump, r);
  return r;
}

// Pop up to n bytes; returns bytes copied (0 if empty; -1 on EOF+empty).
long bt_ring_pop(void *handle, unsigned char *out, size_t n) {
  BtRing *r = (BtRing *)handle;
  for (;;) {
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    uint64_t head = r->head.load(std::memory_order_acquire);
    size_t avail = (size_t)(head - tail);
    if (avail == 0) return r->eof.load() ? -1 : 0;
    size_t take = n > avail ? avail : n;
    size_t pos = (size_t)(tail % r->cap);
    size_t first = r->cap - pos;
    if (first > take) first = take;
    memcpy(out, r->buf + pos, first);
    if (take > first) memcpy(out + first, r->buf, take - first);
    // in drop mode the producer may have advanced tail past our copy
    // region (overwriting it); the CAS detects that and we retry
    if (r->tail.compare_exchange_strong(tail, tail + take,
                                        std::memory_order_acq_rel,
                                        std::memory_order_relaxed))
      return (long)take;
  }
}

// Blocking pop: wait up to timeout_ms for data before popping.  Returns
// bytes copied, 0 on timeout with no data, -1 on EOF+empty.  The idle
// cost is a condvar sleep, not a spin (VPU hosts share the decode core).
long bt_ring_pop_wait(void *handle, unsigned char *out, size_t n,
                      int timeout_ms) {
  BtRing *r = (BtRing *)handle;
  {
    std::unique_lock<std::mutex> lk(r->mtx);
    r->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [r] {
      return r->head.load(std::memory_order_acquire) !=
                 r->tail.load(std::memory_order_acquire) ||
             r->eof.load();
    });
  }
  return bt_ring_pop(handle, out, n);
}

long bt_ring_available(void *handle) {
  BtRing *r = (BtRing *)handle;
  return (long)(r->head.load() - r->tail.load());
}

int bt_ring_overruns(void *handle) {
  return ((BtRing *)handle)->overrun.load();
}

// Total bytes dropped by the live (drop-oldest) mode.
uint64_t bt_ring_dropped(void *handle) {
  return ((BtRing *)handle)->dropped.load();
}

void bt_ring_destroy(void *handle) {
  BtRing *r = (BtRing *)handle;
  if (!r) return;
  // closing the fd unblocks the pump thread's read
  close(r->fd);
  if (r->thr.joinable()) r->thr.join();
  free(r->buf);
  delete r;
}

}  // extern "C"
