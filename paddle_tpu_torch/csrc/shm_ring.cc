// Shared-memory slot ring for DataLoader worker->main bulk transport.
//
// The port's copy of paddle_tpu/csrc/shm_ring.cc, with the same slot wire
// format and C interface (bound by paddle_tpu_torch/io/shm_ring.py).  A
// fixed arena of POSIX-shm slots carries the raw batch bytes and the (tiny)
// control messages stay on the multiprocessing queue: one memcpy into shm
// in the worker, one out in the main process, no pickling of bulk array
// data.
//
// One change from the reference: srb_create reserves the arena's pages
// with posix_fallocate.  ftruncate alone only sets the size of the tmpfs
// file, so on a small /dev/shm (a container's default is 64 MB) the create
// succeeded and the first write past the free space killed the writer with
// SIGBUS.  Now an arena that does not fit fails at create time: srb_create
// returns null with errno set (ENOSPC), and the binding raises.
//
// Concurrency model: each slot has an atomic state flag (FREE/BUSY).  A
// producer claims a slot with a CAS loop (any number of producers may share
// an arena), fills it, and sends the slot index out of band; the consumer
// copies out and CAS-releases.  No futexes needed — claiming only contends
// when the arena is full, where the producer backs off with sched_yield.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x53524e47;  // "SRNG"
constexpr uint32_t kFree = 0;
constexpr uint32_t kBusy = 1;

struct Header {
  uint32_t magic;
  uint32_t nslots;
  uint64_t slot_bytes;
  // flags[] follows, then page-aligned slot data
};

struct Handle {
  void* base;
  size_t map_bytes;
  Header* hdr;
  std::atomic<uint32_t>* flags;
  uint8_t* data;
};

size_t align_up(size_t v, size_t a) { return (v + a - 1) & ~(a - 1); }

size_t data_offset(uint32_t nslots) {
  return align_up(sizeof(Header) + nslots * sizeof(std::atomic<uint32_t>),
                  4096);
}

Handle* wrap(void* base, size_t bytes) {
  Handle* h = new Handle;
  h->base = base;
  h->map_bytes = bytes;
  h->hdr = static_cast<Header*>(base);
  h->flags = reinterpret_cast<std::atomic<uint32_t>*>(
      static_cast<uint8_t*>(base) + sizeof(Header));
  h->data = static_cast<uint8_t*>(base) + data_offset(h->hdr->nslots);
  return h;
}

}  // namespace

extern "C" {

void* srb_create(const char* name, uint32_t nslots, uint64_t slot_bytes) {
  if (nslots == 0 || slot_bytes == 0) return nullptr;
  shm_unlink(name);  // stale arena from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t bytes = data_offset(nslots) + nslots * slot_bytes;
  int rc = posix_fallocate(fd, 0, static_cast<off_t>(bytes));
  if (rc != 0) {
    close(fd);
    shm_unlink(name);
    errno = rc;  // posix_fallocate returns the error instead of setting it
    return nullptr;
  }
  void* base = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    int err = errno;
    shm_unlink(name);
    errno = err;
    return nullptr;
  }
  Header* hdr = static_cast<Header*>(base);
  hdr->nslots = nslots;
  hdr->slot_bytes = slot_bytes;
  auto* flags = reinterpret_cast<std::atomic<uint32_t>*>(
      static_cast<uint8_t*>(base) + sizeof(Header));
  for (uint32_t i = 0; i < nslots; ++i)
    flags[i].store(kFree, std::memory_order_relaxed);
  hdr->magic = kMagic;  // publish last
  return wrap(base, bytes);
}

void* srb_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* base =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Header* hdr = static_cast<Header*>(base);
  if (hdr->magic != kMagic) {
    munmap(base, st.st_size);
    return nullptr;
  }
  return wrap(base, st.st_size);
}

// Claim a FREE slot (CAS to BUSY); block up to timeout_ms. Returns slot
// index or -1 on timeout.
int srb_acquire(void* vh, int timeout_ms) {
  Handle* h = static_cast<Handle*>(vh);
  struct timespec start, now;
  clock_gettime(CLOCK_MONOTONIC, &start);
  for (;;) {
    for (uint32_t i = 0; i < h->hdr->nslots; ++i) {
      uint32_t expect = kFree;
      if (h->flags[i].compare_exchange_strong(expect, kBusy,
                                              std::memory_order_acquire))
        return static_cast<int>(i);
    }
    clock_gettime(CLOCK_MONOTONIC, &now);
    long ms = (now.tv_sec - start.tv_sec) * 1000 +
              (now.tv_nsec - start.tv_nsec) / 1000000;
    if (timeout_ms >= 0 && ms > timeout_ms) return -1;
    sched_yield();
  }
}

unsigned char* srb_data(void* vh, int slot) {
  Handle* h = static_cast<Handle*>(vh);
  if (slot < 0 || static_cast<uint32_t>(slot) >= h->hdr->nslots)
    return nullptr;
  return h->data + static_cast<uint64_t>(slot) * h->hdr->slot_bytes;
}

unsigned long long srb_slot_bytes(void* vh) {
  return static_cast<Handle*>(vh)->hdr->slot_bytes;
}

unsigned int srb_nslots(void* vh) {
  return static_cast<Handle*>(vh)->hdr->nslots;
}

void srb_release(void* vh, int slot) {
  Handle* h = static_cast<Handle*>(vh);
  if (slot < 0 || static_cast<uint32_t>(slot) >= h->hdr->nslots) return;
  h->flags[slot].store(kFree, std::memory_order_release);
}

void srb_close(void* vh) {
  Handle* h = static_cast<Handle*>(vh);
  munmap(h->base, h->map_bytes);
  delete h;
}

void srb_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
