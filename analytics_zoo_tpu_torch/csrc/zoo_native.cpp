// zoo_native — the host runtime of analytics_zoo_tpu_torch: the port's own
// copy of the JAX package's native/zoo_native.cpp (the same ABI, version
// 1), built by analytics_zoo_tpu_torch/native/lib.py with g++ at first use.
//
// The equivalent of the reference's native memory layer
// (PersistentMemoryAllocator.java:19-45 / memkind JNI, feature/pmem/*.scala):
//   * arena: a big mmap'd region (anonymous, or file-backed for the
//     DISK_AND_DRAM / pmem-mount capability) handing out 64-byte-aligned
//     slices with O(1) bump allocation and whole-arena reset;
//   * gather_rows: multi-threaded row gather (shuffled minibatch assembly) —
//     the hot host op between the sample cache and the device transfer;
//     numpy's fancy indexing is single-threaded memcpy, this saturates DRAM
//     bandwidth with N threads.
//
// Plain C ABI for ctypes. No exceptions across the boundary; errors return
// negative codes / NULL.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct Arena {
  uint8_t* base;
  size_t capacity;
  std::atomic<size_t> used;
  int fd;            // -1 for anonymous
};

// ---------------------------------------------------------------- arena

Arena* arena_create(size_t capacity, const char* backing_path) {
  int fd = -1;
  void* mem = MAP_FAILED;
  if (backing_path != nullptr && backing_path[0] != '\0') {
    fd = ::open(backing_path, O_RDWR | O_CREAT, 0644);
    if (fd < 0) return nullptr;
    if (::ftruncate(fd, (off_t)capacity) != 0) {
      ::close(fd);
      return nullptr;
    }
    mem = ::mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  } else {
    mem = ::mmap(nullptr, capacity, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  }
  if (mem == MAP_FAILED) {
    if (fd >= 0) ::close(fd);
    return nullptr;
  }
  ::madvise(mem, capacity, MADV_WILLNEED);
  Arena* a = new Arena();
  a->base = static_cast<uint8_t*>(mem);
  a->capacity = capacity;
  a->used.store(0);
  a->fd = fd;
  return a;
}

// returns offset into the arena, or -1 when full
int64_t arena_alloc(Arena* a, size_t nbytes) {
  const size_t kAlign = 64;
  size_t want = (nbytes + kAlign - 1) & ~(kAlign - 1);
  size_t prev = a->used.fetch_add(want);
  if (prev + want > a->capacity) {
    a->used.fetch_sub(want);
    return -1;
  }
  return (int64_t)prev;
}

uint8_t* arena_base(Arena* a) { return a->base; }
int64_t arena_used(Arena* a) { return (int64_t)a->used.load(); }
int64_t arena_capacity(Arena* a) { return (int64_t)a->capacity; }
void arena_reset(Arena* a) { a->used.store(0); }

void arena_destroy(Arena* a) {
  if (a == nullptr) return;
  ::munmap(a->base, a->capacity);
  if (a->fd >= 0) ::close(a->fd);
  delete a;
}

// sync file-backed arena contents to storage (pmem durability parity)
int arena_flush(Arena* a) {
  if (a->fd < 0) return 0;
  return ::msync(a->base, a->capacity, MS_SYNC);
}

// ---------------------------------------------------------------- gather

// dst[i, :] = src[idx[i], :], rows of row_bytes bytes, split across threads.
void gather_rows(const uint8_t* src, int64_t row_bytes, const int64_t* idx,
                 int64_t n_idx, uint8_t* dst, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || n_idx < 4 * n_threads) {
    for (int64_t i = 0; i < n_idx; ++i)
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                  (size_t)row_bytes);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n_idx ? lo + chunk : n_idx;
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i)
        std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                    (size_t)row_bytes);
    });
  }
  for (auto& th : ts) th.join();
}

// elementwise f32 scale+shift on a buffer (normalization in the load path),
// threaded; dst may alias src.
void scale_shift_f32(const float* src, float* dst, int64_t n, float scale,
                     float shift, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || n < (int64_t)1 << 20) {
    for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * scale + shift;
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) dst[i] = src[i] * scale + shift;
    });
  }
  for (auto& th : ts) th.join();
}

int zoo_native_abi_version() { return 1; }

}  // extern "C"
