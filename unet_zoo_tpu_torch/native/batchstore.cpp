// Native batch store: mmap'd flat tensor file + multithreaded gather and
// asynchronous double-buffered prefetch.
//
// This is the framework's native data-loader runtime (the reference has no
// native code at all — its hot loop reads HDF5 through h5py fancy indexing
// on the Python thread, reference data/batch_provider.py:58-59). At TPU
// step rates the host must assemble the NEXT batch while the device computes
// the current one; this library does the record gather with a C++ thread
// pool over an mmap'd store, entirely off the Python thread.
//
// File format ("UZBS1"): magic[5] | u8 dtype_code | u8 ndim | pad |
//   i64 dims[ndim] | raw data (C-contiguous, dims[0] = record count).
//
// C ABI (consumed from Python via ctypes — no pybind11 in this image):
//   bs_open/bs_close, bs_info, bs_gather (synchronous parallel gather),
//   bs_prefetcher_new/submit/wait/free (async pipeline, `depth` buffers).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;  // mmap base
  size_t file_bytes = 0;
  const uint8_t* data = nullptr;  // first record
  int64_t num_records = 0;
  int64_t record_bytes = 0;
  uint8_t dtype_code = 0;
  uint8_t ndim = 0;
  int64_t dims[8] = {0};
};

constexpr char kMagic[5] = {'U', 'Z', 'B', 'S', '1'};

void parallel_gather(const Store* s, const int64_t* idx, int64_t n,
                     uint8_t* out, int nthreads) {
  const int64_t rb = s->record_bytes;
  const int64_t nrec = s->num_records;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = static_cast<int>(n);
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  std::atomic<int64_t> next(0);
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) break;
        // clamp out-of-range indices: never read past the mapping
        int64_t j = idx[i];
        if (j < 0) j = 0;
        if (j >= nrec) j = nrec - 1;
        std::memcpy(out + i * rb, s->data + j * rb, rb);
      }
    });
  }
  for (auto& t : ts) t.join();
}

struct Prefetcher {
  enum SlotState { FREE, FILLING, READY, IN_USE };

  const Store* store = nullptr;
  int64_t batch = 0;
  int nthreads = 1;
  int depth = 2;

  std::vector<std::vector<uint8_t>> buffers;
  std::vector<SlotState> state;
  std::vector<std::vector<int64_t>> pending;  // submitted index lists (FIFO)
  std::vector<int> ready_slots;               // filled slots (FIFO)
  int next_fill_slot = 0;                      // round-robin fill order
  int in_use_slot = -1;                        // buffer the consumer holds

  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::thread worker;
  bool stop = false;

  void run() {
    for (;;) {
      std::vector<int64_t> idx;
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          return stop ||
                 (!pending.empty() && state[next_fill_slot] == FREE);
        });
        if (stop) return;
        idx = std::move(pending.front());
        pending.erase(pending.begin());
        slot = next_fill_slot;
        state[slot] = FILLING;
        next_fill_slot = (next_fill_slot + 1) % depth;
      }
      parallel_gather(store, idx.data(), static_cast<int64_t>(idx.size()),
                      buffers[slot].data(), nthreads);
      {
        std::lock_guard<std::mutex> lk(mu);
        state[slot] = READY;
        ready_slots.push_back(slot);
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* bs_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* p = static_cast<const uint8_t*>(base);
  if (st.st_size < 8 || std::memcmp(p, kMagic, 5) != 0) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  // Validate the untrusted header before trusting any of its fields: a
  // truncated/corrupt store must fail bs_open, not overflow Store::dims[8]
  // or read past the mapping.
  const uint8_t dtype_code = p[5];
  const uint8_t ndim = p[6];
  const bool dtype_ok =
      dtype_code == 1 || dtype_code == 2 || dtype_code == 4 || dtype_code == 8;
  if (!dtype_ok || ndim == 0 || ndim > 8 ||
      st.st_size < static_cast<int64_t>(8 + 8 * ndim)) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  const int64_t* dims = reinterpret_cast<const int64_t*>(p + 8);
  int64_t rec = 1;
  for (int i = 0; i < ndim; ++i) {
    if (dims[i] < 0) {
      munmap(base, st.st_size);
      ::close(fd);
      return nullptr;
    }
    if (i > 0) rec *= dims[i];
  }
  // dtype sizes: 1:u8 2:i16 4:i32/f32 8:f64 — code IS the itemsize
  const int64_t num_records = dims[0];
  const int64_t record_bytes = rec * dtype_code;
  const int64_t header_bytes = 8 + 8 * static_cast<int64_t>(ndim);
  if (st.st_size < header_bytes + num_records * record_bytes) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  Store* s = new Store();
  s->fd = fd;
  s->base = p;
  s->file_bytes = st.st_size;
  s->dtype_code = dtype_code;
  s->ndim = ndim;
  for (int i = 0; i < ndim; ++i) s->dims[i] = dims[i];
  s->num_records = num_records;
  s->record_bytes = record_bytes;
  s->data = p + header_bytes;
  return s;
}

void bs_close(void* h) {
  Store* s = static_cast<Store*>(h);
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->base), s->file_bytes);
  ::close(s->fd);
  delete s;
}

void bs_info(void* h, int64_t* num_records, int64_t* record_bytes,
             int64_t* dims_out, int* ndim_out) {
  Store* s = static_cast<Store*>(h);
  *num_records = s->num_records;
  *record_bytes = s->record_bytes;
  *ndim_out = s->ndim;
  for (int i = 0; i < s->ndim; ++i) dims_out[i] = s->dims[i];
}

void bs_gather(void* h, const int64_t* idx, int64_t n, void* out,
               int nthreads) {
  parallel_gather(static_cast<Store*>(h), idx, n,
                  static_cast<uint8_t*>(out), nthreads);
}

void* bs_prefetcher_new(void* store, int64_t batch, int nthreads, int depth) {
  Prefetcher* p = new Prefetcher();
  p->store = static_cast<Store*>(store);
  p->batch = batch;
  p->nthreads = nthreads;
  p->depth = depth < 2 ? 2 : depth;  // >= 2: one in flight + one held
  p->buffers.resize(p->depth);
  p->state.assign(p->depth, Prefetcher::FREE);
  for (auto& b : p->buffers) b.resize(batch * p->store->record_bytes);
  p->worker = std::thread([p] { p->run(); });
  return p;
}

void bs_prefetcher_submit(void* ph, const int64_t* idx, int64_t n) {
  Prefetcher* p = static_cast<Prefetcher*>(ph);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->pending.emplace_back(idx, idx + n);
  }
  p->cv_work.notify_one();
}

// Blocks until the oldest submitted batch is filled; returns its buffer.
// The buffer is valid until the NEXT bs_prefetcher_wait call (the previous
// buffer is released then) — copy out or finish consuming before re-waiting.
void* bs_prefetcher_wait(void* ph) {
  Prefetcher* p = static_cast<Prefetcher*>(ph);
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->in_use_slot >= 0) p->state[p->in_use_slot] = Prefetcher::FREE;
  p->cv_done.wait(lk, [&] { return !p->ready_slots.empty(); });
  int slot = p->ready_slots.front();
  p->ready_slots.erase(p->ready_slots.begin());
  p->state[slot] = Prefetcher::IN_USE;
  p->in_use_slot = slot;
  p->cv_work.notify_one();  // freed slot may unblock the worker
  return p->buffers[slot].data();
}

void bs_prefetcher_free(void* ph) {
  Prefetcher* p = static_cast<Prefetcher*>(ph);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_work.notify_all();
  p->worker.join();
  delete p;
}

}  // extern "C"
