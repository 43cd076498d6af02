// tokenstore — native data-pipeline runtime for grasp_tpu_torch (the same
// source as the JAX package's, so that both serve the same batch stream).
//
// The reference has no native code (SURVEY.md §2); its data path re-tokenizes
// and re-chunks the whole corpus in Python per run (dataset/loader.py:59-68).
// Here the corpus is tokenized ONCE into a binary int32 token file; this
// library memory-maps it and serves pre-shifted calibration batches
// (input = chunk[:-1], labels = chunk[1:], the reference's quirk) with a
// background prefetch thread filling a ring of batch buffers, so host-side
// batch assembly overlaps device compute.
//
// C ABI (ctypes-friendly). All functions return 0 on success, negative errno
// style codes on failure.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct TokenStore {
  int fd = -1;
  const int32_t* data = nullptr;
  int64_t n_tokens = 0;
  size_t map_bytes = 0;
};

struct BatchServer {
  TokenStore* store = nullptr;
  int64_t seq_len = 0;
  int64_t batch_size = 0;
  int64_t n_chunks = 0;
  int64_t n_batches = 0;
  std::vector<int64_t> order;     // shuffled chunk ids
  std::atomic<int64_t> next_batch{0};

  // prefetch ring
  int64_t ring_cap = 4;
  std::deque<std::vector<int32_t>> ready;  // each: batch*2*(seq_len-1) ids (input then labels)
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::thread worker;
  std::atomic<bool> stop{false};
};

static void fill_batch(BatchServer* bs, int64_t batch_idx, int32_t* out) {
  const int64_t s = bs->seq_len;
  const int64_t sm1 = s - 1;
  for (int64_t b = 0; b < bs->batch_size; ++b) {
    const int64_t chunk = bs->order[batch_idx * bs->batch_size + b];
    const int32_t* src = bs->store->data + chunk * s;
    // pre-shift: input = chunk[:-1], labels = chunk[1:]
    std::memcpy(out + b * sm1, src, sm1 * sizeof(int32_t));
    std::memcpy(out + (bs->batch_size + b) * sm1, src + 1, sm1 * sizeof(int32_t));
  }
}

static void prefetch_loop(BatchServer* bs) {
  const int64_t per = bs->batch_size * 2 * (bs->seq_len - 1);
  int64_t produced = 0;
  while (!bs->stop.load()) {
    if (produced >= bs->n_batches) break;
    std::vector<int32_t> buf(per);
    fill_batch(bs, produced, buf.data());
    {
      std::unique_lock<std::mutex> lk(bs->mu);
      bs->cv_space.wait(lk, [bs] {
        return bs->stop.load() || (int64_t)bs->ready.size() < bs->ring_cap;
      });
      if (bs->stop.load()) break;
      bs->ready.emplace_back(std::move(buf));
      bs->cv_ready.notify_one();
    }
    ++produced;
  }
}

TokenStore* ts_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (p == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* ts = new TokenStore();
  ts->fd = fd;
  ts->data = static_cast<const int32_t*>(p);
  ts->map_bytes = st.st_size;
  ts->n_tokens = st.st_size / sizeof(int32_t);
  return ts;
}

int64_t ts_len(TokenStore* ts) { return ts ? ts->n_tokens : -1; }

void ts_close(TokenStore* ts) {
  if (!ts) return;
  if (ts->data) munmap(const_cast<int32_t*>(ts->data), ts->map_bytes);
  if (ts->fd >= 0) close(ts->fd);
  delete ts;
}

int ts_write(const char* path, const int32_t* tokens, int64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t written = fwrite(tokens, sizeof(int32_t), n, f);
  fclose(f);
  return written == (size_t)n ? 0 : -2;
}

BatchServer* bs_create(TokenStore* ts, int64_t seq_len, int64_t batch_size,
                       uint64_t seed, int shuffle, int64_t ring_cap) {
  if (!ts || seq_len < 2 || batch_size < 1) return nullptr;
  auto* bs = new BatchServer();
  bs->store = ts;
  bs->seq_len = seq_len;
  bs->batch_size = batch_size;
  bs->n_chunks = ts->n_tokens / seq_len;
  bs->n_batches = bs->n_chunks / batch_size;
  if (bs->n_batches == 0) {
    delete bs;
    return nullptr;
  }
  bs->order.resize(bs->n_chunks);
  for (int64_t i = 0; i < bs->n_chunks; ++i) bs->order[i] = i;
  if (shuffle) {
    std::mt19937_64 rng(seed);
    for (int64_t i = bs->n_chunks - 1; i > 0; --i) {
      std::uniform_int_distribution<int64_t> d(0, i);
      std::swap(bs->order[i], bs->order[d(rng)]);
    }
  }
  bs->ring_cap = ring_cap > 0 ? ring_cap : 4;
  bs->worker = std::thread(prefetch_loop, bs);
  return bs;
}

int64_t bs_num_batches(BatchServer* bs) { return bs ? bs->n_batches : -1; }

// Pops the next prefetched batch into out (size batch*2*(seq_len-1) int32:
// inputs then labels). Returns batch index >= 0, or -1 when exhausted.
int64_t bs_next(BatchServer* bs, int32_t* out) {
  if (!bs) return -1;
  const int64_t idx = bs->next_batch.load();
  if (idx >= bs->n_batches) return -1;
  std::vector<int32_t> buf;
  {
    std::unique_lock<std::mutex> lk(bs->mu);
    bs->cv_ready.wait(lk, [bs] { return bs->stop.load() || !bs->ready.empty(); });
    if (bs->ready.empty()) return -1;
    buf = std::move(bs->ready.front());
    bs->ready.pop_front();
    bs->cv_space.notify_one();
  }
  std::memcpy(out, buf.data(), buf.size() * sizeof(int32_t));
  bs->next_batch.fetch_add(1);
  return idx;
}

void bs_destroy(BatchServer* bs) {
  if (!bs) return;
  bs->stop.store(true);
  bs->cv_space.notify_all();
  bs->cv_ready.notify_all();
  if (bs->worker.joinable()) bs->worker.join();
  delete bs;
}

}  // extern "C"
