// Native threaded batch prefetcher — the input-pipeline role that TF's
// C++ queue runners played under `DataSet.next_batch` (SURVEY.md §2.1 row
// 2, §2.3 rows 11-12): batch assembly (shuffled gather of rows into a
// contiguous buffer) runs on background producer threads in C++, decoupled
// from the Python consumer by a bounded ring buffer, so host-side input
// work overlaps device compute instead of sitting on the step's critical
// path.
//
// Determinism: epoch shuffles are Fisher-Yates driven by splitmix64 seeded
// with (seed, epoch) — identical across instances/processes, so multi-host
// consumers slice disjoint ranges of the same permutation (the same
// contract as data/pipeline.epoch_batches, with a different — but equally
// pinned — PRNG).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

void shuffle_epoch(std::vector<int64_t>& idx, uint64_t seed, uint64_t epoch) {
  std::iota(idx.begin(), idx.end(), 0);
  uint64_t s = seed * 0x9E3779B97F4A7C15ull + epoch + 1;
  for (int64_t i = (int64_t)idx.size() - 1; i > 0; --i) {
    const int64_t j = (int64_t)(splitmix64(s) % (uint64_t)(i + 1));
    std::swap(idx[i], idx[j]);
  }
}

class Loader {
 public:
  Loader(const uint8_t* images, const int32_t* labels, int64_t n,
         int64_t row_bytes, int64_t batch, uint64_t seed, int depth,
         int64_t slice_begin, int64_t slice_size, int64_t start_step)
      : images_(images),
        labels_(labels),
        n_(n),
        row_bytes_(row_bytes),
        batch_(batch),
        seed_(seed),
        depth_(depth),
        slice_begin_(slice_begin),
        slice_size_(slice_size > 0 ? slice_size : batch),
        start_step_(start_step),
        slots_(depth) {
    for (auto& s : slots_) {
      s.img.resize((size_t)(slice_size_)*row_bytes_);
      s.lab.resize((size_t)slice_size_);
    }
    producer_ = std::thread([this] { produce(); });
  }

  ~Loader() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
      cv_.notify_all();
    }
    if (producer_.joinable()) producer_.join();
  }

  // Blocks for the next batch slice; copies into caller buffers. Returns
  // the global step index of the batch, or -1 after close().
  int64_t next(uint8_t* img_out, int32_t* lab_out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [&] { return stop_ || head_ < tail_; });
    if (stop_ && head_ >= tail_) return -1;
    Slot& s = slots_[head_ % depth_];
    std::memcpy(img_out, s.img.data(), s.img.size());
    std::memcpy(lab_out, s.lab.data(), s.lab.size() * sizeof(int32_t));
    const int64_t step = start_step_ + head_++;
    cv_.notify_all();
    return step;
  }

  void close() {
    std::unique_lock<std::mutex> lk(mu_);
    stop_ = true;
    cv_.notify_all();
  }

 private:
  struct Slot {
    std::vector<uint8_t> img;
    std::vector<int32_t> lab;
  };

  void produce() {
    std::vector<int64_t> perm((size_t)n_);
    const int64_t per_epoch = n_ / batch_;
    // resume-aware: position is a pure function of step, so a restored
    // trainer passes start_step and the stream continues exactly where the
    // pre-preemption run left off (mirrors pipeline.ShardedBatcher).
    uint64_t epoch = (uint64_t)(start_step_ / per_epoch);
    shuffle_epoch(perm, seed_, epoch);
    for (int64_t step = start_step_;; ++step) {
      const int64_t in_epoch = step % per_epoch;
      if (step > start_step_ && in_epoch == 0)
        shuffle_epoch(perm, seed_, ++epoch);
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || tail_ - head_ < depth_; });
        if (stop_) return;
      }
      Slot& s = slots_[tail_ % depth_];
      const int64_t base = in_epoch * batch_ + slice_begin_;
      for (int64_t r = 0; r < slice_size_; ++r) {
        const int64_t src = perm[(size_t)(base + r)];
        std::memcpy(s.img.data() + (size_t)r * row_bytes_,
                    images_ + (size_t)src * row_bytes_, (size_t)row_bytes_);
        s.lab[(size_t)r] = labels_[src];
      }
      {
        std::unique_lock<std::mutex> lk(mu_);
        ++tail_;
        cv_.notify_all();
      }
    }
  }

  const uint8_t* images_;
  const int32_t* labels_;
  const int64_t n_, row_bytes_, batch_;
  const uint64_t seed_;
  const int depth_;
  const int64_t slice_begin_, slice_size_, start_step_;
  std::vector<Slot> slots_;
  std::mutex mu_;
  std::condition_variable cv_;
  int64_t head_ = 0, tail_ = 0;
  bool stop_ = false;
  std::thread producer_;
};

}  // namespace

extern "C" {

void* loader_create(const uint8_t* images, const int32_t* labels, int64_t n,
                    int64_t row_bytes, int64_t batch, uint64_t seed,
                    int depth, int64_t slice_begin, int64_t slice_size,
                    int64_t start_step) {
  if (batch > n || batch <= 0 || depth <= 0 || start_step < 0) return nullptr;
  return new Loader(images, labels, n, row_bytes, batch, seed, depth,
                    slice_begin, slice_size, start_step);
}
int64_t loader_next(void* l, uint8_t* img, int32_t* lab) {
  return static_cast<Loader*>(l)->next(img, lab);
}
void loader_close(void* l) { static_cast<Loader*>(l)->close(); }
void loader_destroy(void* l) { delete static_cast<Loader*>(l); }

}  // extern "C"
