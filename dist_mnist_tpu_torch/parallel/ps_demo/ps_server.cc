// Host-side async/sync parameter server — a faithful C++ demonstration of
// the reference's PS-side machinery (SURVEY.md §2.3 rows 8-12, §2.5), kept
// OUT of the TPU training path on purpose: on TPU the entire PS role is an
// ICI all-reduce inside the compiled step. This exists to (a) document the
// protocol being replaced, (b) provide executable parity for the
// `--sync_replicas`/async modes of the original `dist_mnist.py` on hosts.
//
// Mirrored semantics, with their reference anchors:
//  * ApplyAdam update rule incl. beta-power bias correction
//    (training_ops.h ApplyAdam; adam.py:216-231): lr_t = lr *
//    sqrt(1-b2^t)/(1-b1^t); p -= lr_t * m / (sqrt(v) + eps)  [eps outside]
//  * ConditionalAccumulator (conditional_accumulator_base.h:30-46):
//    apply_grad DROPS gradients whose local_step < the accumulator's
//    current global step; take_grad(n) BLOCKS until n fresh gradients,
//    returns their average, resets, bumps the internal step.
//  * FIFOQueue sync token barrier (fifo_queue.h:34; sync protocol
//    sync_replicas_optimizer.py:72-97 and 312-322): workers block
//    dequeuing a token; the chief enqueues `tokens_per_step` tokens
//    carrying the new global step after each aggregated apply.
//  * Async mode (the reference default): push applies immediately under
//    the param lock; staleness is tolerated (bounded here for sanity).
//
// All public entry points are `extern "C"` with flat float buffers so the
// Python side binds with ctypes (no pybind11 in this image). Blocking calls
// release the GIL by construction (ctypes releases it around foreign
// calls), so Python worker THREADS get true PS-style concurrency.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <vector>

namespace {

struct AdamSlots {
  std::vector<float> m, v;
  explicit AdamSlots(size_t n) : m(n, 0.f), v(n, 0.f) {}
};

struct AdamHyper {
  double lr, b1, b2, eps;
};

// One fused pass over a flat span: the training_ops.h ApplyAdam functor.
void apply_adam(float* p, AdamSlots& s, const float* g, size_t n,
                const AdamHyper& h, int64_t t) {
  const double lr_t =
      h.lr * std::sqrt(1.0 - std::pow(h.b2, (double)t)) /
      (1.0 - std::pow(h.b1, (double)t));
  for (size_t i = 0; i < n; ++i) {
    const float gi = g[i];
    s.m[i] = (float)(h.b1 * s.m[i] + (1.0 - h.b1) * gi);
    s.v[i] = (float)(h.b2 * s.v[i] + (1.0 - h.b2) * gi * gi);
    p[i] -= (float)(lr_t * s.m[i] / (std::sqrt((double)s.v[i]) + h.eps));
  }
}

class TokenQueue {  // fifo_queue.h:34 — the sync_token_q
 public:
  void enqueue(int64_t v) {
    std::unique_lock<std::mutex> lk(mu_);
    q_.push_back(v);
    cv_.notify_one();
  }
  // Blocks until a token is available or the queue is closed (-1).
  int64_t dequeue() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [&] { return closed_ || !q_.empty(); });
    if (q_.empty()) return -1;
    int64_t v = q_.front();
    q_.pop_front();
    return v;
  }
  void close() {
    std::unique_lock<std::mutex> lk(mu_);
    closed_ = true;
    cv_.notify_all();
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<int64_t> q_;
  bool closed_ = false;
};

class Accumulator {  // conditional_accumulator_base.h:30-46 semantics
 public:
  Accumulator(size_t size, int required)
      : sum_(size, 0.f), required_(required) {}

  // Returns 1 if accepted, 0 if dropped as stale (:34-37).
  int apply_grad(const float* g, int64_t local_step) {
    std::unique_lock<std::mutex> lk(mu_);
    if (local_step < step_) {
      ++dropped_;
      return 0;
    }
    for (size_t i = 0; i < sum_.size(); ++i) sum_[i] += g[i];
    ++count_;
    cv_.notify_all();
    return 1;
  }

  // Blocks until `required_` fresh grads arrived; averages into out,
  // resets, bumps the internal step (:39-46).
  bool take_grad(float* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [&] { return closed_ || count_ >= required_; });
    if (count_ < required_) return false;  // closed
    const float inv = 1.0f / (float)count_;
    for (size_t i = 0; i < sum_.size(); ++i) {
      out[i] = sum_[i] * inv;
      sum_[i] = 0.f;
    }
    count_ = 0;
    ++step_;
    return true;
  }

  void close() {
    std::unique_lock<std::mutex> lk(mu_);
    closed_ = true;
    cv_.notify_all();
  }
  int64_t dropped() const { return dropped_.load(std::memory_order_relaxed); }

 private:
  mutable std::mutex mu_;
  std::condition_variable cv_;
  std::vector<float> sum_;
  int count_ = 0;
  const int required_;
  int64_t step_ = 0;
  std::atomic<int64_t> dropped_{0};  // read by monitors without mu_
  bool closed_ = false;
};

class ParameterServer {
 public:
  ParameterServer(const int64_t* sizes, int n_params, AdamHyper hyper,
                  int replicas_to_aggregate, int64_t staleness_bound)
      : hyper_(hyper),
        staleness_bound_(staleness_bound),
        replicas_(replicas_to_aggregate) {
    offsets_.push_back(0);
    for (int i = 0; i < n_params; ++i)
      offsets_.push_back(offsets_.back() + (size_t)sizes[i]);
    params_.assign(offsets_.back(), 0.f);
    slots_ = std::make_unique<AdamSlots>(offsets_.back());
    if (replicas_ > 0)
      acc_ = std::make_unique<Accumulator>(offsets_.back(), replicas_);
  }

  size_t total() const { return params_.size(); }

  void init(const float* flat) {
    std::unique_lock<std::mutex> lk(mu_);
    std::memcpy(params_.data(), flat, params_.size() * sizeof(float));
  }

  // Weight pull — the RecvTensor read path (worker.h:85): every worker
  // step starts by pulling the current params.
  int64_t pull(float* out) {
    std::unique_lock<std::mutex> lk(mu_);
    std::memcpy(out, params_.data(), params_.size() * sizeof(float));
    return step_;
  }

  // ASYNC push: apply immediately under the lock; drop if the gradient is
  // older than the staleness bound (the unbounded-staleness reference
  // behavior, made bounded so demos can't diverge silently).
  int push_async(const float* flat_grads, int64_t local_step) {
    std::unique_lock<std::mutex> lk(mu_);
    if (staleness_bound_ >= 0 && local_step + staleness_bound_ < step_) {
      ++dropped_;
      return 0;
    }
    ++applies_;
    apply_adam(params_.data(), *slots_, flat_grads, params_.size(), hyper_,
               applies_);
    ++step_;
    return 1;
  }

  // SYNC push: feed the accumulator (worker side of §3.4).
  int push_sync(const float* flat_grads, int64_t local_step) {
    return acc_ ? acc_->apply_grad(flat_grads, local_step) : -1;
  }

  // Chief loop body (§3.4: take_grad -> apply -> bump step -> tokens):
  // returns the new global step, or -1 on shutdown.
  int64_t chief_sync_once(int tokens_per_step) {
    if (!acc_) return -1;
    std::vector<float> avg(params_.size());
    if (!acc_->take_grad(avg.data())) return -1;
    int64_t new_step;
    {
      std::unique_lock<std::mutex> lk(mu_);
      ++applies_;
      apply_adam(params_.data(), *slots_, avg.data(), params_.size(), hyper_,
                 applies_);
      new_step = ++step_;
    }
    for (int i = 0; i < tokens_per_step; ++i) tokens_.enqueue(new_step);
    return new_step;
  }

  int64_t dequeue_token() { return tokens_.dequeue(); }
  int64_t step() const {
    std::unique_lock<std::mutex> lk(mu_);
    return step_;
  }
  int64_t dropped() const {
    std::unique_lock<std::mutex> lk(mu_);
    return dropped_ + (acc_ ? acc_->dropped() : 0);
  }
  void close() {
    tokens_.close();
    if (acc_) acc_->close();
  }

 private:
  mutable std::mutex mu_;
  std::vector<float> params_;
  std::unique_ptr<AdamSlots> slots_;
  std::vector<size_t> offsets_;
  AdamHyper hyper_;
  int64_t step_ = 0;
  int64_t applies_ = 0;
  int64_t dropped_ = 0;
  const int64_t staleness_bound_;
  const int replicas_;
  std::unique_ptr<Accumulator> acc_;
  TokenQueue tokens_;
};

}  // namespace

extern "C" {

void* ps_create(const int64_t* sizes, int n_params, double lr, double b1,
                double b2, double eps, int replicas_to_aggregate,
                int64_t staleness_bound) {
  return new ParameterServer(sizes, n_params, AdamHyper{lr, b1, b2, eps},
                             replicas_to_aggregate, staleness_bound);
}
void ps_destroy(void* ps) { delete static_cast<ParameterServer*>(ps); }
int64_t ps_total_size(void* ps) {
  return (int64_t) static_cast<ParameterServer*>(ps)->total();
}
void ps_init(void* ps, const float* flat) {
  static_cast<ParameterServer*>(ps)->init(flat);
}
int64_t ps_pull(void* ps, float* out) {
  return static_cast<ParameterServer*>(ps)->pull(out);
}
int ps_push_async(void* ps, const float* grads, int64_t local_step) {
  return static_cast<ParameterServer*>(ps)->push_async(grads, local_step);
}
int ps_push_sync(void* ps, const float* grads, int64_t local_step) {
  return static_cast<ParameterServer*>(ps)->push_sync(grads, local_step);
}
int64_t ps_chief_sync_once(void* ps, int tokens_per_step) {
  return static_cast<ParameterServer*>(ps)->chief_sync_once(tokens_per_step);
}
int64_t ps_dequeue_token(void* ps) {
  return static_cast<ParameterServer*>(ps)->dequeue_token();
}
int64_t ps_step(void* ps) { return static_cast<ParameterServer*>(ps)->step(); }
int64_t ps_dropped(void* ps) {
  return static_cast<ParameterServer*>(ps)->dropped();
}
void ps_close(void* ps) { static_cast<ParameterServer*>(ps)->close(); }

}  // extern "C"
