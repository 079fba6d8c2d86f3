// Sharded in-memory sparse embedding table with C++ optimizer rules.
//
// TPU-native rebuild of the reference's GPU parameter server
// (paddle/fluid/framework/fleet/heter_ps/: HeterComm `heter_comm.h:52`,
// GPU hashtable `hashtable_kernel.cu`, device optimizers `optimizer.cuh.h`)
// and the brpc-side tables (paddle/fluid/distributed/ps/table/
// memory_sparse_table.cc, sparse_sgd_rule.cc). TPUs have no device-resident
// hashtable, so the table lives in host RAM, sharded for thread-parallel
// pull/push; the chip sees dense gathered minibatch embeddings via JAX
// callbacks (see python/paddle_tpu/distributed/ps/).
//
// Value layout per key:
//   embedding: dim floats
//   optimizer state appended: SGD none | AdaGrad dim (g2sum) |
//   Adam 2*dim + 2 (m, v, beta1^t, beta2^t)
// plus two usage floats [show, click] feeding shrink()'s decayed
// ShowClickScore, mirroring the CTR accessors
// (table/ctr_common_accessor.h: Show/Click/ShowClickScore).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "common.h"

namespace {

enum OptimizerKind : int32_t {
  kSGD = 0,
  kAdaGrad = 1,
  kAdam = 2,
};

struct TableConfig {
  int32_t dim = 8;
  int32_t optimizer = kAdaGrad;
  float lr = 0.05f;
  float initial_range = 0.01f;
  float beta1 = 0.9f;
  float beta2 = 0.999f;
  float eps = 1e-8f;
  uint64_t seed = 0;
  int32_t num_shards = 16;
  // Shrink score = show_coeff*show + click_coeff*click — the CTR
  // accessor's ShowClickScore (table/ctr_common_accessor.h).
  float show_coeff = 1.0f;
  float click_coeff = 1.0f;
};

struct Shard {
  // key -> index into `values` arena (in units of value_width); flat
  // open-addressing map — per-key find is the pull/push hot operation
  ptn::FlatI64Map index;
  std::vector<float> values;
  std::mutex mu;
};

class SparseTable {
 public:
  explicit SparseTable(const TableConfig& cfg) : cfg_(cfg), shards_(cfg.num_shards) {}

  int32_t dim() const { return cfg_.dim; }

  void SetLr(float lr) { cfg_.lr = lr; }

  void SetScoreCoeffs(float show_coeff, float click_coeff) {
    cfg_.show_coeff = show_coeff;
    cfg_.click_coeff = click_coeff;
  }

  int32_t value_width() const {
    // +2 = [show, click]; Adam appends [beta1^t, beta2^t] after them.
    switch (cfg_.optimizer) {
      case kSGD: return cfg_.dim + 2;
      case kAdaGrad: return 2 * cfg_.dim + 2;
      case kAdam: return 3 * cfg_.dim + 4;
    }
    return cfg_.dim + 2;
  }

  size_t shard_of(int64_t key) const {
    return ptn::splitmix64(static_cast<uint64_t>(key)) % shards_.size();
  }

  // Gather embeddings for n keys into out[n * dim]; missing keys are
  // initialized uniform(-initial_range, initial_range), deterministically
  // from (table seed, key) — analogous to the sgd-rule init_value paths
  // (table/sparse_sgd_rule.cc).
  void Pull(const int64_t* keys, int64_t n, float* out) {
    ptn::parallel_for(static_cast<size_t>(n), [&](size_t lo, size_t hi) {
      for (size_t i = lo; i < hi; ++i) {
        int64_t key = keys[i];
        Shard& sh = shards_[shard_of(key)];
        std::lock_guard<std::mutex> g(sh.mu);
        float* v = FindOrInit(sh, key);
        std::memcpy(out + i * cfg_.dim, v, sizeof(float) * cfg_.dim);
        v[show_offset()] += 1.0f;
      }
    }, 256);
  }

  // Apply grads for n keys. grads[n * dim]. Each shard's keys are applied
  // by one thread in batch order, so duplicate keys within the batch apply
  // serially in that order and a push is deterministic.
  void Push(const int64_t* keys, const float* grads, int64_t n) {
    ForEachByShard(keys, n, [&](Shard& sh, size_t i) {
      ApplyRule(FindOrInit(sh, keys[i]), grads + i * cfg_.dim);
    });
  }

  // Add raw deltas to embeddings, bypassing the optimizer rule — the geo
  // communicator ships locally-trained parameter deltas, which servers
  // merge additively (GeoCommunicator, communicator.h:596).
  void PushRaw(const int64_t* keys, const float* deltas, int64_t n) {
    ForEachByShard(keys, n, [&](Shard& sh, size_t i) {
      float* v = FindOrInit(sh, keys[i]);
      const float* d = deltas + i * cfg_.dim;
      for (int32_t j = 0; j < cfg_.dim; ++j) v[j] += d[j];
    });
  }

  // Accumulate CTR usage statistics: sc[2*i] shows, sc[2*i+1] clicks per
  // key (the reference pushes these alongside gradients; here they ride a
  // dedicated op).
  void PushShowClick(const int64_t* keys, const float* sc, int64_t n) {
    ForEachByShard(keys, n, [&](Shard& sh, size_t i) {
      float* v = FindOrInit(sh, keys[i]);
      v[show_offset()] += sc[2 * i];
      v[show_offset() + 1] += sc[2 * i + 1];
    });
  }

  // Size/Keys/Save/Load/Clear take each shard's mutex: they may run from
  // host threads while Pull/Push mutate shards from JAX callback threads,
  // and FindOrInit's insert/resize invalidates iterators and value pointers.
  int64_t Size() const {
    int64_t total = 0;
    for (auto& sh : shards_) {
      std::lock_guard<std::mutex> g(sh.mu);
      total += static_cast<int64_t>(sh.index.Size());
    }
    return total;
  }

  // Copy up to cap keys into out; returns count written.
  int64_t Keys(int64_t* out, int64_t cap) const {
    int64_t w = 0;
    for (auto& sh : shards_) {
      std::lock_guard<std::mutex> g(sh.mu);
      sh.index.ForEachUntil([&](int64_t key, int32_t) {
        if (w >= cap) return false;
        out[w++] = key;
        return true;
      });
      if (w >= cap) return w;
    }
    return w;
  }

  // Drop keys whose decayed ShowClickScore < threshold; both counters
  // halve each call (cf. MemorySparseTable::Shrink + CtrCommonAccessor's
  // show/click decay).
  int64_t Shrink(float threshold) {
    std::atomic<int64_t> dropped{0};
    ptn::parallel_for(shards_.size(), [&](size_t lo, size_t hi) {
      for (size_t s = lo; s < hi; ++s) {
        Shard& sh = shards_[s];
        std::lock_guard<std::mutex> g(sh.mu);
        ptn::FlatI64Map keep;
        keep.Reserve(sh.index.Size());  // survivors <= current rows
        std::vector<float> values;
        const int32_t w = value_width();
        sh.index.ForEach([&](int64_t key, int32_t at) {
          float* v = sh.values.data() + static_cast<size_t>(at) * w;
          const float score = cfg_.show_coeff * v[show_offset()] +
                              cfg_.click_coeff * v[show_offset() + 1];
          if (score >= threshold) {
            int32_t idx = static_cast<int32_t>(keep.Size());
            keep.InsertOrGet(key, idx);
            values.insert(values.end(), v, v + w);
            values[static_cast<size_t>(idx) * w + show_offset()] *= 0.5f;
            values[static_cast<size_t>(idx) * w + show_offset() + 1] *= 0.5f;
          } else {
            dropped.fetch_add(1, std::memory_order_relaxed);
          }
        });
        sh.index = std::move(keep);
        sh.values.swap(values);
      }
    }, 1);
    return dropped.load();
  }

  // Binary snapshot: [magic, value_width, count, (key, value_width floats)*].
  int32_t Save(const char* path) const {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    const uint64_t magic = 0x5054424c45303246ULL;  // "PTBLE02F" (02: +click in value layout)
    const int32_t w = value_width();
    // Hold ALL shard locks for the duration so the header count matches the
    // rows written even with pushes in flight (consistent snapshot).
    std::vector<std::unique_lock<std::mutex>> locks;
    locks.reserve(shards_.size());
    uint64_t count = 0;
    for (auto& sh : shards_) {
      locks.emplace_back(sh.mu);
      count += static_cast<uint64_t>(sh.index.Size());
    }
    std::fwrite(&magic, sizeof(magic), 1, f);
    std::fwrite(&w, sizeof(w), 1, f);
    std::fwrite(&count, sizeof(count), 1, f);
    for (auto& sh : shards_) {
      sh.index.ForEach([&](int64_t key, int32_t at) {
        const float* v = sh.values.data() + static_cast<size_t>(at) * w;
        std::fwrite(&key, sizeof(int64_t), 1, f);
        std::fwrite(v, sizeof(float), w, f);
      });
    }
    std::fclose(f);
    return 0;
  }

  // merge_only: insert snapshot rows only for keys absent from RAM — the
  // begin_pass warm-reload mode, which must not roll live rows back to
  // snapshot values (cf. SSDSparseTable pass lifecycle).
  int32_t Load(const char* path, bool merge_only = false) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    uint64_t magic = 0;
    int32_t w = 0;
    uint64_t count = 0;
    if (std::fread(&magic, sizeof(magic), 1, f) != 1 ||
        magic != 0x5054424c45303246ULL ||
        std::fread(&w, sizeof(w), 1, f) != 1 || w != value_width() ||
        std::fread(&count, sizeof(count), 1, f) != 1) {
      std::fclose(f);
      return -2;
    }
    std::vector<float> buf(w);
    for (uint64_t i = 0; i < count; ++i) {
      int64_t key;
      if (std::fread(&key, sizeof(key), 1, f) != 1 ||
          std::fread(buf.data(), sizeof(float), w, f) != static_cast<size_t>(w)) {
        std::fclose(f);
        return -3;
      }
      Shard& sh = shards_[shard_of(key)];
      std::lock_guard<std::mutex> g(sh.mu);
      int32_t found = sh.index.Find(key);
      uint32_t idx;
      if (found < 0) {
        idx = static_cast<uint32_t>(sh.index.Size());
        sh.index.InsertOrGet(key, static_cast<int32_t>(idx));
        sh.values.resize(static_cast<size_t>(idx + 1) * w);
      } else if (merge_only) {
        continue;  // live RAM row wins over snapshot
      } else {
        idx = static_cast<uint32_t>(found);
      }
      std::memcpy(sh.values.data() + static_cast<size_t>(idx) * w, buf.data(),
                  sizeof(float) * w);
    }
    std::fclose(f);
    return 0;
  }

  void Clear() {
    for (auto& sh : shards_) {
      std::lock_guard<std::mutex> g(sh.mu);
      sh.index.Clear();
      sh.values.clear();
    }
  }

 private:
  // fn(shard, i) for every i < n, under the shard's mutex. Keys are grouped
  // by shard (a stable counting sort), and each shard's keys are visited in
  // batch order by one worker thread, the shards spread over the workers.
  // A batch of at most 256 keys runs on the calling thread.
  template <class Fn>
  void ForEachByShard(const int64_t* keys, int64_t n, Fn&& fn) {
    if (n <= 256) {
      for (int64_t i = 0; i < n; ++i) {
        Shard& sh = shards_[shard_of(keys[i])];
        std::lock_guard<std::mutex> g(sh.mu);
        fn(sh, static_cast<size_t>(i));
      }
      return;
    }
    const size_t ns = shards_.size();
    std::vector<uint32_t> sid(static_cast<size_t>(n));
    std::vector<size_t> start(ns + 1, 0);
    for (int64_t i = 0; i < n; ++i) {
      sid[i] = static_cast<uint32_t>(shard_of(keys[i]));
      ++start[sid[i] + 1];
    }
    for (size_t s = 0; s < ns; ++s) start[s + 1] += start[s];
    std::vector<size_t> order(static_cast<size_t>(n));
    std::vector<size_t> fill(start.begin(), start.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[fill[sid[i]]++] = static_cast<size_t>(i);
    ptn::parallel_for(ns, [&](size_t lo, size_t hi) {
      for (size_t s = lo; s < hi; ++s) {
        Shard& sh = shards_[s];
        std::lock_guard<std::mutex> g(sh.mu);
        for (size_t j = start[s]; j < start[s + 1]; ++j) fn(sh, order[j]);
      }
    }, 1);
  }

  // [show, click] sit at the tail, before Adam's [beta1^t, beta2^t].
  int32_t show_offset() const { return value_width() - 2 - (cfg_.optimizer == kAdam ? 2 : 0); }

  // Adam scalar state lives at the tail: [beta1^t, beta2^t].
  float* FindOrInit(Shard& sh, int64_t key) {
    const int32_t w = value_width();
    const int32_t found = sh.index.Find(key);
    if (found >= 0) {
      return sh.values.data() + static_cast<size_t>(found) * w;
    }
    uint32_t idx = static_cast<uint32_t>(sh.index.Size());
    sh.index.InsertOrGet(key, static_cast<int32_t>(idx));
    sh.values.resize(static_cast<size_t>(idx + 1) * w, 0.0f);
    float* v = sh.values.data() + static_cast<size_t>(idx) * w;
    ptn::XorShift128 rng(ptn::splitmix64(cfg_.seed) ^ static_cast<uint64_t>(key));
    for (int32_t d = 0; d < cfg_.dim; ++d) {
      v[d] = static_cast<float>((rng.uniform() * 2.0 - 1.0) * cfg_.initial_range);
    }
    if (cfg_.optimizer == kAdam) {
      v[w - 2] = 1.0f;  // beta1^t accumulator starts at 1 (pre-step)
      v[w - 1] = 1.0f;
    }
    return v;
  }

  void ApplyRule(float* v, const float* g) {
    const int32_t dim = cfg_.dim;
    switch (cfg_.optimizer) {
      case kSGD: {
        for (int32_t d = 0; d < dim; ++d) v[d] -= cfg_.lr * g[d];
        break;
      }
      case kAdaGrad: {
        float* g2 = v + dim;
        for (int32_t d = 0; d < dim; ++d) {
          g2[d] += g[d] * g[d];
          v[d] -= cfg_.lr * g[d] / (std::sqrt(g2[d]) + cfg_.eps);
        }
        break;
      }
      case kAdam: {
        const int32_t w = value_width();
        float* m = v + dim;
        float* vv = v + 2 * dim;
        v[w - 2] *= cfg_.beta1;
        v[w - 1] *= cfg_.beta2;
        const float bc1 = 1.0f - v[w - 2];
        const float bc2 = 1.0f - v[w - 1];
        for (int32_t d = 0; d < dim; ++d) {
          m[d] = cfg_.beta1 * m[d] + (1.0f - cfg_.beta1) * g[d];
          vv[d] = cfg_.beta2 * vv[d] + (1.0f - cfg_.beta2) * g[d] * g[d];
          const float mhat = m[d] / bc1;
          const float vhat = vv[d] / bc2;
          v[d] -= cfg_.lr * mhat / (std::sqrt(vhat) + cfg_.eps);
        }
        break;
      }
    }
  }

  TableConfig cfg_;
  mutable std::vector<Shard> shards_;
};

// Dense parameter table: one contiguous float vector with a server-side
// update rule — the reference's MemoryDenseTable
// (paddle/fluid/distributed/ps/table/memory_dense_table.cc), which holds
// the model's dense weights on PS servers in async/geo modes. Sharding
// across servers is client-side (contiguous blocks), so each server's
// table is just its block. Rules: sum (raw accumulate), sgd, adagrad —
// the step-free subset (Adam's bias correction needs a coherent global
// step, which blockwise pushes don't have).
class DenseTable {
 public:
  DenseTable(int64_t len, int32_t optimizer, float lr, float eps)
      : optimizer_(optimizer), lr_(lr), eps_(eps), values_(len, 0.0f) {
    if (optimizer_ == kAdaGrad) g2sum_.assign(len, 0.0f);
  }

  int64_t len() const { return static_cast<int64_t>(values_.size()); }
  void SetLr(float lr) {
    std::lock_guard<std::mutex> g(mu_);
    lr_ = lr;
  }

  int32_t Get(int64_t off, int64_t n, float* out) const {
    std::lock_guard<std::mutex> g(mu_);
    if (!InRange(off, n)) return -1;
    std::memcpy(out, values_.data() + off, sizeof(float) * n);
    return 0;
  }

  int32_t Set(int64_t off, int64_t n, const float* vals) {
    std::lock_guard<std::mutex> g(mu_);
    if (!InRange(off, n)) return -1;
    std::memcpy(values_.data() + off, vals, sizeof(float) * n);
    return 0;
  }

  int32_t Push(int64_t off, int64_t n, const float* grad) {
    std::lock_guard<std::mutex> g(mu_);
    if (!InRange(off, n)) return -1;
    float* v = values_.data() + off;
    switch (optimizer_) {
      case kSGD:
        for (int64_t i = 0; i < n; ++i) v[i] -= lr_ * grad[i];
        break;
      case kAdaGrad: {
        float* g2 = g2sum_.data() + off;
        for (int64_t i = 0; i < n; ++i) {
          g2[i] += grad[i] * grad[i];
          v[i] -= lr_ * grad[i] / (std::sqrt(g2[i]) + eps_);
        }
        break;
      }
      default:  // sum: raw accumulate (geo deltas / summary stats)
        for (int64_t i = 0; i < n; ++i) v[i] += grad[i];
        break;
    }
    return 0;
  }

  int32_t Save(const char* path) const {
    std::lock_guard<std::mutex> g(mu_);
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    const uint64_t magic = 0x5054444e53453032ULL;  // "PTDNSE02"
    uint64_t n = values_.size();
    std::fwrite(&magic, sizeof(magic), 1, f);
    std::fwrite(&n, sizeof(n), 1, f);
    std::fwrite(&optimizer_, sizeof(optimizer_), 1, f);
    std::fwrite(&lr_, sizeof(lr_), 1, f);
    std::fwrite(values_.data(), sizeof(float), values_.size(), f);
    uint8_t has_g2 = g2sum_.empty() ? 0 : 1;
    std::fwrite(&has_g2, 1, 1, f);
    if (has_g2) std::fwrite(g2sum_.data(), sizeof(float), g2sum_.size(), f);
    std::fclose(f);
    return 0;
  }

  int32_t Load(const char* path) {
    std::lock_guard<std::mutex> g(mu_);
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    uint64_t magic = 0, n = 0;
    int32_t opt = 0;
    float lr = 0;
    if (std::fread(&magic, sizeof(magic), 1, f) != 1 ||
        magic != 0x5054444e53453032ULL ||
        std::fread(&n, sizeof(n), 1, f) != 1 || n != values_.size() ||
        std::fread(&opt, sizeof(opt), 1, f) != 1 ||
        std::fread(&lr, sizeof(lr), 1, f) != 1) {
      std::fclose(f);
      return -2;
    }
    if (std::fread(values_.data(), sizeof(float), n, f) != n) {
      std::fclose(f);
      return -3;
    }
    uint8_t has_g2 = 0;
    if (std::fread(&has_g2, 1, 1, f) == 1 && has_g2 && !g2sum_.empty()) {
      if (std::fread(g2sum_.data(), sizeof(float), n, f) != n) {
        std::fclose(f);
        return -3;
      }
    }
    std::fclose(f);
    return 0;
  }

 private:
  // Overflow-proof range check: n > len() - off avoids the signed
  // overflow of off + n for wire-supplied offsets.
  bool InRange(int64_t off, int64_t n) const {
    return off >= 0 && n >= 0 && off <= len() && n <= len() - off;
  }

  int32_t optimizer_;
  float lr_;
  float eps_;
  std::vector<float> values_;
  std::vector<float> g2sum_;
  mutable std::mutex mu_;

 public:
  int32_t optimizer() const { return optimizer_; }
  float lr() const {
    std::lock_guard<std::mutex> g(mu_);
    return lr_;
  }
};

}  // namespace

extern "C" {

void* pt_dense_create(int64_t len, int32_t optimizer, float lr, float eps) {
  return new DenseTable(len, optimizer, lr, eps);
}

// Reconstruct a dense table from its snapshot alone (the restarting
// server's path: the sidecar stores len/optimizer/lr, so no client
// dense_init is needed before restore). Returns null on failure.
void* pt_dense_create_from_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  uint64_t magic = 0, n = 0;
  int32_t opt = 0;
  float lr = 0;
  if (std::fread(&magic, sizeof(magic), 1, f) != 1 ||
      magic != 0x5054444e53453032ULL ||
      std::fread(&n, sizeof(n), 1, f) != 1 ||
      std::fread(&opt, sizeof(opt), 1, f) != 1 ||
      std::fread(&lr, sizeof(lr), 1, f) != 1) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  auto* t = new DenseTable(static_cast<int64_t>(n), opt, lr, 1e-8f);
  if (t->Load(path) != 0) {
    delete t;
    return nullptr;
  }
  return t;
}

int32_t pt_dense_optimizer(void* h) {
  return static_cast<DenseTable*>(h)->optimizer();
}
void pt_dense_destroy(void* h) { delete static_cast<DenseTable*>(h); }
int64_t pt_dense_len(void* h) { return static_cast<DenseTable*>(h)->len(); }
void pt_dense_set_lr(void* h, float lr) {
  static_cast<DenseTable*>(h)->SetLr(lr);
}
int32_t pt_dense_get(void* h, int64_t off, int64_t n, float* out) {
  return static_cast<DenseTable*>(h)->Get(off, n, out);
}
int32_t pt_dense_set(void* h, int64_t off, int64_t n, const float* vals) {
  return static_cast<DenseTable*>(h)->Set(off, n, vals);
}
int32_t pt_dense_push(void* h, int64_t off, int64_t n, const float* grad) {
  return static_cast<DenseTable*>(h)->Push(off, n, grad);
}
int32_t pt_dense_save(void* h, const char* path) {
  return static_cast<DenseTable*>(h)->Save(path);
}
int32_t pt_dense_load(void* h, const char* path) {
  return static_cast<DenseTable*>(h)->Load(path);
}

void* pt_table_create(int32_t dim, int32_t optimizer, float lr,
                      float initial_range, float beta1, float beta2, float eps,
                      uint64_t seed, int32_t num_shards) {
  TableConfig cfg;
  cfg.dim = dim;
  cfg.optimizer = optimizer;
  cfg.lr = lr;
  cfg.initial_range = initial_range;
  cfg.beta1 = beta1;
  cfg.beta2 = beta2;
  cfg.eps = eps;
  cfg.seed = seed;
  cfg.num_shards = num_shards > 0 ? num_shards : 16;
  return new SparseTable(cfg);
}

// ShowClickScore coefficients (CtrCommonAccessor show_coeff/click_coeff).
void pt_table_set_score_coeffs(void* h, float show_coeff, float click_coeff) {
  static_cast<SparseTable*>(h)->SetScoreCoeffs(show_coeff, click_coeff);
}

void pt_table_destroy(void* h) { delete static_cast<SparseTable*>(h); }

void pt_table_pull(void* h, const int64_t* keys, int64_t n, float* out) {
  static_cast<SparseTable*>(h)->Pull(keys, n, out);
}

void pt_table_push(void* h, const int64_t* keys, const float* grads, int64_t n) {
  static_cast<SparseTable*>(h)->Push(keys, grads, n);
}

void pt_table_push_raw(void* h, const int64_t* keys, const float* deltas,
                       int64_t n) {
  static_cast<SparseTable*>(h)->PushRaw(keys, deltas, n);
}

void pt_table_push_show_click(void* h, const int64_t* keys, const float* sc,
                              int64_t n) {
  static_cast<SparseTable*>(h)->PushShowClick(keys, sc, n);
}

int64_t pt_table_size(void* h) { return static_cast<SparseTable*>(h)->Size(); }

int64_t pt_table_keys(void* h, int64_t* out, int64_t cap) {
  return static_cast<SparseTable*>(h)->Keys(out, cap);
}

int64_t pt_table_shrink(void* h, float threshold) {
  return static_cast<SparseTable*>(h)->Shrink(threshold);
}

int32_t pt_table_save(void* h, const char* path) {
  return static_cast<SparseTable*>(h)->Save(path);
}

int32_t pt_table_load(void* h, const char* path) {
  return static_cast<SparseTable*>(h)->Load(path);
}

// Insert-missing-only reload (begin_pass warm-up without rolling back rows
// updated since the last end_pass snapshot).
int32_t pt_table_load_merge(void* h, const char* path) {
  return static_cast<SparseTable*>(h)->Load(path, /*merge_only=*/true);
}

void pt_table_clear(void* h) { static_cast<SparseTable*>(h)->Clear(); }

int32_t pt_table_dim(void* h) { return static_cast<SparseTable*>(h)->dim(); }

// lr setter so Python LR schedules drive the C++ rule (the reference plumbs
// this through sgd-rule `learning_rate`, table/sparse_sgd_rule.cc).
void pt_table_set_lr(void* h, float lr) {
  static_cast<SparseTable*>(h)->SetLr(lr);
}
}
