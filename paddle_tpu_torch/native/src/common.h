// Shared helpers for the paddle_tpu native runtime.
//
// TPU-native analogue of the reference's device-side PS machinery
// (paddle/fluid/framework/fleet/heter_ps/): TPUs have no device hashtable,
// so the sharded tables live in host RAM and run on host threads, feeding
// the chip through batched pull/push (SURVEY.md §7 "Embedding PS at TPU").
#pragma once

#include <cstdint>
#include <cstdlib>
#include <functional>
#include <thread>
#include <vector>

namespace ptn {

// Parallel-for over [0, n) in contiguous chunks. Degrades to inline
// execution when n is small or only one core is available.
inline void parallel_for(size_t n, const std::function<void(size_t, size_t)>& fn,
                         size_t min_chunk = 1024) {
  size_t hw = std::thread::hardware_concurrency();
  size_t workers = hw ? hw : 1;
  if (workers <= 1 || n <= min_chunk) {
    fn(0, n);
    return;
  }
  size_t chunks = std::min(workers, (n + min_chunk - 1) / min_chunk);
  size_t per = (n + chunks - 1) / chunks;
  std::vector<std::thread> ts;
  ts.reserve(chunks);
  for (size_t c = 0; c < chunks; ++c) {
    size_t lo = c * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// splitmix64: deterministic per-key/seed mixing for initializers & samplers.
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct XorShift128 {
  uint64_t s0, s1;
  explicit XorShift128(uint64_t seed) {
    s0 = splitmix64(seed);
    s1 = splitmix64(s0);
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  // uniform integer in [0, n)
  uint64_t bounded(uint64_t n) { return n ? next() % n : 0; }
};

// Flat open-addressing map (int64 key -> dense int32 index): linear
// probing over power-of-2 slots with a splitmix64 hash. Per-key find is
// the hot operation of both the graph store (node/hop lookups) and the
// sparse tables (pull/push), and std::unordered_map's bucket chasing
// costs ~2-3 cache misses per find where this costs one (plus probes at
// 0.5 max load). No per-key deletion — callers clear or rebuild
// wholesale, matching both stores' lifecycles.
class FlatI64Map {
 public:
  void Clear() {
    keys_.clear();
    vals_.clear();
    mask_ = 0;
    size_ = 0;
  }

  uint64_t Size() const { return size_; }

  // Insert key if absent; returns the dense index either way. `next_idx`
  // is the index a NEW key receives (typically the caller's arena size).
  int32_t InsertOrGet(int64_t key, int32_t next_idx) {
    // dense indices are int32 with -1-as-empty: past 2^31-1 rows a
    // negative index would read as an empty slot and silently corrupt
    // the map — fail loudly instead (a shard that big must be split)
    if (next_idx < 0) {
      std::abort();
    }
    if (size_ * 2 >= Capacity()) Grow();
    uint64_t h = splitmix64(static_cast<uint64_t>(key)) & mask_;
    while (vals_[h] >= 0) {
      if (keys_[h] == key) return vals_[h];
      h = (h + 1) & mask_;
    }
    keys_[h] = key;
    vals_[h] = next_idx;
    ++size_;
    return next_idx;
  }

  // Dense index of key, or -1.
  int32_t Find(int64_t key) const {
    if (mask_ == 0) return -1;
    uint64_t h = splitmix64(static_cast<uint64_t>(key)) & mask_;
    while (vals_[h] >= 0) {
      if (keys_[h] == key) return vals_[h];
      h = (h + 1) & mask_;
    }
    return -1;
  }

  // Visit every (key, index) pair; insertion order is NOT preserved.
  template <typename Fn>
  void ForEach(Fn&& fn) const {
    for (size_t i = 0; i < vals_.size(); ++i) {
      if (vals_[i] >= 0) fn(keys_[i], vals_[i]);
    }
  }

  // Like ForEach, but stops as soon as ``fn`` returns false.
  template <typename Fn>
  void ForEachUntil(Fn&& fn) const {
    for (size_t i = 0; i < vals_.size(); ++i) {
      if (vals_[i] >= 0 && !fn(keys_[i], vals_[i])) return;
    }
  }

  // Pre-size for ``n`` keys (capacity = next pow2 keeping load <= 0.5),
  // avoiding intermediate rehashes on bulk builds. Only ever grows.
  void Reserve(uint64_t n) {
    uint64_t want = 1024;
    while (want < 2 * n) want <<= 1;
    if (want > Capacity()) GrowTo(want);
  }

 private:
  uint64_t Capacity() const { return vals_.empty() ? 0 : mask_ + 1; }

  void Grow() { GrowTo(vals_.empty() ? 1024 : (mask_ + 1) * 2); }

  void GrowTo(uint64_t cap) {
    std::vector<int64_t> old_k = std::move(keys_);
    std::vector<int32_t> old_v = std::move(vals_);
    keys_.assign(cap, 0);
    vals_.assign(cap, -1);
    mask_ = cap - 1;
    for (size_t i = 0; i < old_v.size(); ++i) {
      if (old_v[i] < 0) continue;
      uint64_t h = splitmix64(static_cast<uint64_t>(old_k[i])) & mask_;
      while (vals_[h] >= 0) h = (h + 1) & mask_;
      keys_[h] = old_k[i];
      vals_[h] = old_v[i];
    }
  }

  std::vector<int64_t> keys_;
  std::vector<int32_t> vals_;  // -1 = empty slot
  uint64_t mask_ = 0;
  uint64_t size_ = 0;
};

}  // namespace ptn
