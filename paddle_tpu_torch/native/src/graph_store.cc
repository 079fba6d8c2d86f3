// CSR graph store with thread-parallel neighbor sampling and random walks.
//
// TPU-native rebuild of the reference's GPU graph engine:
//   - GpuPsGraphTable CSR store + graph_neighbor_sample_v2
//     (paddle/fluid/framework/fleet/heter_ps/graph_gpu_ps_table.h:32,128-134)
//   - walk kernel GraphDoWalkKernel / FillWalkBuf
//     (paddle/fluid/framework/data_feed.cu:708,883)
//   - CPU-side CommonGraphTable (paddle/fluid/distributed/ps/table/
//     common_graph_table.cc)
// On TPU the sampler runs on host threads (no device hashtable); sampled
// batches are padded to static shapes before they ever reach XLA, which is
// the dynamic-shape strategy SURVEY.md §7 calls for ("bucketing + padding
// designed in the data layer").
//
// Node ids are arbitrary int64; internally remapped to dense int32. Padding
// value for absent neighbors / terminated walks is -1.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <shared_mutex>
#include <vector>

#include "common.h"

namespace {

class GraphStore {
 public:
  // Edge ingestion happens pre-Build into COO buffers. Ingest ops take
  // the adjacency lock exclusively; read ops share it — two clients of one
  // server (one rebuilding, one sampling) must never race a CSR free.
  // `w` may be null (unweighted); mixing weighted and unweighted calls
  // treats missing weights as 1.0 (the reference's default edge weight).
  void AddEdges(const int64_t* src, const int64_t* dst, const float* w,
                int64_t n) {
    std::unique_lock<std::shared_mutex> g(adj_mu_);
    coo_src_.insert(coo_src_.end(), src, src + n);
    coo_dst_.insert(coo_dst_.end(), dst, dst + n);
    if (w) {
      coo_w_.resize(coo_src_.size() - n, 1.0f);  // backfill earlier edges
      coo_w_.insert(coo_w_.end(), w, w + n);
    } else if (!coo_w_.empty()) {
      coo_w_.resize(coo_src_.size(), 1.0f);
    }
    // NOTE: weighted_ flips only inside Build() (under the exclusive
    // lock): queries must never see weighted_ == true against a CSR whose
    // cumw_ was built unweighted.
  }

  // Drop the COO buffer (and derived CSR): the sharded client re-sends its
  // full edge buffer on every build, so servers must start clean.
  void ClearEdges() {
    std::unique_lock<std::shared_mutex> g(adj_mu_);
    coo_src_.clear();
    coo_dst_.clear();
    coo_w_.clear();
    weighted_ = false;
    id_of_.Clear();
    ids_.clear();
    row_ptr_.clear();
    col_.clear();
    csr_w_.clear();
    cumw_.clear();
  }

  // Rebuildable: the COO edge list is retained, so add_edges -> build ->
  // add_edges -> build accumulates (the CSR is derived state).
  void Build(bool symmetric) {
    std::unique_lock<std::shared_mutex> g(adj_mu_);
    weighted_ = !coo_w_.empty();
    const size_t n = coo_src_.size();
    // Dense remap.
    id_of_.Clear();
    ids_.clear();
    auto intern = [&](int64_t k) -> int32_t {
      const int32_t next = static_cast<int32_t>(ids_.size());
      int32_t idx = id_of_.InsertOrGet(k, next);
      if (idx == next) ids_.push_back(k);
      return idx;
    };
    const size_t m = symmetric ? 2 * n : n;
    std::vector<int32_t> s(m), d(m);
    for (size_t i = 0; i < n; ++i) {
      s[i] = intern(coo_src_[i]);
      d[i] = intern(coo_dst_[i]);
    }
    if (symmetric) {
      for (size_t i = 0; i < n; ++i) {
        s[n + i] = d[i];
        d[n + i] = s[i];
      }
    }
    const size_t nn = ids_.size();
    row_ptr_.assign(nn + 1, 0);
    for (int32_t u : s) row_ptr_[static_cast<size_t>(u) + 1]++;
    for (size_t i = 0; i < nn; ++i) row_ptr_[i + 1] += row_ptr_[i];
    col_.resize(m);
    csr_w_.clear();
    cumw_.clear();
    if (weighted_) csr_w_.resize(m, 1.0f);
    std::vector<int64_t> cursor(row_ptr_.begin(), row_ptr_.end() - 1);
    for (size_t i = 0; i < m; ++i) {
      int64_t slot = cursor[s[i]]++;
      col_[static_cast<size_t>(slot)] = d[i];
      if (weighted_) {
        // reverse edges (i >= n) reuse the forward edge's weight; weights
        // clamp to a positive floor so a zero/negative weight degrades to
        // "effectively never" instead of corrupting the CDF scan (all
        // weighted paths share this clamp)
        float w = coo_w_.empty() ? 1.0f : coo_w_[i % n];
        csr_w_[static_cast<size_t>(slot)] = w > 1e-12f ? w : 1e-12f;
      }
    }
    if (weighted_) {
      // per-row cumulative weights: draws and hops become one binary
      // search instead of an O(deg) scan per draw
      cumw_.resize(m);
      for (size_t r = 0; r + 1 < row_ptr_.size(); ++r) {
        double acc = 0.0;
        for (int64_t j = row_ptr_[r]; j < row_ptr_[r + 1]; ++j) {
          acc += csr_w_[j];
          cumw_[j] = acc;
        }
      }
    }
  }

  // index into [beg, end) whose (row-local) cumulative weight first
  // exceeds target mass u — cumw_ resets at each row start
  int64_t WeightedPick(int64_t beg, int64_t end, double u) const {
    int64_t lo = beg, hi = end - 1;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (cumw_[mid] > u) hi = mid; else lo = mid + 1;
    }
    return lo;
  }

  int64_t NumNodes() const {
    std::shared_lock<std::shared_mutex> g(adj_mu_);
    return static_cast<int64_t>(ids_.size());
  }
  int64_t NumEdges() const {
    std::shared_lock<std::shared_mutex> g(adj_mu_);
    return static_cast<int64_t>(col_.size());
  }

  int64_t NodeIds(int64_t* out, int64_t cap) const {
    std::shared_lock<std::shared_mutex> g(adj_mu_);
    int64_t w = std::min<int64_t>(cap, static_cast<int64_t>(ids_.size()));
    std::memcpy(out, ids_.data(), sizeof(int64_t) * w);
    return w;
  }

  int64_t Degree(int64_t key) const {
    std::shared_lock<std::shared_mutex> g(adj_mu_);
    const int32_t di = id_of_.Find(key);
    if (di < 0) return 0;
    return row_ptr_[di + 1] - row_ptr_[di];
  }

  // Sample up to k neighbors for each of n query nodes into out[n*k]
  // (padded -1); counts[n] = actual neighbor count sampled. replace=0 uses
  // partial Fisher-Yates without replacement (matches neighbor_sample_v2
  // semantics); unknown nodes get count 0.
  void SampleNeighbors(const int64_t* nodes, int64_t n, int32_t k,
                       int32_t replace, uint64_t seed, int64_t* out,
                       int32_t* counts) const {
    std::shared_lock<std::shared_mutex> g(adj_mu_);
    ptn::parallel_for(static_cast<size_t>(n), [&](size_t lo, size_t hi) {
      for (size_t i = lo; i < hi; ++i) {
        int64_t* row = out + i * k;
        std::fill(row, row + k, int64_t{-1});
        counts[i] = 0;
        const int32_t di = id_of_.Find(nodes[i]);
        if (di < 0) continue;
        const int64_t beg = row_ptr_[di], end = row_ptr_[di + 1];
        const int64_t deg = end - beg;
        if (deg == 0) continue;
        ptn::XorShift128 rng(ptn::splitmix64(seed) ^
                             ptn::splitmix64(static_cast<uint64_t>(nodes[i])));
        if (replace || deg <= k) {
          if (replace) {
            if (!weighted_) {
              for (int32_t j = 0; j < k; ++j) {
                row[j] =
                    ids_[col_[beg + static_cast<int64_t>(rng.bounded(deg))]];
              }
            } else {
              const double total = cumw_[end - 1];
              for (int32_t j = 0; j < k; ++j) {
                double u = rng.uniform() * total;
                row[j] = ids_[col_[WeightedPick(beg, end, u)]];
              }
            }
            counts[i] = k;
          } else {
            for (int64_t j = 0; j < deg; ++j) row[j] = ids_[col_[beg + j]];
            counts[i] = static_cast<int32_t>(deg);
          }
        } else if (!weighted_) {
          // Reservoir sample k of deg without replacement.
          std::vector<int64_t> res(k);
          for (int32_t j = 0; j < k; ++j) res[j] = col_[beg + j];
          for (int64_t j = k; j < deg; ++j) {
            uint64_t r = rng.bounded(static_cast<uint64_t>(j + 1));
            if (r < static_cast<uint64_t>(k)) res[r] = col_[beg + j];
          }
          for (int32_t j = 0; j < k; ++j) row[j] = ids_[res[j]];
          counts[i] = k;
        } else {
          // Weighted without replacement: A-Res (Efraimidis-Spirakis) —
          // keep the k largest keys u^(1/w); O(deg*k) is fine for small k.
          std::vector<double> keys(k, -1.0);
          std::vector<int64_t> res(k, -1);
          for (int64_t j = beg; j < end; ++j) {
            double w = csr_w_[j];  // clamped positive at Build
            double key = std::pow(rng.uniform(), 1.0 / w);
            int32_t lo = 0;
            for (int32_t t = 1; t < k; ++t) {
              if (keys[t] < keys[lo]) lo = t;
            }
            if (key > keys[lo]) {
              keys[lo] = key;
              res[lo] = col_[j];
            }
          }
          for (int32_t j = 0; j < k; ++j) row[j] = ids_[res[j]];
          counts[i] = k;
        }
      }
    }, 64);
  }

  // One walk hop for (node, walk-row, step): the next neighbor, chosen
  // deterministically from (seed, walk_idx, step, node). Determinism per
  // hop is what makes the SHARDED store's client-driven walk (route each
  // frontier node to its owner shard, hop, repeat) bit-identical to the
  // single-host walk below — the HeterComm per-hop key-exchange pattern
  // (graph_gpu_ps_table.h:128-134) restated host-side. Returns -1 for
  // unknown nodes and sinks.
  int64_t WalkHop(int64_t node, uint64_t walk_idx, uint64_t step,
                  uint64_t seed) const {
    const int32_t di = id_of_.Find(node);
    if (di < 0) return -1;
    const int64_t beg = row_ptr_[di], end = row_ptr_[di + 1];
    const int64_t deg = end - beg;
    if (deg == 0) return -1;
    uint64_t h = ptn::splitmix64(
        ptn::splitmix64(seed) ^ ptn::splitmix64((walk_idx << 20) ^ step) ^
        ptn::splitmix64(static_cast<uint64_t>(node)));
    if (!weighted_) {
      return ids_[col_[beg + static_cast<int64_t>(h % static_cast<uint64_t>(deg))]];
    }
    // weighted hop: inverse-CDF via the precomputed row cumsum
    // (deterministic in the same hash, so the sharded walk stays
    // bit-identical)
    const double total = cumw_[end - 1];
    double u = (h >> 11) * (1.0 / 9007199254740992.0) * total;  // 53-bit
    return ids_[col_[WeightedPick(beg, end, u)]];
  }

  // Batched single hop: next[i] = WalkHop(nodes[i], idxs[i], step, seed).
  void WalkStep(const int64_t* nodes, const int64_t* idxs, int64_t n,
                int32_t step, uint64_t seed, int64_t* next) const {
    std::shared_lock<std::shared_mutex> g(adj_mu_);
    ptn::parallel_for(static_cast<size_t>(n), [&](size_t lo, size_t hi) {
      for (size_t i = lo; i < hi; ++i) {
        next[i] = nodes[i] < 0 ? -1
                               : WalkHop(nodes[i],
                                         static_cast<uint64_t>(idxs[i]),
                                         static_cast<uint64_t>(step), seed);
      }
    }, 64);
  }

  // Random walks of fixed length from each start; out[n * walk_len] holds the
  // visited nodes (start excluded), padded -1 after a dead end — the
  // FillWalkBuf/GraphDoWalkKernel analogue. Composed of WalkHop so a
  // sharded client stepping hop-by-hop reproduces it exactly.
  void RandomWalk(const int64_t* starts, int64_t n, int32_t walk_len,
                  uint64_t seed, int64_t* out) const {
    std::shared_lock<std::shared_mutex> g(adj_mu_);
    ptn::parallel_for(static_cast<size_t>(n), [&](size_t lo, size_t hi) {
      // step-major over the chunk: a walk is a dependent pointer chase per
      // row, so row-major order serializes its cache misses; interleaving
      // the chunk's rows per step keeps ~64 independent chains in flight
      // (measured 3x on a single-core host). Hop hashing is unchanged —
      // (seed, row, step, node) — so outputs are bit-identical for all
      // non-negative ids. Negative ids are RESERVED as dead-walk
      // sentinels on every walk surface (WalkStep above already treats
      // them so); a negative start yields an all -1 row here too, which
      // is what keeps client-driven sharded walks == single-host walks.
      std::vector<int64_t> cur(starts + lo, starts + hi);
      for (size_t i = lo; i < hi; ++i) {
        int64_t* row = out + i * walk_len;
        std::fill(row, row + walk_len, int64_t{-1});
      }
      for (int32_t step = 0; step < walk_len; ++step) {
        for (size_t i = lo; i < hi; ++i) {
          int64_t c = cur[i - lo];
          if (c < 0) continue;
          c = WalkHop(c, static_cast<uint64_t>(i),
                      static_cast<uint64_t>(step), seed);
          cur[i - lo] = c;
          if (c >= 0) out[i * walk_len + step] = c;
        }
      }
    }, 64);
  }

  // Multi-hop sharded walk: advance each (node, row, step) walker until
  // walk_len, a dead end, or its next node hashes to ANOTHER shard
  // (shard routing must match service.py shard_of: splitmix64 upper 32
  // bits mod num_shards). Walkers run server-side between handoffs, so the
  // client pays one round-trip per shard-crossing instead of one per hop —
  // the reference's server-side FillWalkBuf with HeterComm handoff
  // (ps_gpu_wrapper.h:198, graph_gpu_ps_table.h:128-134). Hop hashing is
  // WalkHop's (seed, row, step, node), so sharded output stays
  // bit-identical to the single-host RandomWalk.
  //
  // out is n*walk_len (fixed stride; row i holds adv[i] visited nodes);
  // status[i]: 0 = reached walk_len, 1 = dead end, 2 = handoff (last
  // written node is foreign; client resumes it at step steps[i]+adv[i]).
  void WalkMulti(const int64_t* nodes, const int64_t* idxs,
                 const int32_t* steps, int64_t n, int32_t walk_len,
                 uint64_t seed, uint32_t my_shard, uint32_t num_shards,
                 int64_t* out, int32_t* adv, uint8_t* status) const {
    std::shared_lock<std::shared_mutex> g(adj_mu_);
    ptn::parallel_for(static_cast<size_t>(n), [&](size_t lo, size_t hi) {
      // step-major over the chunk (same rationale as RandomWalk): each
      // walker is a dependent pointer chase; interleaving keeps ~64
      // independent chains in flight across cache misses
      const size_t m = hi - lo;
      std::vector<int64_t> cur(nodes + lo, nodes + hi);
      std::vector<int32_t> t(steps + lo, steps + hi);
      std::vector<uint8_t> st(m, 3);  // 3 = running
      for (size_t i = 0; i < m; ++i) {
        adv[lo + i] = 0;
        if (cur[i] < 0) st[i] = 1;              // dead-walk sentinel
        else if (t[i] >= walk_len) st[i] = 0;   // already complete
      }
      bool any = true;
      while (any) {
        any = false;
        for (size_t i = 0; i < m; ++i) {
          if (st[i] != 3) continue;
          const int64_t nxt =
              WalkHop(cur[i], static_cast<uint64_t>(idxs[lo + i]),
                      static_cast<uint64_t>(t[i]), seed);
          if (nxt < 0) { st[i] = 1; continue; }
          out[(lo + i) * walk_len + adv[lo + i]] = nxt;
          ++adv[lo + i];
          ++t[i];
          cur[i] = nxt;
          if (t[i] >= walk_len) { st[i] = 0; continue; }
          if (num_shards > 1 &&
              (ptn::splitmix64(static_cast<uint64_t>(nxt)) >> 32) %
                      num_shards != my_shard) {
            st[i] = 2;  // handoff: client re-routes to the owner
            continue;
          }
          any = true;
        }
      }
      for (size_t i = 0; i < m; ++i) status[lo + i] = st[i];
    }, 64);
  }

  // -- node feature table (GpuPsCommGraphFea analogue, gpu_graph_node.h:326:
  // per-node float payloads carried next to the adjacency) ----------------
  int32_t SetFeatures(const int64_t* keys, const float* vals, int64_t n,
                      int32_t dim) {
    std::unique_lock<std::shared_mutex> g(feat_mu_);
    if (feat_dim_ == 0) feat_dim_ = dim;
    if (dim != feat_dim_) return -1;
    for (int64_t i = 0; i < n; ++i) {
      // the map stores ROW indices (int32-bounded); byte offsets are
      // row * dim, so the arena itself can exceed 2^31 floats
      const int32_t rows = static_cast<int32_t>(feat_data_.size() / dim);
      const int32_t row = feat_of_.InsertOrGet(keys[i], rows);
      if (row == rows) feat_data_.resize(feat_data_.size() + dim);
      std::memcpy(feat_data_.data() + static_cast<size_t>(row) * dim,
                  vals + i * dim, sizeof(float) * dim);
    }
    return 0;
  }

  int32_t FeatureDim() const { return feat_dim_; }

  // Gather features; missing nodes zero-filled (the reference's slot-miss
  // default). dim must match the configured dim.
  int32_t GetFeatures(const int64_t* keys, int64_t n, int32_t dim,
                      float* out) const {
    std::shared_lock<std::shared_mutex> g(feat_mu_);
    if (feat_dim_ != 0 && dim != feat_dim_) return -1;
    std::memset(out, 0, sizeof(float) * static_cast<size_t>(n) * dim);
    if (feat_dim_ == 0) return 0;
    ptn::parallel_for(static_cast<size_t>(n), [&](size_t lo, size_t hi) {
      for (size_t i = lo; i < hi; ++i) {
        const int32_t row = feat_of_.Find(keys[i]);
        if (row < 0) continue;
        std::memcpy(out + i * dim,
                    feat_data_.data() + static_cast<size_t>(row) * dim,
                    sizeof(float) * dim);
      }
    }, 256);
    return 0;
  }

 private:
  mutable std::shared_mutex adj_mu_;  // ingest exclusive, reads shared
  std::vector<int64_t> coo_src_, coo_dst_;
  std::vector<float> coo_w_;   // per forward edge (empty = unweighted)
  std::vector<float> csr_w_;   // aligned with col_ (clamped > 0)
  std::vector<double> cumw_;   // per-row cumulative csr_w_ (weighted only)
  bool weighted_ = false;
  ptn::FlatI64Map id_of_;
  std::vector<int64_t> ids_;       // dense idx -> original id
  std::vector<int64_t> row_ptr_;   // CSR offsets
  std::vector<int32_t> col_;       // CSR neighbor dense indices
  mutable std::shared_mutex feat_mu_;  // writers exclusive, readers shared
  int32_t feat_dim_ = 0;
  ptn::FlatI64Map feat_of_;  // key -> feature ROW (offset = row * dim)
  std::vector<float> feat_data_;
};

}  // namespace

extern "C" {

void* pt_graph_create() { return new GraphStore(); }
void pt_graph_destroy(void* h) { delete static_cast<GraphStore*>(h); }

void pt_graph_add_edges(void* h, const int64_t* src, const int64_t* dst,
                        int64_t n) {
  static_cast<GraphStore*>(h)->AddEdges(src, dst, nullptr, n);
}

void pt_graph_add_edges_weighted(void* h, const int64_t* src,
                                 const int64_t* dst, const float* w,
                                 int64_t n) {
  static_cast<GraphStore*>(h)->AddEdges(src, dst, w, n);
}

void pt_graph_clear_edges(void* h) {
  static_cast<GraphStore*>(h)->ClearEdges();
}

void pt_graph_build(void* h, int32_t symmetric) {
  static_cast<GraphStore*>(h)->Build(symmetric != 0);
}

int64_t pt_graph_num_nodes(void* h) {
  return static_cast<GraphStore*>(h)->NumNodes();
}
int64_t pt_graph_num_edges(void* h) {
  return static_cast<GraphStore*>(h)->NumEdges();
}
int64_t pt_graph_node_ids(void* h, int64_t* out, int64_t cap) {
  return static_cast<GraphStore*>(h)->NodeIds(out, cap);
}
int64_t pt_graph_degree(void* h, int64_t key) {
  return static_cast<GraphStore*>(h)->Degree(key);
}

void pt_graph_sample_neighbors(void* h, const int64_t* nodes, int64_t n,
                               int32_t k, int32_t replace, uint64_t seed,
                               int64_t* out, int32_t* counts) {
  static_cast<GraphStore*>(h)->SampleNeighbors(nodes, n, k, replace, seed, out,
                                               counts);
}

void pt_graph_random_walk(void* h, const int64_t* starts, int64_t n,
                          int32_t walk_len, uint64_t seed, int64_t* out) {
  static_cast<GraphStore*>(h)->RandomWalk(starts, n, walk_len, seed, out);
}

void pt_graph_walk_step(void* h, const int64_t* nodes, const int64_t* idxs,
                        int64_t n, int32_t step, uint64_t seed, int64_t* next) {
  static_cast<GraphStore*>(h)->WalkStep(nodes, idxs, n, step, seed, next);
}

void pt_graph_walk_multi(void* h, const int64_t* nodes, const int64_t* idxs,
                         const int32_t* steps, int64_t n, int32_t walk_len,
                         uint64_t seed, uint32_t my_shard, uint32_t num_shards,
                         int64_t* out, int32_t* adv, uint8_t* status) {
  static_cast<GraphStore*>(h)->WalkMulti(nodes, idxs, steps, n, walk_len, seed,
                                         my_shard, num_shards, out, adv,
                                         status);
}

int32_t pt_graph_set_features(void* h, const int64_t* keys, const float* vals,
                              int64_t n, int32_t dim) {
  return static_cast<GraphStore*>(h)->SetFeatures(keys, vals, n, dim);
}

int32_t pt_graph_get_features(void* h, const int64_t* keys, int64_t n,
                              int32_t dim, float* out) {
  return static_cast<GraphStore*>(h)->GetFeatures(keys, n, dim, out);
}

int32_t pt_graph_feature_dim(void* h) {
  return static_cast<GraphStore*>(h)->FeatureDim();
}
}
