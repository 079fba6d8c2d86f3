// Networked graph-shard service over the CSR graph store.
//
// TPU-native rebuild of the reference's distributed graph service layer
// (paddle/fluid/distributed/ps/service/graph_brpc_server.cc request
// dispatch into CommonGraphTable, and the cross-GPU sharded sampling of
// GpuPsGraphTable, heter_ps/graph_gpu_ps_table.h:128-134): each server
// process owns ONE GraphStore shard (nodes partitioned by hash; a node's
// full adjacency and features live on its owner). Clients route node
// batches to owners and reassemble — including hop-by-hop distributed
// random walks, which are bit-identical to the single-host walk because
// each hop is deterministic in (seed, walk-row, step, node).
//
// Frame format shared with ps_service.cc (see net.h).
//
// Request bodies (little-endian):
//   ADD_EDGES:  [u32 n][src n*8][dst n*8]
//   BUILD:      [u8 symmetric]
//   NUM_NODES:  -> [i64]
//   NUM_EDGES:  -> [i64]
//   NODE_IDS:   -> [ids n*8]
//   DEGREE:     [i64 key] -> [i64]
//   SAMPLE:     [u32 n][i32 k][u8 replace][u64 seed][keys n*8]
//               -> [out n*k*8][counts n*4]
//   WALK_STEP:  [u32 n][i32 step][u64 seed][keys n*8][idxs n*8] -> [next n*8]
//   SET_FEAT:   [u32 n][i32 dim][keys n*8][vals n*dim*4]
//   GET_FEAT:   [u32 n][i32 dim][keys n*8] -> [vals n*dim*4]
//   FEAT_DIM:   -> [i32]
//   STOP
//   CLEAR_EDGES
//   ADD_EDGES_W: [u32 n][src n*8][dst n*8][w n*4]

#include <cstdint>
#include <cstring>
#include <vector>

#include "net.h"

extern "C" {
// graph store C API (graph_store.cc)
void pt_graph_add_edges(void* h, const int64_t* src, const int64_t* dst,
                        int64_t n);
void pt_graph_add_edges_weighted(void* h, const int64_t* src,
                                 const int64_t* dst, const float* w,
                                 int64_t n);
void pt_graph_build(void* h, int32_t symmetric);
void pt_graph_clear_edges(void* h);
int64_t pt_graph_num_nodes(void* h);
int64_t pt_graph_num_edges(void* h);
int64_t pt_graph_node_ids(void* h, int64_t* out, int64_t cap);
int64_t pt_graph_degree(void* h, int64_t key);
void pt_graph_sample_neighbors(void* h, const int64_t* nodes, int64_t n,
                               int32_t k, int32_t replace, uint64_t seed,
                               int64_t* out, int32_t* counts);
void pt_graph_walk_step(void* h, const int64_t* nodes, const int64_t* idxs,
                        int64_t n, int32_t step, uint64_t seed, int64_t* next);
void pt_graph_walk_multi(void* h, const int64_t* nodes, const int64_t* idxs,
                         const int32_t* steps, int64_t n, int32_t walk_len,
                         uint64_t seed, uint32_t my_shard, uint32_t num_shards,
                         int64_t* out, int32_t* adv, uint8_t* status);
int32_t pt_graph_set_features(void* h, const int64_t* keys, const float* vals,
                              int64_t n, int32_t dim);
int32_t pt_graph_get_features(void* h, const int64_t* keys, int64_t n,
                              int32_t dim, float* out);
int32_t pt_graph_feature_dim(void* h);
}

namespace {

enum GraphOp : uint8_t {
  kAddEdges = 1,
  kBuild = 2,
  kNumNodes = 3,
  kNumEdges = 4,
  kNodeIds = 5,
  kDegree = 6,
  kSample = 7,
  kWalkStep = 8,
  kSetFeat = 9,
  kGetFeat = 10,
  kFeatDim = 11,
  kStop = 12,
  kClearEdges = 13,
  kAddEdgesW = 14,  // [u32 n][src n*8][dst n*8][w n*4]
  // [u32 n][i32 walk_len][u32 my_shard][u32 num_shards][u64 seed]
  // [keys n*8][idxs n*8][steps n*4]
  //   -> [adv n*4][status n*1][flat sum(adv)*8]
  kWalkMulti = 15,
};

int Dispatch(void* graph, int fd, uint8_t op, const char* body, uint32_t len) {
  using ptn::SendReply;
  // every fixed-width field is validated against len BEFORE any memcpy
  switch (op) {
    case kAddEdges: {
      if (len < 4) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      uint32_t n;
      std::memcpy(&n, body, 4);
      if (static_cast<uint64_t>(len) != 4 + static_cast<uint64_t>(n) * 16)
        return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      const int64_t* src = reinterpret_cast<const int64_t*>(body + 4);
      const int64_t* dst = src + n;
      pt_graph_add_edges(graph, src, dst, n);
      return SendReply(fd, 0, nullptr, 0) ? 0 : 1;
    }
    case kBuild: {
      if (len < 1) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      pt_graph_build(graph, body[0] != 0);
      return SendReply(fd, 0, nullptr, 0) ? 0 : 1;
    }
    case kNumNodes: {
      int64_t v = pt_graph_num_nodes(graph);
      return SendReply(fd, 0, &v, 8) ? 0 : 1;
    }
    case kNumEdges: {
      int64_t v = pt_graph_num_edges(graph);
      return SendReply(fd, 0, &v, 8) ? 0 : 1;
    }
    case kNodeIds: {
      int64_t cap = pt_graph_num_nodes(graph);
      if (static_cast<uint64_t>(cap) * 8 > ptn::kMaxFrameLen)
        return SendReply(fd, -11, nullptr, 0) ? 0 : 1;
      std::vector<int64_t> ids(static_cast<size_t>(cap));
      int64_t w = pt_graph_node_ids(graph, ids.data(), cap);
      return SendReply(fd, 0, ids.data(), static_cast<uint32_t>(w * 8)) ? 0 : 1;
    }
    case kDegree: {
      if (len < 8) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      int64_t key;
      std::memcpy(&key, body, 8);
      int64_t v = pt_graph_degree(graph, key);
      return SendReply(fd, 0, &v, 8) ? 0 : 1;
    }
    case kSample: {
      if (len < 17) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      uint32_t n;
      int32_t k;
      uint8_t replace;
      uint64_t seed;
      std::memcpy(&n, body, 4);
      std::memcpy(&k, body + 4, 4);
      std::memcpy(&replace, body + 8, 1);
      std::memcpy(&seed, body + 9, 8);
      if (k <= 0 ||
          static_cast<uint64_t>(len) != 17 + static_cast<uint64_t>(n) * 8 ||
          // reply = n*k*8 + n*4 must fit the frame cap, else the u32
          // length truncates and desyncs the stream (and a hostile k
          // could force a multi-GB allocation)
          static_cast<uint64_t>(n) * k * 8 + static_cast<uint64_t>(n) * 4 >
              ptn::kMaxFrameLen)
        return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      const int64_t* keys = reinterpret_cast<const int64_t*>(body + 17);
      std::vector<int64_t> out(static_cast<size_t>(n) * k);
      std::vector<int32_t> counts(n);
      pt_graph_sample_neighbors(graph, keys, n, k, replace, seed, out.data(),
                                counts.data());
      std::vector<char> reply(out.size() * 8 + counts.size() * 4);
      std::memcpy(reply.data(), out.data(), out.size() * 8);
      std::memcpy(reply.data() + out.size() * 8, counts.data(),
                  counts.size() * 4);
      return SendReply(fd, 0, reply.data(),
                       static_cast<uint32_t>(reply.size()))
                 ? 0
                 : 1;
    }
    case kWalkStep: {
      if (len < 16) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      uint32_t n;
      int32_t step;
      uint64_t seed;
      std::memcpy(&n, body, 4);
      std::memcpy(&step, body + 4, 4);
      std::memcpy(&seed, body + 8, 8);
      if (static_cast<uint64_t>(len) != 16 + static_cast<uint64_t>(n) * 16)
        return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      const int64_t* keys = reinterpret_cast<const int64_t*>(body + 16);
      const int64_t* idxs = keys + n;
      std::vector<int64_t> next(n);
      pt_graph_walk_step(graph, keys, idxs, n, step, seed, next.data());
      return SendReply(fd, 0, next.data(), static_cast<uint32_t>(n * 8)) ? 0
                                                                         : 1;
    }
    case kWalkMulti: {
      if (len < 24) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      uint32_t n, my_shard, num_shards;
      int32_t walk_len;
      uint64_t seed;
      std::memcpy(&n, body, 4);
      std::memcpy(&walk_len, body + 4, 4);
      std::memcpy(&my_shard, body + 8, 4);
      std::memcpy(&num_shards, body + 12, 4);
      std::memcpy(&seed, body + 16, 8);
      if (walk_len <= 0 || num_shards == 0 || my_shard >= num_shards ||
          static_cast<uint64_t>(len) != 24 + static_cast<uint64_t>(n) * 20 ||
          // worst-case reply (every walker advances walk_len hops) must
          // fit the frame cap
          static_cast<uint64_t>(n) * walk_len * 8 +
                  static_cast<uint64_t>(n) * 5 >
              ptn::kMaxFrameLen)
        return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      const int64_t* keys = reinterpret_cast<const int64_t*>(body + 24);
      const int64_t* idxs = keys + n;
      const int32_t* steps =
          reinterpret_cast<const int32_t*>(body + 24 +
                                           static_cast<uint64_t>(n) * 16);
      // per-walker step must sit inside [0, walk_len]: a negative step
      // would let adv overrun the fixed n*walk_len rows (heap OOB write)
      for (uint32_t i = 0; i < n; ++i) {
        if (steps[i] < 0 || steps[i] > walk_len)
          return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      }
      std::vector<int64_t> paths(static_cast<size_t>(n) * walk_len);
      std::vector<int32_t> adv(n);
      std::vector<uint8_t> status(n);
      pt_graph_walk_multi(graph, keys, idxs, steps, n, walk_len, seed,
                          my_shard, num_shards, paths.data(), adv.data(),
                          status.data());
      // compact reply: [adv][status][flat visited nodes]
      uint64_t total = 0;
      for (uint32_t i = 0; i < n; ++i) total += adv[i];
      std::vector<char> reply(static_cast<size_t>(n) * 5 + total * 8);
      std::memcpy(reply.data(), adv.data(), static_cast<size_t>(n) * 4);
      std::memcpy(reply.data() + static_cast<size_t>(n) * 4, status.data(),
                  n);
      char* w = reply.data() + static_cast<size_t>(n) * 5;
      for (uint32_t i = 0; i < n; ++i) {
        std::memcpy(w, paths.data() + static_cast<size_t>(i) * walk_len,
                    static_cast<size_t>(adv[i]) * 8);
        w += static_cast<size_t>(adv[i]) * 8;
      }
      return SendReply(fd, 0, reply.data(),
                       static_cast<uint32_t>(reply.size()))
                 ? 0
                 : 1;
    }
    case kSetFeat: {
      if (len < 8) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      uint32_t n;
      int32_t dim;
      std::memcpy(&n, body, 4);
      std::memcpy(&dim, body + 4, 4);
      if (dim <= 0 ||
          static_cast<uint64_t>(len) !=
              8 + static_cast<uint64_t>(n) * 8 +
                  static_cast<uint64_t>(n) * dim * 4)
        return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      const int64_t* keys = reinterpret_cast<const int64_t*>(body + 8);
      const float* vals = reinterpret_cast<const float*>(body + 8 + n * 8);
      int32_t rc = pt_graph_set_features(graph, keys, vals, n, dim);
      return SendReply(fd, rc, nullptr, 0) ? 0 : 1;
    }
    case kGetFeat: {
      if (len < 8) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      uint32_t n;
      int32_t dim;
      std::memcpy(&n, body, 4);
      std::memcpy(&dim, body + 4, 4);
      if (dim <= 0 ||
          static_cast<uint64_t>(len) != 8 + static_cast<uint64_t>(n) * 8 ||
          static_cast<uint64_t>(n) * dim * 4 > ptn::kMaxFrameLen)
        return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      const int64_t* keys = reinterpret_cast<const int64_t*>(body + 8);
      std::vector<float> out(static_cast<size_t>(n) * dim);
      int32_t rc = pt_graph_get_features(graph, keys, n, dim, out.data());
      if (rc != 0) return SendReply(fd, rc, nullptr, 0) ? 0 : 1;
      return SendReply(fd, 0, out.data(),
                       static_cast<uint32_t>(out.size() * 4))
                 ? 0
                 : 1;
    }
    case kFeatDim: {
      int32_t v = pt_graph_feature_dim(graph);
      return SendReply(fd, 0, &v, 4) ? 0 : 1;
    }
    case kAddEdgesW: {
      if (len < 4) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      uint32_t n;
      std::memcpy(&n, body, 4);
      if (static_cast<uint64_t>(len) != 4 + static_cast<uint64_t>(n) * 20)
        return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
      const int64_t* src = reinterpret_cast<const int64_t*>(body + 4);
      const int64_t* dst = src + n;
      const float* w = reinterpret_cast<const float*>(body + 4 + n * 16);
      pt_graph_add_edges_weighted(graph, src, dst, w, n);
      return SendReply(fd, 0, nullptr, 0) ? 0 : 1;
    }
    case kClearEdges: {
      pt_graph_clear_edges(graph);
      return SendReply(fd, 0, nullptr, 0) ? 0 : 1;
    }
    case kStop: {
      SendReply(fd, 0, nullptr, 0);
      return 2;  // FramedServer shuts down after this reply
    }
    default:
      return SendReply(fd, -127, nullptr, 0) ? 0 : 1;
  }
}

}  // namespace

extern "C" {

// Serve `graph` on `port` (0 = ephemeral). Returns handle or null.
void* pt_graph_server_start(void* graph, int32_t port) {
  return ptn::FramedServer::Start(
      port, [graph](int fd, uint8_t op, const char* body, uint32_t len) {
        return Dispatch(graph, fd, op, body, len);
      });
}

int32_t pt_graph_server_port(void* h) {
  return static_cast<ptn::FramedServer*>(h)->port();
}

void pt_graph_server_stop(void* h) {
  static_cast<ptn::FramedServer*>(h)->Stop();
}

void pt_graph_server_wait(void* h) {
  static_cast<ptn::FramedServer*>(h)->Wait();
}

void pt_graph_server_destroy(void* h) {
  delete static_cast<ptn::FramedServer*>(h);
}
}
