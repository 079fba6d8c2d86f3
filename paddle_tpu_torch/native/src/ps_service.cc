// Networked parameter-server service over the sharded sparse table.
//
// TPU-native rebuild of the reference's brpc PS service layer
// (paddle/fluid/distributed/ps/service/brpc_ps_server.cc request dispatch,
// brpc_ps_client.cc client stubs, ps_client.h PSClient API): a plain-TCP
// length-prefixed binary protocol instead of brpc/protobuf — the payloads
// are dense numpy buffers, so there is nothing for an IDL to describe, and
// zero-copy in/out of the table is the whole game. Each server process owns
// ONE table instance (a shard of the global key space); clients partition
// keys by hash across servers (HeterComm shard-by-hash restated host-side).
//
// Framing and connection lifecycle live in net.h (shared with the graph
// service, graph_service.cc).
//
// Ops: PULL keys->rows, PUSH keys+grads, SIZE, KEYS, SAVE, LOAD(merge flag),
// SHRINK, SET_LR, BARRIER(world) — the worker-sync primitive the reference
// routes through its Gloo/brpc barrier — and STOP.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include "net.h"

extern "C" {
// table C API (ps_table.cc)
void pt_table_pull(void* h, const int64_t* keys, int64_t n, float* out);
void pt_table_push(void* h, const int64_t* keys, const float* grads, int64_t n);
void pt_table_push_raw(void* h, const int64_t* keys, const float* deltas,
                       int64_t n);
void pt_table_push_show_click(void* h, const int64_t* keys, const float* sc,
                              int64_t n);
void* pt_dense_create(int64_t len, int32_t optimizer, float lr, float eps);
void* pt_dense_create_from_file(const char* path);
int32_t pt_dense_optimizer(void* h);
void pt_dense_destroy(void* h);
int64_t pt_dense_len(void* h);
void pt_dense_set_lr(void* h, float lr);
int32_t pt_dense_get(void* h, int64_t off, int64_t n, float* out);
int32_t pt_dense_set(void* h, int64_t off, int64_t n, const float* vals);
int32_t pt_dense_push(void* h, int64_t off, int64_t n, const float* grad);
int32_t pt_dense_save(void* h, const char* path);
int32_t pt_dense_load(void* h, const char* path);
int64_t pt_table_size(void* h);
int64_t pt_table_keys(void* h, int64_t* out, int64_t cap);
int64_t pt_table_shrink(void* h, float threshold);
int32_t pt_table_save(void* h, const char* path);
int32_t pt_table_load(void* h, const char* path);
int32_t pt_table_load_merge(void* h, const char* path);
void pt_table_set_lr(void* h, float lr);
int32_t pt_table_dim(void* h);
}

namespace {

enum Op : uint8_t {
  kPull = 1,
  kPush = 2,
  kSize = 3,
  kSave = 4,
  kLoad = 5,
  kShrink = 6,
  kSetLr = 7,
  kBarrier = 8,
  kKeys = 9,
  kStop = 10,
  kPushRaw = 11,        // add deltas bypassing the rule (geo delta merge)
  kPushShowClick = 12,  // accumulate CTR usage stats
  kDenseInit = 13,      // [i64 len][i32 opt][f32 lr] — lazy dense table
  kDensePull = 14,      // [i64 off][i64 n] -> floats
  kDensePush = 15,      // [i64 off][i64 n][grads]
  kDenseSet = 16,       // [i64 off][i64 n][vals]
};

// The PS server = a FramedServer dispatching into one table, plus barrier
// state (the only op needing cross-connection coordination).
struct PsServer {
  void* table = nullptr;
  // Lazy MemoryDenseTable block (kDenseInit / snapshot restore). Atomic:
  // connection threads read it unlocked; dense_mu serializes creation.
  // Once set it is never swapped (resize -> error), so a loaded pointer
  // stays valid for the server's lifetime.
  std::atomic<void*> dense{nullptr};
  std::mutex dense_mu;

  void* DenseOrNull() { return dense.load(std::memory_order_acquire); }
  ptn::FramedServer* srv = nullptr;
  // own stopping flag (not srv->stopping()): the dispatch lambda can run
  // before Start() returns and assigns srv
  std::atomic<bool> stopping{false};
  std::mutex barrier_mu;
  std::condition_variable barrier_cv;
  uint64_t barrier_gen = 0;
  uint32_t barrier_count = 0;

  // Restore (or refresh) the dense block from `<path>.dense`. Creates the
  // table from the sidecar's own header when none exists yet (server
  // restart before any client dense_init). Absent sidecar is fine.
  int32_t LoadDenseSidecar(const std::string& path) {
    const std::string side = path + ".dense";
    std::lock_guard<std::mutex> g(dense_mu);
    void* d = dense.load(std::memory_order_relaxed);
    if (d) {
      int32_t drc = pt_dense_load(d, side.c_str());
      return (drc == 0 || drc == -1) ? 0 : drc;  // -1 = file absent
    }
    FILE* probe = std::fopen(side.c_str(), "rb");
    if (!probe) return 0;
    std::fclose(probe);
    void* fresh = pt_dense_create_from_file(side.c_str());
    if (!fresh) return -16;
    dense.store(fresh, std::memory_order_release);
    return 0;
  }

  int Dispatch(int fd, uint8_t op, const char* body, uint32_t len) {
    using ptn::SendReply;
    const int32_t dim = pt_table_dim(table);
    // All size arithmetic in uint64 and every fixed-width field checked
    // against len BEFORE the memcpy; replies larger than the frame cap are
    // rejected up front (their u32 length field would otherwise truncate
    // and desync the stream).
    switch (op) {
      case kPull: {
        if (len < 4) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        uint32_t n;
        std::memcpy(&n, body, 4);
        if (static_cast<uint64_t>(len) != 4 + static_cast<uint64_t>(n) * 8 ||
            static_cast<uint64_t>(n) * dim * 4 > ptn::kMaxFrameLen)
          return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        const int64_t* keys = reinterpret_cast<const int64_t*>(body + 4);
        std::vector<float> rows(static_cast<size_t>(n) * dim);
        pt_table_pull(table, keys, n, rows.data());
        return SendReply(fd, 0, rows.data(),
                         static_cast<uint32_t>(rows.size() * 4))
                   ? 0
                   : 1;
      }
      case kPush: {
        if (len < 4) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        uint32_t n;
        std::memcpy(&n, body, 4);
        if (static_cast<uint64_t>(len) !=
            4 + static_cast<uint64_t>(n) * 8 +
                static_cast<uint64_t>(n) * dim * 4)
          return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        const int64_t* keys = reinterpret_cast<const int64_t*>(body + 4);
        const float* grads = reinterpret_cast<const float*>(body + 4 + n * 8);
        pt_table_push(table, keys, grads, n);
        return SendReply(fd, 0, nullptr, 0) ? 0 : 1;
      }
      case kSize: {
        int64_t sz = pt_table_size(table);
        return SendReply(fd, 0, &sz, 8) ? 0 : 1;
      }
      case kKeys: {
        int64_t cap = pt_table_size(table);
        if (static_cast<uint64_t>(cap) * 8 > ptn::kMaxFrameLen)
          return SendReply(fd, -11, nullptr, 0) ? 0 : 1;
        std::vector<int64_t> keys(static_cast<size_t>(cap));
        int64_t w = pt_table_keys(table, keys.data(), cap);
        return SendReply(fd, 0, keys.data(), static_cast<uint32_t>(w * 8))
                   ? 0
                   : 1;
      }
      case kSave: {
        std::string path(body, len);
        int32_t rc = pt_table_save(table, path.c_str());
        void* d = DenseOrNull();
        if (rc == 0 && d) rc = pt_dense_save(d, (path + ".dense").c_str());
        return SendReply(fd, rc, nullptr, 0) ? 0 : 1;
      }
      case kLoad: {
        if (len < 1) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        bool merge = body[0] != 0;
        std::string path(body + 1, len - 1);
        int32_t rc = merge ? pt_table_load_merge(table, path.c_str())
                           : pt_table_load(table, path.c_str());
        if (rc == 0) rc = LoadDenseSidecar(path);
        return SendReply(fd, rc, nullptr, 0) ? 0 : 1;
      }
      case kShrink: {
        if (len < 4) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        float thr;
        std::memcpy(&thr, body, 4);
        int64_t dropped = pt_table_shrink(table, thr);
        return SendReply(fd, 0, &dropped, 8) ? 0 : 1;
      }
      case kSetLr: {
        if (len < 4) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        float lr;
        std::memcpy(&lr, body, 4);
        pt_table_set_lr(table, lr);
        return SendReply(fd, 0, nullptr, 0) ? 0 : 1;
      }
      case kBarrier: {
        if (len < 4) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        uint32_t world;
        std::memcpy(&world, body, 4);
        {
          std::unique_lock<std::mutex> l(barrier_mu);
          uint64_t my_gen = barrier_gen;
          if (++barrier_count >= world) {
            barrier_count = 0;
            barrier_gen++;
            barrier_cv.notify_all();
          } else {
            barrier_cv.wait(l, [&] {
              return barrier_gen != my_gen || stopping.load();
            });
          }
        }
        return SendReply(fd, stopping.load() ? -1 : 0, nullptr, 0) ? 0 : 1;
      }
      case kPushRaw: {
        if (len < 4) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        uint32_t n;
        std::memcpy(&n, body, 4);
        if (static_cast<uint64_t>(len) !=
            4 + static_cast<uint64_t>(n) * 8 +
                static_cast<uint64_t>(n) * dim * 4)
          return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        const int64_t* keys = reinterpret_cast<const int64_t*>(body + 4);
        const float* deltas = reinterpret_cast<const float*>(body + 4 + n * 8);
        pt_table_push_raw(table, keys, deltas, n);
        return SendReply(fd, 0, nullptr, 0) ? 0 : 1;
      }
      case kPushShowClick: {
        if (len < 4) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        uint32_t n;
        std::memcpy(&n, body, 4);
        if (static_cast<uint64_t>(len) !=
            4 + static_cast<uint64_t>(n) * 8 + static_cast<uint64_t>(n) * 8)
          return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        const int64_t* keys = reinterpret_cast<const int64_t*>(body + 4);
        const float* sc = reinterpret_cast<const float*>(body + 4 + n * 8);
        pt_table_push_show_click(table, keys, sc, n);
        return SendReply(fd, 0, nullptr, 0) ? 0 : 1;
      }
      case kDenseInit: {
        if (len < 16) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        int64_t dlen;
        int32_t opt;
        float lr;
        std::memcpy(&dlen, body, 8);
        std::memcpy(&opt, body + 8, 4);
        std::memcpy(&lr, body + 12, 4);
        if (dlen < 0) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        int32_t rc = 0;
        {
          std::lock_guard<std::mutex> g(dense_mu);
          void* d = dense.load(std::memory_order_relaxed);
          if (!d) {
            dense.store(pt_dense_create(dlen, opt, lr, 1e-8f),
                        std::memory_order_release);
          } else if (pt_dense_len(d) != dlen) {
            // never swap a live table under concurrent dense ops; a
            // resize needs a fresh server
            rc = -14;
          } else if (pt_dense_optimizer(d) != opt) {
            // a misconfigured worker must hear about the divergence, not
            // have its grads silently applied under another rule
            rc = -15;
          }
          // matching re-init (reconnecting client) keeps existing values
        }
        return SendReply(fd, rc, nullptr, 0) ? 0 : 1;
      }
      case kDensePull: {
        if (len < 16) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        int64_t off, n;
        std::memcpy(&off, body, 8);
        std::memcpy(&n, body + 8, 8);
        void* d = DenseOrNull();
        if (n < 0 || static_cast<uint64_t>(n) * 4 > ptn::kMaxFrameLen || !d)
          return SendReply(fd, -12, nullptr, 0) ? 0 : 1;
        std::vector<float> out(static_cast<size_t>(n));
        if (pt_dense_get(d, off, n, out.data()) != 0)
          return SendReply(fd, -13, nullptr, 0) ? 0 : 1;
        return SendReply(fd, 0, out.data(), static_cast<uint32_t>(n * 4))
                   ? 0
                   : 1;
      }
      case kDensePush: {
        if (len < 16) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        int64_t off, n;
        std::memcpy(&off, body, 8);
        std::memcpy(&n, body + 8, 8);
        void* d = DenseOrNull();
        if (n < 0 ||
            static_cast<uint64_t>(len) != 16 + static_cast<uint64_t>(n) * 4 ||
            !d)
          return SendReply(fd, -12, nullptr, 0) ? 0 : 1;
        const float* g = reinterpret_cast<const float*>(body + 16);
        int32_t rc = pt_dense_push(d, off, n, g);
        return SendReply(fd, rc, nullptr, 0) ? 0 : 1;
      }
      case kDenseSet: {
        if (len < 16) return SendReply(fd, -10, nullptr, 0) ? 0 : 1;
        int64_t off, n;
        std::memcpy(&off, body, 8);
        std::memcpy(&n, body + 8, 8);
        void* d = DenseOrNull();
        if (n < 0 ||
            static_cast<uint64_t>(len) != 16 + static_cast<uint64_t>(n) * 4 ||
            !d)
          return SendReply(fd, -12, nullptr, 0) ? 0 : 1;
        const float* vals = reinterpret_cast<const float*>(body + 16);
        int32_t rc = pt_dense_set(d, off, n, vals);
        return SendReply(fd, rc, nullptr, 0) ? 0 : 1;
      }
      case kStop: {
        SendReply(fd, 0, nullptr, 0);
        return 2;  // FramedServer shuts down after this reply
      }
      default:
        return SendReply(fd, -127, nullptr, 0) ? 0 : 1;
    }
  }
};

}  // namespace

extern "C" {

// Start serving `table` on `port` (0 = ephemeral). Returns handle or null.
void* pt_ps_server_start(void* table, int32_t port) {
  auto* ps = new PsServer();
  ps->table = table;
  ps->srv = ptn::FramedServer::Start(
      port,
      [ps](int fd, uint8_t op, const char* body, uint32_t len) {
        return ps->Dispatch(fd, op, body, len);
      },
      [ps] {
        // release barrier waiters so Stop()'s worker join can't deadlock
        ps->stopping.store(true);
        std::lock_guard<std::mutex> g(ps->barrier_mu);
        ps->barrier_gen++;
        ps->barrier_count = 0;
        ps->barrier_cv.notify_all();
      });
  if (!ps->srv) {
    delete ps;
    return nullptr;
  }
  return ps;
}

int32_t pt_ps_server_port(void* h) {
  return static_cast<PsServer*>(h)->srv->port();
}

void pt_ps_server_stop(void* h) { static_cast<PsServer*>(h)->srv->Stop(); }

// Block until the server stops (subprocess entrypoint main loop).
void pt_ps_server_wait(void* h) { static_cast<PsServer*>(h)->srv->Wait(); }

void pt_ps_server_destroy(void* h) {
  auto* ps = static_cast<PsServer*>(h);
  delete ps->srv;
  if (void* d = ps->dense.load()) pt_dense_destroy(d);
  delete ps;
}

// Restore the dense sidecar for `path` (server restart with --load).
int32_t pt_ps_server_load_dense(void* h, const char* path) {
  return static_cast<PsServer*>(h)->LoadDenseSidecar(path);
}
}
