// Shared plain-TCP framed-protocol server machinery.
//
// The reference runs every distributed service over brpc
// (paddle/fluid/distributed/ps/service/brpc_ps_server.cc,
// graph_brpc_server.cc); here the transport is a length-prefixed binary
// frame over TCP — payloads are dense numpy buffers, nothing for an IDL to
// describe. This header factors the accept/worker/stop lifecycle out of
// ps_service.cc so the graph service (graph_service.cc) reuses it.
//
// Frame format (little-endian):
//   request:  [u32 body_len][u8 op][body ...]
//   reply:    [i32 status][u32 body_len][body ...]   status<0 => error
#ifndef PADDLE_TPU_NATIVE_NET_H_
#define PADDLE_TPU_NATIVE_NET_H_

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace ptn {

// Largest body buffered for one request: bounds the allocation a malformed
// or hostile frame can force (a bogus ~4 GiB u32 length would otherwise go
// straight to resize() and bad_alloc the server).
constexpr uint32_t kMaxFrameLen = 256u << 20;

inline bool ReadFull(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

inline bool WriteFull(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

inline bool SendReply(int fd, int32_t status, const void* body, uint32_t len) {
  char hdr[8];
  std::memcpy(hdr, &status, 4);
  std::memcpy(hdr + 4, &len, 4);
  if (!WriteFull(fd, hdr, 8)) return false;
  return len == 0 || WriteFull(fd, body, len);
}

// One listening socket + one thread per connection, dispatching framed
// requests to a handler. Handler return codes:
//   0 = keep serving this connection
//   1 = close this connection
//   2 = close this connection AND stop the whole server (after the handler
//       has sent its reply) — the kStop op.
class FramedServer {
 public:
  using Handler =
      std::function<int(int fd, uint8_t op, const char* body, uint32_t len)>;
  using StopHook = std::function<void()>;

  // Bind + listen on `port` (0 = ephemeral). Returns null on failure.
  // `stop_hook` (optional) runs during Stop() AFTER new work is fenced off
  // but BEFORE worker threads are joined — the place to release handler
  // threads blocked on condition variables (e.g. a barrier), which would
  // otherwise deadlock the join.
  static FramedServer* Start(int32_t port, Handler handler,
                             StopHook stop_hook = {}) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    int one = 1;
    ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
        ::listen(fd, 128) < 0) {
      ::close(fd);
      return nullptr;
    }
    socklen_t alen = sizeof(addr);
    ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
    return new FramedServer(fd, ntohs(addr.sin_port), std::move(handler),
                            std::move(stop_hook));
  }

  int port() const { return port_; }

  void Stop() {
    bool expected = false;
    if (!stopping_.compare_exchange_strong(expected, true)) {
      Wait();  // another thread is stopping; wait so stop-then-destroy is safe
      return;
    }
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    {
      std::lock_guard<std::mutex> g(conn_mu_);
      for (auto& w : workers_) {
        // per-worker mutex closes the check-then-shutdown window: a worker
        // closes its fd under the same mutex, so we can never observe
        // closed == false yet race the close and shutdown() a recycled fd
        std::lock_guard<std::mutex> wg(w->mu);
        if (!w->closed) ::shutdown(w->fd, SHUT_RDWR);
      }
    }
    if (stop_hook_) stop_hook_();
    if (accept_thread_.joinable()) accept_thread_.join();
    std::vector<std::unique_ptr<Worker>> workers;
    {
      std::lock_guard<std::mutex> g(conn_mu_);
      workers.swap(workers_);
    }
    for (auto& w : workers) {
      if (w->thread.joinable()) w->thread.join();
    }
    std::lock_guard<std::mutex> g(stopped_mu_);
    stopped_ = true;
    stopped_cv_.notify_all();
  }

  void Wait() {
    std::unique_lock<std::mutex> l(stopped_mu_);
    stopped_cv_.wait(l, [this] { return stopped_; });
  }

  bool stopping() const { return stopping_.load(); }

  ~FramedServer() { Stop(); }

 private:
  FramedServer(int listen_fd, int port, Handler handler, StopHook stop_hook)
      : listen_fd_(listen_fd),
        port_(port),
        handler_(std::move(handler)),
        stop_hook_(std::move(stop_hook)) {
    accept_thread_ = std::thread([this] { AcceptLoop(); });
  }

  struct Worker {
    std::thread thread;
    std::atomic<bool> done{false};
    std::mutex mu;       // serializes fd close (worker) vs shutdown (Stop)
    bool closed = false;
    int fd = -1;
  };

  void AcceptLoop() {
    while (!stopping_.load()) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) break;
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> g(conn_mu_);
      // reap finished workers so short-lived connections don't accumulate
      for (auto it = workers_.begin(); it != workers_.end();) {
        if ((*it)->done.load()) {
          if ((*it)->thread.joinable()) (*it)->thread.join();
          it = workers_.erase(it);
        } else {
          ++it;
        }
      }
      workers_.emplace_back(new Worker);
      Worker* w = workers_.back().get();
      w->fd = fd;
      w->thread = std::thread([this, w] { Serve(w); });
    }
  }

  void Serve(Worker* w) {
    const int fd = w->fd;
    std::vector<char> body;
    while (!stopping_.load()) {
      char hdr[5];
      if (!ReadFull(fd, hdr, 5)) break;
      uint32_t len;
      std::memcpy(&len, hdr, 4);
      uint8_t op = static_cast<uint8_t>(hdr[4]);
      if (len > kMaxFrameLen) {
        // reply, then close: the oversized body is still in flight and the
        // stream cannot be re-synchronized without reading all of it
        SendReply(fd, -11, nullptr, 0);
        break;
      }
      body.resize(len);
      if (len && !ReadFull(fd, body.data(), len)) break;
      int rc = handler_(fd, op, body.data(), len);
      if (rc == 2) {
        // handler requested full shutdown; Stop() joins workers, so hand
        // off to a detached thread (self-join otherwise)
        std::thread([this] { Stop(); }).detach();
        break;
      }
      if (rc != 0) break;
    }
    {
      std::lock_guard<std::mutex> g(w->mu);
      ::close(fd);
      w->closed = true;  // under mu: Stop() can no longer shutdown this fd
    }
    w->done.store(true);  // reaper may now join this worker
  }

  int listen_fd_;
  int port_;
  Handler handler_;
  StopHook stop_hook_;
  std::atomic<bool> stopping_{false};
  std::thread accept_thread_;
  std::mutex conn_mu_;
  std::vector<std::unique_ptr<Worker>> workers_;
  std::mutex stopped_mu_;
  std::condition_variable stopped_cv_;
  bool stopped_ = false;
};

}  // namespace ptn

#endif  // PADDLE_TPU_NATIVE_NET_H_
