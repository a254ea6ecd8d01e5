// Point-to-point byte transport of the control plane -- native core.
//
// The port's copy of chainermn_tpu/runtime/dcn_transport.cpp: the
// framing/socket layer under chainermn_tpu_torch.runtime.control_plane,
// carrying pickled control-plane objects between the processes of a run
// (one per GPU) over TCP.  Wire-compatible with the pure-Python transport
// in runtime/transport.py and with the JAX package's transports:
//
//   frame    := u32 src | u32 tag | u64 len | payload          (little endian)
//   handshake: every rank connects to the coordinator (rank 0) and sends its
//   listen address; rank 0 replies with the full peer table as JSON
//   [[rank, "host:port"], ...] -- the reference's hostname-allgather
//   bootstrap over sockets.
//
// Exposed as a C ABI consumed by ctypes (runtime/native.py); no Python.h
// dependency, so it builds with a bare `g++ -shared`.
//
// Build (runtime/native.py does it at first use, into build/native/):
//   g++ -O2 -std=c++17 -fPIC -shared -pthread dcn_transport.cpp -o libdcn.so

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct FrameHeader {
  uint32_t src;
  uint32_t tag;
  uint64_t len;
} __attribute__((packed));

static_assert(sizeof(FrameHeader) == 16, "header must match Python struct <IIQ");

thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k <= 0) {
      if (k < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k <= 0) {
      if (k < 0 && errno == EINTR) continue;
      return false;
    }
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

// Frame payload holder.  ::malloc-backed (NOT std::string: resize()
// value-initializes, which at GiB payloads is a full extra memory pass —
// measured to collapse loopback goodput to 58 MB/s at 2 GiB on this
// 1-core host).  Ownership moves through the inbox and is RELEASED to the
// ctypes caller in dcn_recv (who frees via dcn_free -> ::free), so the
// receive path's only copies are the socket read and the final
// Python-bytes construction — same count as the Python fallback.
struct Buffer {
  uint8_t* data = nullptr;
  uint64_t len = 0;
  Buffer() = default;
  explicit Buffer(uint64_t n)
      : data(static_cast<uint8_t*>(::malloc(n ? n : 1))), len(n) {}
  Buffer(const void* src, uint64_t n) : Buffer(n) {
    if (data && n) std::memcpy(data, src, n);
  }
  Buffer(Buffer&& o) noexcept : data(o.data), len(o.len) {
    o.data = nullptr;
    o.len = 0;
  }
  Buffer& operator=(Buffer&& o) noexcept {
    if (this != &o) {
      ::free(data);
      data = o.data;
      len = o.len;
      o.data = nullptr;
      o.len = 0;
    }
    return *this;
  }
  Buffer(const Buffer&) = delete;
  Buffer& operator=(const Buffer&) = delete;
  ~Buffer() { ::free(data); }
  uint8_t* release() {
    uint8_t* p = data;
    data = nullptr;
    len = 0;
    return p;
  }
};

bool write_frame(int fd, uint32_t src, uint32_t tag, const void* payload,
                 uint64_t len) {
  FrameHeader h{src, tag, len};
  // One buffered write for small frames avoids a partial-header race with
  // TCP_NODELAY; large payloads go in two writes.
  if (len <= 64 * 1024) {
    std::vector<char> buf(sizeof(h) + len);
    std::memcpy(buf.data(), &h, sizeof(h));
    if (len) std::memcpy(buf.data() + sizeof(h), payload, len);
    return send_all(fd, buf.data(), buf.size());
  }
  return send_all(fd, &h, sizeof(h)) && send_all(fd, payload, len);
}

bool read_frame(int fd, uint32_t* src, uint32_t* tag, Buffer* payload) {
  FrameHeader h;
  if (!recv_all(fd, &h, sizeof(h))) return false;
  Buffer buf(h.len);
  if (!buf.data) return false;  // allocation failed (absurd len / OOM)
  if (h.len && !recv_all(fd, buf.data, h.len)) return false;
  *payload = std::move(buf);
  *src = h.src;
  *tag = h.tag;
  return true;
}

int connect_to(const std::string& host, int port, double timeout_s,
               const std::atomic<bool>* cancel = nullptr) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(timeout_s);
  for (;;) {
    // Abort promptly when the owning transport is closing: a sender stuck
    // retrying an unreachable peer must not pin close() for the full
    // connect timeout via the in-flight drain.
    if (cancel && cancel->load()) return -1;
    struct addrinfo hints {};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo* res = nullptr;
    std::string port_s = std::to_string(port);
    if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) == 0 && res) {
      int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
      if (fd >= 0) {
        if (::connect(fd, res->ai_addr, res->ai_addrlen) == 0) {
          freeaddrinfo(res);
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          return fd;
        }
        ::close(fd);
      }
      freeaddrinfo(res);
    }
    if (std::chrono::steady_clock::now() > deadline) return -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
}

// Parse the handshake table [[rank, "host:port"], ...] (json.dumps output of
// the Python side).  Minimal scanner — the format is fixed and machine
// generated; anything unexpected fails the handshake rather than guessing.
bool parse_table(const std::string& s, std::map<int, std::string>* out) {
  size_t i = 0;
  auto skip_ws = [&] { while (i < s.size() && isspace((unsigned char)s[i])) ++i; };
  skip_ws();
  if (i >= s.size() || s[i] != '[') return false;
  ++i;
  for (;;) {
    skip_ws();
    if (i < s.size() && s[i] == ']') { ++i; return true; }
    if (i >= s.size() || s[i] != '[') return false;
    ++i;
    skip_ws();
    size_t j = i;
    while (j < s.size() && (isdigit((unsigned char)s[j]) || s[j] == '-')) ++j;
    if (j == i) return false;
    int rank = std::stoi(s.substr(i, j - i));
    i = j;
    skip_ws();
    if (i >= s.size() || s[i] != ',') return false;
    ++i;
    skip_ws();
    if (i >= s.size() || s[i] != '"') return false;
    ++i;
    j = s.find('"', i);
    if (j == std::string::npos) return false;
    (*out)[rank] = s.substr(i, j - i);
    i = j + 1;
    skip_ws();
    if (i >= s.size() || s[i] != ']') return false;
    ++i;
    skip_ws();
    if (i < s.size() && s[i] == ',') ++i;
  }
}

std::string dump_table(const std::map<int, std::string>& table) {
  std::string out = "[";
  bool first = true;
  for (const auto& [rank, addr] : table) {
    if (!first) out += ", ";
    first = false;
    out += "[" + std::to_string(rank) + ", \"" + addr + "\"]";
  }
  out += "]";
  return out;
}

class Transport {
 public:
  Transport(int rank, int size) : rank_(rank), size_(size) {
    // Inbox byte budget (backpressure): a reader thread blocks before
    // pushing the inbox past this mark, so unread bytes stay in the kernel
    // socket buffers and TCP flow control stalls the peer.  Memory is then
    // bounded at ~HWM + one message regardless of how far ahead a sender
    // runs (the GiB-scale analogue of the reference's INT_MAX chunking
    // concern).  Mirrors the Python fallback's budget.
    if (const char* env = std::getenv("CHAINERMN_TPU_INBOX_HWM")) {
      char* end = nullptr;
      unsigned long long v = std::strtoull(env, &end, 10);
      if (end && *end == '\0' && v > 0) hwm_ = v;
    }
  }

  bool init(const std::string& coordinator, const std::string& my_host) {
    // Listen on an ephemeral port.
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return fail("socket() failed");
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = INADDR_ANY;
    addr.sin_port = 0;
    if (::bind(listen_fd_, (sockaddr*)&addr, sizeof(addr)) != 0)
      return fail("bind() failed");
    if (::listen(listen_fd_, size_ + 8) != 0) return fail("listen() failed");
    socklen_t alen = sizeof(addr);
    getsockname(listen_fd_, (sockaddr*)&addr, &alen);
    int my_port = ntohs(addr.sin_port);

    accept_thread_ = std::thread([this] { accept_loop(); });

    std::string my_addr = my_host + ":" + std::to_string(my_port);
    auto colon = coordinator.rfind(':');
    if (colon == std::string::npos) return fail("coordinator must be host:port");
    std::string chost = coordinator.substr(0, colon);
    int cport = std::stoi(coordinator.substr(colon + 1));
    return handshake(chost, cport, my_addr);
  }

  bool send(int dest, uint32_t tag, const void* data, uint64_t len) {
    if (dest == rank_) {
      Buffer copy(data, len);
      if (!copy.data) return fail("self-send allocation failed");
      push(rank_, tag, std::move(copy), /*wait_budget=*/false);
      return true;
    }
    // Register as an in-flight sender for the WHOLE call — including the
    // connect phase, which can block for seconds with no fd registered
    // anywhere close() could shut down.  close()/~Transport wait for
    // active_sends_ == 0 before the object (out_locks_, out_fds_, peers_)
    // is torn down; registering only around the write would let close()
    // return while a connecting sender still holds references into us.
    struct SendGuard {
      Transport* t;
      ~SendGuard() {
        {
          std::lock_guard<std::mutex> g(t->out_mutex_);
          --t->active_sends_;
        }
        t->out_cv_.notify_all();
      }
    };
    {
      std::lock_guard<std::mutex> g(out_mutex_);
      if (closed_.load()) return fail("transport closed");
      ++active_sends_;
    }
    SendGuard guard{this};
    std::unique_lock<std::mutex> out_guard(out_mutex_);
    auto& lock = out_locks_[dest];  // per-dest serialization
    out_guard.unlock();
    std::lock_guard<std::mutex> g(lock);
    int fd;
    {
      std::lock_guard<std::mutex> g2(out_mutex_);
      if (closed_.load()) return fail("transport closed");
      auto it = out_fds_.find(dest);
      fd = it == out_fds_.end() ? -1 : it->second;
    }
    if (fd < 0) {
      auto it = peers_.find(dest);
      if (it == peers_.end()) return fail("unknown peer " + std::to_string(dest));
      auto colon = it->second.rfind(':');
      fd = connect_to(it->second.substr(0, colon),
                      std::stoi(it->second.substr(colon + 1)), 30.0,
                      &closed_);
      if (fd < 0) return fail("connect to peer " + std::to_string(dest) + " failed");
      std::lock_guard<std::mutex> g2(out_mutex_);
      if (closed_.load()) {
        ::close(fd);
        return fail("transport closed");
      }
      out_fds_[dest] = fd;
    }
    if (!write_frame(fd, rank_, tag, data, len))
      return fail("send to peer " + std::to_string(dest) + " failed");
    return true;
  }

  // Returns true and fills *out, or false on timeout/shutdown.
  bool recv(int source, uint32_t tag, double timeout_s, Buffer* out) {
    std::unique_lock<std::mutex> lk(inbox_mutex_);
    // Registered so close() can wait for in-flight receivers to drain
    // before the object is destroyed (use-after-free otherwise).
    ++active_recvs_;
    auto key = std::make_pair(source, tag);
    bool ok = inbox_cv_.wait_for(
        lk, std::chrono::duration<double>(timeout_s),
        [&] { return closed_.load() || !inbox_[key].empty(); });
    bool success = ok && !inbox_[key].empty();
    if (success) {
      *out = std::move(inbox_[key].front());
      inbox_[key].pop_front();
      inbox_bytes_ -= out->len;  // releases parked readers via notify
    }
    --active_recvs_;
    inbox_cv_.notify_all();
    if (!success)
      return fail(closed_.load() ? "transport closed"
                                 : "recv timed out (source " +
                                       std::to_string(source) + ", tag " +
                                       std::to_string(tag) + ")");
    return true;
  }

  void close() {
    closed_.store(true);
    if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      listen_fd_ = -1;
    }
    {
      // Shut down first (unblocks any sender mid-write; fd stays valid),
      // drain in-flight senders, then close — never close under a writer.
      std::unique_lock<std::mutex> g(out_mutex_);
      for (auto& [dest, fd] : out_fds_) ::shutdown(fd, SHUT_RDWR);
      out_cv_.wait(g, [&] { return active_sends_ == 0; });
      for (auto& [dest, fd] : out_fds_) ::close(fd);
      out_fds_.clear();
    }
    {
      std::lock_guard<std::mutex> g(conn_mutex_);
      for (int fd : in_fds_) ::shutdown(fd, SHUT_RDWR);
    }
    {
      // Wake blocked receivers and wait for them to leave recv() before the
      // destructor tears down the mutex/condvar they are using.
      std::unique_lock<std::mutex> lk(inbox_mutex_);
      inbox_cv_.notify_all();
      inbox_cv_.wait(lk, [&] { return active_recvs_ == 0; });
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    for (auto& t : reader_threads_)
      if (t.joinable()) t.join();
  }

  // If close() threw partway, threads may still be blocked on live fds; a
  // detached thread would then dereference freed members (use-after-free).
  // Re-run the (idempotent) shutdown passes so every blocked syscall returns,
  // then join.  Detach only as a last resort if a join itself throws —
  // destroying a joinable std::thread would std::terminate the process.
  ~Transport() {
    closed_.store(true);
    if (listen_fd_ >= 0) ::shutdown(listen_fd_, SHUT_RDWR);
    {
      std::lock_guard<std::mutex> g(out_mutex_);
      for (auto& [dest, fd] : out_fds_) ::shutdown(fd, SHUT_RDWR);
    }
    {
      std::lock_guard<std::mutex> g(conn_mutex_);
      for (int fd : in_fds_) ::shutdown(fd, SHUT_RDWR);
    }
    try {
      // Drain caller threads still inside send()/recv() (close() may have
      // thrown before its own drains ran) — they hold references to the
      // members destroyed right after this returns.
      {
        std::unique_lock<std::mutex> g(out_mutex_);
        out_cv_.wait(g, [&] { return active_sends_ == 0; });
      }
      {
        std::unique_lock<std::mutex> lk(inbox_mutex_);
        inbox_cv_.notify_all();
        inbox_cv_.wait(lk, [&] { return active_recvs_ == 0; });
      }
      if (accept_thread_.joinable()) accept_thread_.join();
      for (auto& t : reader_threads_)
        if (t.joinable()) t.join();
    } catch (...) {
      if (accept_thread_.joinable()) accept_thread_.detach();
      for (auto& t : reader_threads_)
        if (t.joinable()) t.detach();
    }
  }

  const std::map<int, std::string>& peers() const { return peers_; }

 private:
  bool fail(const std::string& msg) {
    set_error(msg + (errno ? std::string(": ") + strerror(errno) : ""));
    return false;
  }

  // wait_budget: reader threads park while the inbox is over budget
  // (backpressure via TCP); self-sends never wait (the sender would be
  // waiting on itself).  One message is always admitted once under the
  // mark, so payloads larger than the budget still pass.
  //
  // IN-ORDER-CONSUMPTION ASSUMPTION (applies equally to the HWM knob,
  // CHAINERMN_TPU_INBOX_HWM): if a consumer blocks in recv() on a
  // (src, tag) frame that sits BEHIND >= HWM bytes of unconsumed frames
  // on the same connection, the reader thread parks on the budget and
  // that frame never arrives — recv fails by timeout.  Every collective
  // in this codebase consumes frames in send order per peer (tags are
  // issued and awaited monotonically), so the stall cannot occur there;
  // out-of-order consumers must either drain eagerly or raise the HWM
  // above their reorder window.  Same shape in PyTransport._enqueue.
  void push(int src, uint32_t tag, Buffer&& payload, bool wait_budget) {
    {
      std::unique_lock<std::mutex> lk(inbox_mutex_);
      if (wait_budget) {
        inbox_cv_.wait(lk, [&] {
          return closed_.load() || inbox_bytes_ < hwm_;
        });
        if (closed_.load()) return;  // teardown: connection is dying anyway
      }
      inbox_bytes_ += payload.len;
      peak_inbox_bytes_ = std::max(peak_inbox_bytes_, inbox_bytes_);
      inbox_[{src, tag}].push_back(std::move(payload));
    }
    inbox_cv_.notify_all();
  }

  void accept_loop() {
    for (;;) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (closed_.load()) return;
        if (errno == EINTR) continue;
        return;
      }
      {
        std::lock_guard<std::mutex> g(conn_mutex_);
        // A connection can be accepted concurrently with close(): close()
        // sets closed_ and shuts down the fds already in in_fds_, but this
        // fd is not registered yet, so close() would miss it and the reader
        // spawned for it could block forever.  Re-checking closed_ under
        // conn_mutex_ closes the window: either close()'s shutdown pass ran
        // first (we see closed_ and drop the fd) or we register first (the
        // pass shuts the fd down).
        if (closed_.load()) {
          ::close(fd);
          return;
        }
        in_fds_.push_back(fd);
        reader_threads_.emplace_back([this, fd] { reader_loop(fd); });
      }
    }
  }

  void reader_loop(int fd) {
    uint32_t src, tag;
    Buffer payload;
    while (read_frame(fd, &src, &tag, &payload)) {
      push(static_cast<int>(src), tag, std::move(payload),
           /*wait_budget=*/true);
    }
    {
      // De-register before closing: otherwise close() could ::shutdown a
      // recycled descriptor number belonging to an unrelated connection.
      std::lock_guard<std::mutex> g(conn_mutex_);
      in_fds_.erase(std::remove(in_fds_.begin(), in_fds_.end(), fd),
                    in_fds_.end());
    }
    ::close(fd);
  }

  bool handshake(const std::string& chost, int cport, const std::string& my_addr) {
    if (rank_ == 0) {
      int srv = ::socket(AF_INET, SOCK_STREAM, 0);
      if (srv < 0) return fail("coordinator socket() failed");
      int one = 1;
      setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
      sockaddr_in addr{};
      addr.sin_family = AF_INET;
      addr.sin_addr.s_addr = INADDR_ANY;
      addr.sin_port = htons(cport);
      if (::bind(srv, (sockaddr*)&addr, sizeof(addr)) != 0)
        return fail("coordinator bind(" + std::to_string(cport) + ") failed");
      if (::listen(srv, size_ + 8) != 0) return fail("coordinator listen failed");
      peers_[0] = my_addr;
      std::vector<std::pair<int, int>> conns;  // (rank, fd)
      while (static_cast<int>(peers_.size()) < size_) {
        int c = ::accept(srv, nullptr, nullptr);
        if (c < 0) {
          if (errno == EINTR) continue;
          ::close(srv);
          return fail("coordinator accept failed");
        }
        uint32_t src, tag;
        Buffer payload;
        if (!read_frame(c, &src, &tag, &payload)) {
          ::close(c);
          continue;
        }
        peers_[static_cast<int>(src)] = std::string(
            reinterpret_cast<const char*>(payload.data), payload.len);
        conns.emplace_back(static_cast<int>(src), c);
      }
      std::string blob = dump_table(peers_);
      for (auto& [r, c] : conns) {
        write_frame(c, 0, 0, blob.data(), blob.size());
        ::close(c);
      }
      ::close(srv);
      return true;
    }
    int c = connect_to(chost, cport, 60.0);
    if (c < 0) return fail("connect to coordinator failed");
    if (!write_frame(c, rank_, 0, my_addr.data(), my_addr.size())) {
      ::close(c);
      return fail("handshake send failed");
    }
    uint32_t src, tag;
    Buffer raw;
    bool ok = read_frame(c, &src, &tag, &raw);
    ::close(c);
    if (!ok) return fail("handshake recv failed");
    std::string blob(reinterpret_cast<const char*>(raw.data), raw.len);
    if (!parse_table(blob, &peers_)) return fail("bad handshake table: " + blob);
    return true;
  }

  int rank_, size_;
  int listen_fd_ = -1;
  int active_recvs_ = 0;  // guarded by inbox_mutex_
  int active_sends_ = 0;  // guarded by out_mutex_
  std::atomic<bool> closed_{false};
  std::map<int, std::string> peers_;

  std::thread accept_thread_;
  std::mutex conn_mutex_;
  std::vector<int> in_fds_;
  std::vector<std::thread> reader_threads_;

  std::mutex out_mutex_;
  std::condition_variable out_cv_;
  std::map<int, int> out_fds_;
  std::map<int, std::mutex> out_locks_;

  std::mutex inbox_mutex_;
  std::condition_variable inbox_cv_;
  std::map<std::pair<int, uint32_t>, std::deque<Buffer>> inbox_;

 public:
  uint64_t hwm_ = 1ull << 30;          // see ctor
  uint64_t inbox_bytes_ = 0;           // guarded by inbox_mutex_
  uint64_t peak_inbox_bytes_ = 0;      // guarded by inbox_mutex_

  void stats(uint64_t* inbox_bytes, uint64_t* peak) {
    std::lock_guard<std::mutex> g(inbox_mutex_);
    *inbox_bytes = inbox_bytes_;
    *peak = peak_inbox_bytes_;
  }
};

}  // namespace

// C++ exceptions (std::stoi on malformed ports/ranks, bad_alloc, ...) must
// not unwind into the ctypes FFI frame — that std::terminates the whole
// Python process.  Every extern "C" body is exception-contained.
extern "C" {

void* dcn_create(int rank, int size, const char* coordinator,
                 const char* my_host) try {
  auto* t = new Transport(rank, size);
  if (!t->init(coordinator, my_host)) {
    // close() joins the already-running accept thread; deleting a Transport
    // with a joinable std::thread would std::terminate the whole process.
    std::string err = g_last_error;  // close() may overwrite it
    t->close();
    g_last_error = err;
    delete t;
    return nullptr;
  }
  return t;
} catch (const std::exception& e) {
  set_error(std::string("native transport init: ") + e.what());
  return nullptr;
} catch (...) {
  set_error("native transport init: unknown C++ exception");
  return nullptr;
}

int dcn_send(void* handle, int dest, uint32_t tag, const uint8_t* data,
             uint64_t len) try {
  return static_cast<Transport*>(handle)->send(dest, tag, data, len) ? 0 : -1;
} catch (const std::exception& e) {
  set_error(std::string("native send: ") + e.what());
  return -1;
} catch (...) {
  set_error("native send: unknown C++ exception");
  return -1;
}

// On success returns len and sets *out (caller frees with dcn_free); on
// failure returns -1.  Zero-copy: the Buffer read off the wire is released
// to the caller directly (::malloc-backed, freed by dcn_free's ::free).
int64_t dcn_recv(void* handle, int source, uint32_t tag, double timeout_s,
                 uint8_t** out) try {
  Buffer payload;
  if (!static_cast<Transport*>(handle)->recv(source, tag, timeout_s, &payload))
    return -1;
  int64_t n = static_cast<int64_t>(payload.len);
  *out = payload.release();
  return n;
} catch (const std::exception& e) {
  set_error(std::string("native recv: ") + e.what());
  return -1;
} catch (...) {
  set_error("native recv: unknown C++ exception");
  return -1;
}

void dcn_free(uint8_t* buf) { ::free(buf); }

// Peer table as the handshake JSON (for introspection/debugging).
int64_t dcn_peers(void* handle, char* out, int64_t cap) {
  std::string s = dump_table(static_cast<Transport*>(handle)->peers());
  if (static_cast<int64_t>(s.size()) + 1 > cap) return -(int64_t)s.size() - 1;
  std::memcpy(out, s.c_str(), s.size() + 1);
  return static_cast<int64_t>(s.size());
}

// Two-phase teardown for callers that may still have threads inside
// dcn_send/dcn_recv: dcn_shutdown drains and unblocks them WITHOUT freeing
// (safe to call while they are in flight — it is what makes them return),
// the caller then waits for its own in-flight count to reach zero, and
// only then dcn_destroy frees the object.  The Python binding does exactly
// this; calling dcn_destroy with callers still inside is a use-after-free.
void dcn_shutdown(void* handle) {
  auto* t = static_cast<Transport*>(handle);
  try {
    t->close();
  } catch (...) {
    set_error("native close: unknown C++ exception");
  }
}

void dcn_destroy(void* handle) { delete static_cast<Transport*>(handle); }

// One-shot close-and-free, kept for single-threaded callers.  The
// destructor re-runs the shutdown passes and drains registered callers,
// but cannot protect a caller that has not yet entered the counter.
void dcn_close(void* handle) {
  dcn_shutdown(handle);
  dcn_destroy(handle);
}

// Inbox buffering stats: current bytes queued and the high-water peak.
// Lets callers (tests, benchmarks) assert the backpressure bound
// peak <= HWM + largest message without instrumenting the process.
void dcn_stats(void* handle, uint64_t* inbox_bytes, uint64_t* peak) {
  static_cast<Transport*>(handle)->stats(inbox_bytes, peak);
}

const char* dcn_last_error() { return g_last_error.c_str(); }

}  // extern "C"
