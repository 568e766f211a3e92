// Native runtime components of horovod_tpu_torch (a copy of the JAX
// package's horovod_tpu/native/hvd_native.cc).
//
// Two pieces where the reference implements C++ and Python-level latency
// actually matters:
//
// 1. Timeline writer — reference horovod/common/timeline.{h,cc}: producers
//    push fixed-size event records into a lock-free MPSC ring buffer
//    (reference uses a boost SPSC queue, timeline.h:47-75); a dedicated
//    thread drains records to Chrome-tracing JSON.  Event cost on the hot
//    path is one atomic fetch_add + a few stores (no GIL-held file IO).
//
// 2. Rendezvous KV store — reference horovod/common/gloo/http_store.{h,cc}
//    + runner/http/http_server.py (KVStoreHandler): workers rendezvous
//    through a launcher-side key-value service.  Here: a threaded TCP
//    server with blocking GET-until-set semantics (the HTTPStore wait
//    loop, gloo_context.cc:71-91) over a length-prefixed binary frame.
//
// Exposed as a plain C API for ctypes (no pybind11 in this image).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread hvd_native.cc -o ...

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Timeline writer
// ---------------------------------------------------------------------------

namespace {

struct Event {
  int32_t name_id;   // interned activity name
  int32_t tid_id;    // interned tensor/thread name
  int64_t ts_us;     // microseconds since writer start
  char phase;        // 'B', 'E', 'i'
  char _pad[7];
};

// Bounded MPSC slot (Vyukov scheme): seq == ticket means free for that
// ticket's producer; seq == ticket + 1 means committed, ready to drain.
struct Slot {
  std::atomic<uint64_t> seq;
  Event e;
};

struct TimelineWriter {
  explicit TimelineWriter(const char* path, uint32_t capacity)
      : capacity_(capacity), buf_(capacity), start_(now_us()) {
    for (uint32_t i = 0; i < capacity_; ++i)
      buf_[i].seq.store(i, std::memory_order_relaxed);
    file_ = std::fopen(path, "w");
    if (file_) std::fputs("[\n", file_);
    writer_ = std::thread([this] { DrainLoop(); });
  }

  ~TimelineWriter() { Close(); }

  int32_t Intern(const char* s) {
    std::lock_guard<std::mutex> lk(intern_mu_);
    auto it = intern_.find(s);
    if (it != intern_.end()) return it->second;
    int32_t id = static_cast<int32_t>(names_.size());
    names_.emplace_back(s);
    intern_.emplace(s, id);
    return id;
  }

  // Multi-producer push: claim a ticket, wait for the slot to be recycled
  // (consumer drains at disk speed, so the wait is bounded — the
  // reference's boost-lockfree push spins the same way on full), write,
  // publish by bumping the slot's per-slot sequence.  Per-slot sequences
  // make out-of-order producer commits safe: the drain only consumes a
  // slot whose own sequence says "committed".
  void Push(int32_t name_id, int32_t tid_id, char phase) {
    uint64_t ticket = head_.fetch_add(1, std::memory_order_acq_rel);
    Slot& s = buf_[ticket % capacity_];
    while (s.seq.load(std::memory_order_acquire) != ticket) {
      if (closing_.load(std::memory_order_acquire)) {
        dropped_.fetch_add(1, std::memory_order_relaxed);
        return;
      }
      std::this_thread::yield();
    }
    s.e.name_id = name_id;
    s.e.tid_id = tid_id;
    s.e.ts_us = now_us() - start_;
    s.e.phase = phase;
    s.seq.store(ticket + 1, std::memory_order_release);
  }

  void DrainLoop() {
    uint64_t t = 0;
    while (true) {
      Slot& s = buf_[t % capacity_];
      if (s.seq.load(std::memory_order_acquire) == t + 1) {
        WriteEvent(s.e);
        s.seq.store(t + capacity_, std::memory_order_release);
        ++t;
        continue;
      }
      if (closing_.load(std::memory_order_acquire)) {
        if (t >= head_.load(std::memory_order_acquire)) return;
        // claimed but uncommitted: grace-wait for a mid-write producer;
        // an abandoned slot (producer saw closing_) never commits
        bool committed = false;
        for (int i = 0; i < 1000; ++i) {
          if (s.seq.load(std::memory_order_acquire) == t + 1) {
            committed = true;
            break;
          }
          std::this_thread::sleep_for(std::chrono::microseconds(50));
        }
        if (!committed) return;
        continue;
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(2));
    }
  }

  void WriteEvent(const Event& e) {
    if (!file_) return;
    if (!first_) std::fputs(",\n", file_);
    first_ = false;
    // Copy interned strings under intern_mu_: producers' Intern() may
    // emplace_back and reallocate names_ concurrently with this drain
    // thread, so an unlocked names_[id] read is a use-after-free race.
    std::string name_s, tid_s("runtime");
    {
      std::lock_guard<std::mutex> lk(intern_mu_);
      if (e.name_id >= 0) name_s = names_[e.name_id];
      if (e.tid_id >= 0) tid_s = names_[e.tid_id];
    }
    const char* name = name_s.c_str();
    const char* tid = tid_s.c_str();
    if (e.phase == 'E') {
      std::fprintf(file_, "{\"ph\":\"E\",\"tid\":\"%s\",\"pid\":1,"
                   "\"ts\":%lld}", tid, (long long)e.ts_us);
    } else if (e.phase == 'i') {
      std::fprintf(file_, "{\"ph\":\"i\",\"name\":\"%s\",\"s\":\"p\","
                   "\"tid\":\"%s\",\"pid\":1,\"ts\":%lld}",
                   name, tid, (long long)e.ts_us);
    } else {
      std::fprintf(file_, "{\"ph\":\"B\",\"name\":\"%s\",\"cat\":\"%s\","
                   "\"tid\":\"%s\",\"pid\":1,\"ts\":%lld}",
                   name, name, tid, (long long)e.ts_us);
    }
  }

  void Close() {
    bool expected = false;
    if (!closed_.compare_exchange_strong(expected, true)) return;
    closing_.store(true, std::memory_order_release);
    if (writer_.joinable()) writer_.join();
    if (file_) {
      uint64_t d = dropped_.load();
      if (d) {
        if (!first_) std::fputs(",\n", file_);
        std::fprintf(file_, "{\"ph\":\"i\",\"name\":\"DROPPED_%llu_EVENTS\","
                     "\"s\":\"g\",\"tid\":\"runtime\",\"pid\":1,\"ts\":0}",
                     (unsigned long long)d);
      }
      std::fputs("\n]\n", file_);
      std::fclose(file_);
      file_ = nullptr;
    }
  }

  static int64_t now_us() {
    return std::chrono::duration_cast<std::chrono::microseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }

  uint32_t capacity_;
  std::vector<Slot> buf_;
  int64_t start_;
  std::FILE* file_ = nullptr;
  bool first_ = true;
  std::thread writer_;
  std::atomic<uint64_t> head_{0}, dropped_{0};
  std::atomic<bool> closing_{false}, closed_{false};
  std::mutex intern_mu_;
  std::map<std::string, int32_t> intern_;
  std::vector<std::string> names_;
};

// ---------------------------------------------------------------------------
// KV store (rendezvous)
// ---------------------------------------------------------------------------

bool ReadExact(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool WriteExact(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::write(fd, p, n);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

struct KvStore {
  int listen_fd = -1;
  int port = 0;
  std::thread accept_thread;
  std::atomic<bool> stopping{false};
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::string> data;
  std::vector<std::thread> workers;

  // frame: op(1) keylen(4,be) key [vallen(4,be) val]
  //   'S' set -> reply 1 byte 0x01
  //   'G' get, blocks until key exists or timeout(4, be, ms) -> reply
  //       vallen(4,be) + val; vallen = 0xFFFFFFFF on timeout
  //   'D' dump count -> reply count(4,be) of keys (diagnostics)
  void Serve(int fd) {
    for (;;) {
      char op;
      if (!ReadExact(fd, &op, 1)) break;
      uint32_t klen_be;
      if (!ReadExact(fd, &klen_be, 4)) break;
      uint32_t klen = ntohl(klen_be);
      if (klen > (1u << 20)) break;
      std::string key(klen, '\0');
      if (!ReadExact(fd, key.data(), klen)) break;
      if (op == 'S') {
        uint32_t vlen_be;
        if (!ReadExact(fd, &vlen_be, 4)) break;
        uint32_t vlen = ntohl(vlen_be);
        if (vlen > (1u << 26)) break;
        std::string val(vlen, '\0');
        if (!ReadExact(fd, val.data(), vlen)) break;
        {
          std::lock_guard<std::mutex> lk(mu);
          data[key] = std::move(val);
        }
        cv.notify_all();
        char ok = 1;
        if (!WriteExact(fd, &ok, 1)) break;
      } else if (op == 'G') {
        uint32_t to_be;
        if (!ReadExact(fd, &to_be, 4)) break;
        uint32_t timeout_ms = ntohl(to_be);
        std::string val;
        bool found = false;
        {
          std::unique_lock<std::mutex> lk(mu);
          found = cv.wait_for(
              lk, std::chrono::milliseconds(timeout_ms), [&] {
                return stopping.load() || data.count(key) > 0;
              }) && data.count(key) > 0;
          if (found) val = data[key];
        }
        uint32_t vlen_be = htonl(found ? (uint32_t)val.size() : 0xFFFFFFFFu);
        if (!WriteExact(fd, &vlen_be, 4)) break;
        if (found && !WriteExact(fd, val.data(), val.size())) break;
      } else if (op == 'D') {
        uint32_t n_be;
        {
          std::lock_guard<std::mutex> lk(mu);
          n_be = htonl((uint32_t)data.size());
        }
        if (!WriteExact(fd, &n_be, 4)) break;
      } else {
        break;
      }
    }
    ::close(fd);
  }

  bool Start(int requested_port) {
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(requested_port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0 ||
        ::listen(listen_fd, 128) != 0) {
      ::close(listen_fd);
      return false;
    }
    socklen_t len = sizeof(addr);
    ::getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
    accept_thread = std::thread([this] {
      for (;;) {
        int fd = ::accept(listen_fd, nullptr, nullptr);
        if (fd < 0) {
          if (stopping.load()) return;
          continue;
        }
        workers.emplace_back([this, fd] { Serve(fd); });
      }
    });
    return true;
  }

  void Stop() {
    bool expected = false;
    if (!stopping.compare_exchange_strong(expected, true)) return;
    cv.notify_all();
    ::shutdown(listen_fd, SHUT_RDWR);
    ::close(listen_fd);
    if (accept_thread.joinable()) accept_thread.join();
    for (auto& w : workers)
      if (w.joinable()) w.join();
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

void* hvdtl_create(const char* path, uint32_t capacity) {
  return new TimelineWriter(path, capacity ? capacity : 65536);
}

int32_t hvdtl_intern(void* h, const char* s) {
  return static_cast<TimelineWriter*>(h)->Intern(s);
}

void hvdtl_event(void* h, int32_t name_id, int32_t tid_id, char phase) {
  static_cast<TimelineWriter*>(h)->Push(name_id, tid_id, phase);
}

uint64_t hvdtl_dropped(void* h) {
  return static_cast<TimelineWriter*>(h)->dropped_.load();
}

void hvdtl_close(void* h) {
  auto* w = static_cast<TimelineWriter*>(h);
  w->Close();
  delete w;
}

void* hvdkv_start(int port) {
  auto* s = new KvStore();
  if (!s->Start(port)) {
    delete s;
    return nullptr;
  }
  return s;
}

int hvdkv_port(void* h) { return static_cast<KvStore*>(h)->port; }

void hvdkv_stop(void* h) {
  auto* s = static_cast<KvStore*>(h);
  s->Stop();
  delete s;
}

}  // extern "C"
