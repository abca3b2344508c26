// TCPStore — native rendezvous key-value store + barrier.
//
// The port's copy of the JAX package's csrc/tcp_store.cpp, kept byte for
// byte on the wire (a tiny length-prefixed binary protocol over TCP), so
// either package's client talks to either package's server. It carries
// only control traffic: the cluster's RPC streams, heartbeats,
// registrations and the frontend epoch. Host code, built with g++ by
// paddle_tpu_torch/native/__init__.py, never by nvcc.
//
// C ABI (for ctypes): ts_server_start / ts_client_connect / ts_set /
// ts_get / ts_wait / ts_add / ts_delete / ts_close. All blocking calls
// take a timeout in milliseconds.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

enum class Cmd : uint8_t { SET = 0, GET = 1, WAIT = 2, ADD = 3, DEL = 4, PING = 5 };

// ---- framed io -------------------------------------------------------------
bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_bytes(int fd, const std::string& s) {
  uint32_t len = htonl(static_cast<uint32_t>(s.size()));
  return send_all(fd, &len, 4) && (s.empty() || send_all(fd, s.data(), s.size()));
}

bool recv_bytes(int fd, std::string* out) {
  uint32_t len = 0;
  if (!recv_all(fd, &len, 4)) return false;
  len = ntohl(len);
  out->resize(len);
  return len == 0 || recv_all(fd, &(*out)[0], len);
}

// ---- server ----------------------------------------------------------------
struct Server {
  int listen_fd = -1;
  std::thread accept_thread;
  std::atomic<bool> running{false};
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::string> data;
  std::vector<std::thread> workers;

  void handle(int fd) {
    for (;;) {
      uint8_t cmd;
      if (!recv_all(fd, &cmd, 1)) break;
      std::string key;
      if (!recv_bytes(fd, &key)) break;
      switch (static_cast<Cmd>(cmd)) {
        case Cmd::SET: {
          std::string val;
          if (!recv_bytes(fd, &val)) goto done;
          {
            std::lock_guard<std::mutex> lk(mu);
            data[key] = val;
          }
          cv.notify_all();
          if (!send_bytes(fd, "ok")) goto done;
          break;
        }
        case Cmd::GET: {
          std::string val;
          bool found;
          {
            std::lock_guard<std::mutex> lk(mu);
            auto it = data.find(key);
            found = it != data.end();
            if (found) val = it->second;
          }
          uint8_t ok = found ? 1 : 0;
          if (!send_all(fd, &ok, 1)) goto done;
          if (found && !send_bytes(fd, val)) goto done;
          break;
        }
        case Cmd::WAIT: {
          int64_t timeout_ms;
          if (!recv_all(fd, &timeout_ms, 8)) goto done;
          std::unique_lock<std::mutex> lk(mu);
          bool ok = cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                [&] { return data.count(key) > 0; });
          std::string val = ok ? data[key] : "";
          lk.unlock();
          uint8_t okb = ok ? 1 : 0;
          if (!send_all(fd, &okb, 1)) goto done;
          if (ok && !send_bytes(fd, val)) goto done;
          break;
        }
        case Cmd::ADD: {
          int64_t delta;
          if (!recv_all(fd, &delta, 8)) goto done;
          int64_t result;
          {
            std::lock_guard<std::mutex> lk(mu);
            int64_t cur = 0;
            auto it = data.find(key);
            if (it != data.end() && it->second.size() == 8)
              memcpy(&cur, it->second.data(), 8);
            result = cur + delta;
            std::string v(8, '\0');
            memcpy(&v[0], &result, 8);
            data[key] = v;
          }
          cv.notify_all();
          if (!send_all(fd, &result, 8)) goto done;
          break;
        }
        case Cmd::DEL: {
          {
            std::lock_guard<std::mutex> lk(mu);
            data.erase(key);
          }
          cv.notify_all();
          if (!send_bytes(fd, "ok")) goto done;
          break;
        }
        case Cmd::PING: {
          if (!send_bytes(fd, "pong")) goto done;
          break;
        }
      }
    }
  done:
    ::close(fd);
  }

  void accept_loop() {
    while (running.load()) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (!running.load()) break;
        continue;
      }
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      workers.emplace_back([this, fd] { handle(fd); });
    }
  }
};

}  // namespace

extern "C" {

// returns bound port (>0) on success, -errno on failure
int ts_server_start(const char* host, int port, void** handle_out) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -errno;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = host && *host ? inet_addr(host) : INADDR_ANY;
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    int e = errno;
    ::close(fd);
    return -e;
  }
  if (::listen(fd, 128) < 0) {
    int e = errno;
    ::close(fd);
    return -e;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  auto* srv = new Server();
  srv->listen_fd = fd;
  srv->running.store(true);
  srv->accept_thread = std::thread([srv] { srv->accept_loop(); });
  *handle_out = srv;
  return ntohs(addr.sin_port);
}

void ts_server_stop(void* handle) {
  auto* srv = static_cast<Server*>(handle);
  srv->running.store(false);
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  ::close(srv->listen_fd);
  if (srv->accept_thread.joinable()) srv->accept_thread.join();
  for (auto& w : srv->workers)
    if (w.joinable()) w.detach();  // clients may still be connected
  delete srv;
}

int ts_client_connect(const char* host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -errno;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = inet_addr(host);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    int e = errno;
    ::close(fd);
    return -e;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

int ts_set(int fd, const char* key, const char* val, int vlen) {
  uint8_t cmd = static_cast<uint8_t>(Cmd::SET);
  if (!send_all(fd, &cmd, 1) || !send_bytes(fd, key) ||
      !send_bytes(fd, std::string(val, vlen)))
    return -1;
  std::string resp;
  return recv_bytes(fd, &resp) ? 0 : -1;
}

// returns value length (>=0) or -1 not found / -2 io error; copies into buf
int ts_get(int fd, const char* key, char* buf, int buflen) {
  uint8_t cmd = static_cast<uint8_t>(Cmd::GET);
  if (!send_all(fd, &cmd, 1) || !send_bytes(fd, key)) return -2;
  uint8_t ok;
  if (!recv_all(fd, &ok, 1)) return -2;
  if (!ok) return -1;
  std::string val;
  if (!recv_bytes(fd, &val)) return -2;
  int n = static_cast<int>(val.size());
  if (n > buflen) n = buflen;
  memcpy(buf, val.data(), n);
  return static_cast<int>(val.size());
}

int ts_wait(int fd, const char* key, int64_t timeout_ms, char* buf, int buflen) {
  uint8_t cmd = static_cast<uint8_t>(Cmd::WAIT);
  if (!send_all(fd, &cmd, 1) || !send_bytes(fd, key) ||
      !send_all(fd, &timeout_ms, 8))
    return -2;
  uint8_t ok;
  if (!recv_all(fd, &ok, 1)) return -2;
  if (!ok) return -1;  // timeout
  std::string val;
  if (!recv_bytes(fd, &val)) return -2;
  int n = static_cast<int>(val.size());
  if (n > buflen) n = buflen;
  memcpy(buf, val.data(), n);
  return static_cast<int>(val.size());
}

int64_t ts_add(int fd, const char* key, int64_t delta) {
  uint8_t cmd = static_cast<uint8_t>(Cmd::ADD);
  if (!send_all(fd, &cmd, 1) || !send_bytes(fd, key) ||
      !send_all(fd, &delta, 8))
    return INT64_MIN;
  int64_t result;
  if (!recv_all(fd, &result, 8)) return INT64_MIN;
  return result;
}

int ts_delete(int fd, const char* key) {
  uint8_t cmd = static_cast<uint8_t>(Cmd::DEL);
  if (!send_all(fd, &cmd, 1) || !send_bytes(fd, key)) return -1;
  std::string resp;
  return recv_bytes(fd, &resp) ? 0 : -1;
}

void ts_close(int fd) { ::close(fd); }

}  // extern "C"
