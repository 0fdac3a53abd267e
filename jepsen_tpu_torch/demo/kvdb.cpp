// kvdb: a deliberately small networked key-value store used as the
// framework's demo "system under test" — the role zookeeper plays for
// the reference's canonical suite (zookeeper/src/jepsen/zookeeper.clj).
//
// Protocol (one request per line, '\n'-terminated):
//   SET <k> <v>          -> OK
//   GET <k>              -> VAL <v> | NIL
//   CAS <k> <old> <new>  -> OK | FAIL | NIL
//   ADD <k> <v>          -> OK            (grow-only set per key)
//   MEMBERS <k>          -> VAL <v1,v2,...> | NIL
//   PING                 -> PONG
//
// Durability: every mutation appends to an op log.  With --fsync each
// append is fdatasync'd before the client sees OK; without it,
// acknowledged writes can vanish on kill -9 — a real consistency bug
// the set workload detects end-to-end.
//
// Single process, thread-per-connection, one global mutex: the store
// itself is linearizable by construction, so any anomaly the checker
// reports was injected by the harness (kills, partitions), not the db.

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdio>
#include <cstdlib>
#include <map>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

std::mutex g_mu;
std::map<std::string, std::string> g_kv;
std::map<std::string, std::set<std::string>> g_sets;
int g_log_fd = -1;
bool g_fsync = false;
size_t g_buffer_cap = 0;   // --buffer N: userspace buffering (bug mode)
std::string g_log_buf;

void flush_log() {
  if (g_log_fd < 0 || g_log_buf.empty()) return;
  ssize_t off = 0;
  while (off < (ssize_t)g_log_buf.size()) {
    ssize_t n =
        write(g_log_fd, g_log_buf.data() + off, g_log_buf.size() - off);
    if (n <= 0) return;
    off += n;
  }
  g_log_buf.clear();
  if (g_fsync) fdatasync(g_log_fd);
}

void log_op(const std::string &line) {
  if (g_log_fd < 0) return;
  g_log_buf += line;
  g_log_buf += '\n';
  // With --buffer, acknowledged mutations sit in THIS PROCESS's memory
  // until the buffer fills — kill -9 loses them.  That's the bug the
  // set workload catches.  Without it, every op hits the kernel first.
  if (g_buffer_cap == 0 || g_log_buf.size() >= g_buffer_cap) flush_log();
}

void replay(const std::string &path) {
  FILE *f = fopen(path.c_str(), "r");
  if (!f) return;
  char buf[1 << 16];
  while (fgets(buf, sizeof buf, f)) {
    std::istringstream in(buf);
    std::string op, k, v;
    in >> op >> k >> v;
    if (op == "SET")
      g_kv[k] = v;
    else if (op == "ADD")
      g_sets[k].insert(v);
  }
  fclose(f);
}

std::string handle(const std::string &line) {
  std::istringstream in(line);
  std::string op;
  in >> op;
  std::lock_guard<std::mutex> lock(g_mu);
  if (op == "PING") return "PONG";
  if (op == "SET") {
    std::string k, v;
    in >> k >> v;
    if (k.empty()) return "ERR usage";
    log_op("SET " + k + " " + v);
    g_kv[k] = v;
    return "OK";
  }
  if (op == "GET") {
    std::string k;
    in >> k;
    auto it = g_kv.find(k);
    return it == g_kv.end() ? "NIL" : "VAL " + it->second;
  }
  if (op == "CAS") {
    std::string k, oldv, newv;
    in >> k >> oldv >> newv;
    auto it = g_kv.find(k);
    if (it == g_kv.end()) return "NIL";
    if (it->second != oldv) return "FAIL";
    log_op("SET " + k + " " + newv);
    it->second = newv;
    return "OK";
  }
  if (op == "ADD") {
    std::string k, v;
    in >> k >> v;
    log_op("ADD " + k + " " + v);
    g_sets[k].insert(v);
    return "OK";
  }
  if (op == "INCR") {
    // Atomic add under the global mutex: the counter workload's
    // CONTROL op.  (Its conviction arm never calls this — clients do
    // GET + SET round trips whose interleavings lose updates.)
    std::string k, d;
    in >> k >> d;
    if (k.empty() || d.empty()) return "ERR usage";
    long long cur = 0;
    auto it = g_kv.find(k);
    if (it != g_kv.end()) cur = atoll(it->second.c_str());
    long long next = cur + atoll(d.c_str());
    std::string nv = std::to_string(next);
    log_op("SET " + k + " " + nv);
    g_kv[k] = nv;
    return "VAL " + nv;
  }
  if (op == "MEMBERS") {
    std::string k;
    in >> k;
    auto it = g_sets.find(k);
    if (it == g_sets.end()) return "NIL";
    std::string out = "VAL ";
    bool first = true;
    for (const auto &v : it->second) {
      if (!first) out += ",";
      out += v;
      first = false;
    }
    return out;
  }
  return "ERR unknown op";
}

void serve_conn(int fd) {
  std::string buf;
  char chunk[4096];
  for (;;) {
    ssize_t n = read(fd, chunk, sizeof chunk);
    if (n <= 0) break;
    buf.append(chunk, n);
    size_t pos;
    while ((pos = buf.find('\n')) != std::string::npos) {
      std::string line = buf.substr(0, pos);
      buf.erase(0, pos + 1);
      if (!line.empty() && line.back() == '\r') line.pop_back();
      std::string resp = handle(line) + "\n";
      ssize_t off = 0;
      while (off < (ssize_t)resp.size()) {
        ssize_t w = write(fd, resp.data() + off, resp.size() - off);
        if (w <= 0) goto done;
        off += w;
      }
    }
  }
done:
  close(fd);
}

}  // namespace

int main(int argc, char **argv) {
  int port = 7400;
  std::string data;
  std::string listen_addr = "127.0.0.1";
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    if (a == "--port" && i + 1 < argc)
      port = atoi(argv[++i]);
    else if (a == "--listen" && i + 1 < argc)
      listen_addr = argv[++i];
    else if (a == "--data" && i + 1 < argc)
      data = argv[++i];
    else if (a == "--fsync")
      g_fsync = true;
    else if (a == "--buffer" && i + 1 < argc)
      g_buffer_cap = (size_t)atoll(argv[++i]);
  }
  signal(SIGPIPE, SIG_IGN);
  if (!data.empty()) {
    replay(data);
    g_log_fd = open(data.c_str(), O_WRONLY | O_APPEND | O_CREAT, 0644);
    if (g_log_fd < 0) {
      perror("open data log");
      return 1;
    }
  }

  int srv = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  if (inet_pton(AF_INET, listen_addr.c_str(), &addr.sin_addr) != 1) {
    fprintf(stderr, "bad --listen address %s\n", listen_addr.c_str());
    return 2;
  }
  addr.sin_port = htons(port);
  if (bind(srv, (sockaddr *)&addr, sizeof addr) != 0) {
    perror("bind");
    return 1;
  }
  if (listen(srv, 128) != 0) {
    perror("listen");
    return 1;
  }
  fprintf(stderr, "kvdb listening on %s:%d (fsync=%d data=%s)\n",
          listen_addr.c_str(), port, (int)g_fsync, data.c_str());
  for (;;) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    std::thread(serve_conn, fd).detach();
  }
}
