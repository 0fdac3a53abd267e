// logd: a deliberately small append-only partitioned log — the
// "kafka-shaped" demo system driven by workloads/kafka.py, playing the
// role real Kafka plays for the reference's hardest checker
// (jepsen/src/jepsen/tests/kafka.clj:24-180 built its workload against
// real brokers; this server gives that checker REAL anomalies to find
// instead of injected ones).
//
// Partitions are named keys; producers SEND values which get
// monotonically-increasing offsets; consumers POLL from a position
// they track themselves (Kafka consumer semantics); COMMIT appends a
// transaction marker that burns one offset per touched partition the
// way Kafka's commit markers do — so polls legitimately see offset
// gaps.
//
// Client protocol (one request per line):
//   SEND <k> <v>             -> OFF <offset>
//   POLL <k> <pos> <limit>   -> MSGS <next_pos> [<off>:<v> ...]
//   DEQ <k> <limit>          -> DEQD [<v> ...] | EMPTY
//   COMMIT <k1,k2,...>       -> OK
//   PING                     -> PONG
//
// DEQ is the queue face of the log: a SERVER-side shared cursor per
// key (one consumer group) hands each record to exactly one caller.
// The cursor lives in process memory only, deliberately: a restart
// rewinds it to zero and redelivers — classic at-least-once, which
// the total-queue checker reports as duplicates but does NOT convict.
// What it does convict is records that can never come out at all:
// in write-behind mode a SIGKILL drops acked-but-unflushed SENDs from
// the WAL, and no amount of redelivery brings those back.
//
// The interesting physics — why kills produce checker-visible
// anomalies: SEND acknowledges from memory, and a flusher thread
// write()s the tail to <dir>/wal.log every --flush-ms (default 50).
// SIGKILL inside that window loses acknowledged records; on restart
// the log reloads from the WAL, so the next SEND REUSES the lost
// offsets — the checker then finds lost writes (acked values nobody
// can ever poll) and inconsistent offsets (two values observed at one
// (key, offset)).  --sync flushes inline before acking: the control
// group, which survives kills cleanly.
//
// Fresh implementation for this framework's demo suite (the kvdb/repkv
// mold, demo/kvdb/kvdb.cpp).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <fstream>
#include <map>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

std::mutex g_mu;
// Value "" is a transaction marker / burned offset: it occupies an
// offset but is never delivered to polls.
std::map<std::string, std::vector<std::string>> g_logs;
// Shared consumer-group cursors for DEQ — in-memory only (see header
// comment: rewind-on-restart is the at-least-once demo physics).
std::map<std::string, size_t> g_cursors;
std::deque<std::string> g_pending;  // WAL lines not yet written
std::condition_variable g_flush_cv;
bool g_sync = false;
int g_flush_ms = 50;
std::string g_wal_path;

// Drains pending WAL lines to disk.  fflush moves them to the page
// cache: enough to survive a SIGKILL of this process (the fault the
// suite injects), deliberately not an fsync (machine crashes are out
// of scope for the demo).
void flush_pending_locked(FILE* wal) {
  while (!g_pending.empty()) {
    fputs(g_pending.front().c_str(), wal);
    g_pending.pop_front();
  }
  fflush(wal);
}

void flusher_loop(FILE* wal) {
  std::unique_lock<std::mutex> l(g_mu);
  while (true) {
    g_flush_cv.wait_for(l, std::chrono::milliseconds(g_flush_ms));
    flush_pending_locked(wal);
  }
}

FILE* g_wal = nullptr;

void reload() {
  std::ifstream in(g_wal_path);
  std::string line;
  while (std::getline(in, line)) {
    if (line.size() < 2) continue;
    std::istringstream is(line);
    std::string tag, k, v;
    is >> tag >> k;
    if (tag == "D") {
      std::getline(is, v);
      if (!v.empty() && v[0] == ' ') v.erase(0, 1);
      g_logs[k].push_back(v);
    } else if (tag == "M") {
      g_logs[k].push_back("");
    }
  }
}

void serve(int fd) {
  FILE* rf = fdopen(fd, "r");
  if (!rf) { close(fd); return; }
  char buf[4096];
  while (fgets(buf, sizeof(buf), rf)) {
    std::istringstream in(buf);
    std::string cmd;
    in >> cmd;
    std::string resp;
    if (cmd == "PING") {
      resp = "PONG";
    } else if (cmd == "SEND") {
      std::string k, v;
      in >> k >> v;
      std::lock_guard<std::mutex> l(g_mu);
      auto& log = g_logs[k];
      size_t off = log.size();
      log.push_back(v);
      g_pending.push_back("D " + k + " " + v + "\n");
      // async mode: the TIMER alone flushes — waking the flusher per
      // send would close the durability window this demo exists for.
      if (g_sync) flush_pending_locked(g_wal);
      resp = "OFF " + std::to_string(off);
    } else if (cmd == "COMMIT") {
      std::string ks;
      in >> ks;
      std::lock_guard<std::mutex> l(g_mu);
      std::stringstream s(ks);
      std::string k;
      while (std::getline(s, k, ',')) {
        if (k.empty()) continue;
        g_logs[k].push_back("");
        g_pending.push_back("M " + k + "\n");
      }
      if (g_sync) flush_pending_locked(g_wal);
      resp = "OK";
    } else if (cmd == "DEQ") {
      std::string k;
      size_t limit = 1;
      in >> k >> limit;
      if (limit == 0) limit = 1;
      std::lock_guard<std::mutex> l(g_mu);
      auto& log = g_logs[k];
      size_t& cur = g_cursors[k];
      std::ostringstream out;
      size_t n = 0;
      while (cur < log.size() && n < limit) {
        if (!log[cur].empty()) {  // markers burn offsets, not values
          out << " " << log[cur];
          n++;
        }
        cur++;
      }
      resp = n ? "DEQD" + out.str() : "EMPTY";
    } else if (cmd == "POLL") {
      std::string k;
      size_t pos = 0, limit = 32;
      in >> k >> pos >> limit;
      std::lock_guard<std::mutex> l(g_mu);
      auto& log = g_logs[k];
      std::ostringstream out;
      size_t n = 0;
      while (pos < log.size() && n < limit) {
        if (!log[pos].empty()) {
          out << " " << pos << ":" << log[pos];
          n++;
        }
        pos++;
      }
      resp = "MSGS " + std::to_string(pos) + out.str();
    } else {
      resp = "ERR badcmd";
    }
    resp += "\n";
    if (write(fd, resp.data(), resp.size()) != (ssize_t)resp.size())
      break;
  }
  fclose(rf);
}

}  // namespace

int main(int argc, char** argv) {
  int port = 7500;
  std::string dir = "/tmp/logd";
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    auto next = [&]() { return std::string(argv[++i]); };
    if (a == "--port") port = atoi(next().c_str());
    else if (a == "--dir") dir = next();
    else if (a == "--flush-ms") g_flush_ms = atoi(next().c_str());
    else if (a == "--sync") g_sync = true;
  }
  signal(SIGPIPE, SIG_IGN);
  mkdir(dir.c_str(), 0755);
  g_wal_path = dir + "/wal.log";
  reload();
  g_wal = fopen(g_wal_path.c_str(), "a");
  if (!g_wal) { perror("wal"); return 1; }
  if (!g_sync) std::thread(flusher_loop, g_wal).detach();

  int srv = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
  if (bind(srv, (sockaddr*)&addr, sizeof(addr)) != 0) {
    perror("bind");
    return 1;
  }
  listen(srv, 64);
  size_t keys = 0, records = 0;
  for (auto& e : g_logs) { keys++; records += e.second.size(); }
  fprintf(stderr, "logd on 127.0.0.1:%d dir=%s (%s, flush %dms) "
          "reloaded %zu keys / %zu records\n",
          port, dir.c_str(), g_sync ? "sync" : "async", g_flush_ms,
          keys, records);
  while (true) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    int nd = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &nd, sizeof(nd));
    std::thread(serve, fd).detach();
  }
}
