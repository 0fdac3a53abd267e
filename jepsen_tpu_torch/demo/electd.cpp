// electd: a deliberately small LEADER-ELECTED register store — the
// framework's split-brain demo system.  N processes heartbeat each
// other; each node believes it is the leader iff it has heard no live
// peer with a LOWER id recently (bully-style, no terms, no fencing —
// that absence is the point).  Clients find a node claiming LEADER and
// do register ops there.
//
// The physics (default, "unsafe" mode): a partition that separates the
// lowest-id node from the rest makes BOTH sides elect a leader — the
// low side keeps its leader, the high side stops hearing it and
// promotes itself.  Both leaders accept and acknowledge writes.  On
// heal, the higher-id leader notices the lower one, steps down, and
// adopts the survivor's state WHOLESALE (a DUMP pull) — every write it
// acknowledged during the split is silently discarded.  Acked-then-
// lost updates and resurrected stale values are exactly what the
// linearizability checker (checker/linearizable.py, the knossos
// equivalent — checker.clj:202-233) must convict; the famous
// split-brain findings of the reference's published analyses are this
// shape.
//
// The control group (--quorum): leadership is ignored and every op is
// an ABD majority round (Attiya-Bar-Noy-Dolev): reads and writes each
// do a timestamp query phase and a store phase against a majority of
// nodes, with (ts, writer-id) lexicographic ordering.  ABD's atomic
// register is linearizable by construction, so the SAME partitions
// convict unsafe mode and leave quorum mode valid.  (ABD covers
// read/write registers only — CAS needs consensus, which electd
// deliberately does not have; the suite's quorum workload is rw-only.)
//
// Second experiment (crash amnesia): ABD assumes replicas remember
// their (ts, wid, val) across failures.  Without --wal the store and
// the timestamp clock are process memory, so kill -9 + restart
// reboots a replica EMPTY — a later majority can miss an acked write
// entirely (and a reused timestamp can diverge replicas).  That is
// the reference's canonical volatile-quorum finding.  --wal <path>
// appends every accepted (k, ts, wid, val) to a fsync'd log replayed
// at boot (clock floor included), closing the amnesia hole; the suite
// runs the same kill schedule volatile (convicted) and durable
// (valid).  The WAL is quorum-mode durability: unsafe mode's
// wholesale state adoption deliberately discards entries, which an
// append-only replay cannot represent.
//
// Client protocol (one request per line):
//   GET <k>               -> VAL <v> | NIL | ERR notleader|noquorum
//   SET <k> <v>           -> OK | ERR notleader|noquorum
//   CAS <k> <old> <new>   -> OK | FAIL | NIL | ERR notleader (unsafe only)
//   ROLE                  -> LEADER | FOLLOWER | QUORUM
//   PING                  -> PONG
//   CLOCK                 -> CLOCK <abd_clock>   (admin observability)
//   DUMP <from>           -> STATE <k>=<ts>:<wid>:<v>,...   (step-down pull)
//   BLOCK <id> / UNBLOCK <id>|* -> OK   (app-level partition injection,
//                                        the suite's Net implementation)
// Peer protocol (same port; silently dropped while the sender is
// blocked, like a partitioned packet):
//   HB <from>                      -> HBACK
//   QREAD <from> <k>               -> QVAL <ts> <wid> <v|__nil__>
//   QSTORE <from> <k> <ts> <wid> <v> -> QACK
//
// Fresh implementation for this framework's demo suite.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
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

using Clock = std::chrono::steady_clock;

struct Entry {
  long long ts = 0;
  int wid = 0;
  std::string val;
};

struct PeerAddr {
  int id;
  std::string host;
  int port;
};

int g_id = 0;
bool g_quorum = false;
int g_stale_ms = 500;    // lower peer unheard this long => it's dead
int g_peer_timeout_ms = 100;  // per-peer connect/read budget
std::mutex g_mu;
std::map<std::string, Entry> g_kv;
long long g_abd_clock = 0;  // node-local monotonic ABD timestamp floor
FILE* g_wal = nullptr;      // quorum-mode durability; null = volatile
std::mutex g_wal_mu;        // append order; never held with g_mu
std::set<int> g_blocked;
std::map<int, Clock::time_point> g_last_heard;
bool g_leader = false;
std::vector<PeerAddr> g_peers;

bool blocked(int id) {
  std::lock_guard<std::mutex> l(g_mu);
  return g_blocked.count(id) > 0;
}

// One short-lived request/response round trip to a peer.  Returns ""
// on any failure (unreachable, blocked receiver swallowing the line,
// timeout) — the caller treats that as a dead peer / dropped packet.
std::string peer_rpc(const PeerAddr& p, const std::string& line) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return "";
  timeval tv{};
  tv.tv_sec = 0;
  tv.tv_usec = g_peer_timeout_ms * 1000;
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  sockaddr_in a{};
  a.sin_family = AF_INET;
  a.sin_port = htons(p.port);
  inet_pton(AF_INET, p.host.c_str(), &a.sin_addr);
  if (connect(fd, (sockaddr*)&a, sizeof(a)) != 0) {
    close(fd);
    return "";
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  if (write(fd, line.data(), line.size()) != (ssize_t)line.size()) {
    close(fd);
    return "";
  }
  // Responses are one newline-terminated line; a DUMP reply can span
  // TCP segments, so read until the newline (or timeout/EOF) — a
  // truncated STATE would make adopt_state install a partial store.
  std::string resp;
  char buf[4096];
  while (resp.find('\n') == std::string::npos) {
    ssize_t n = read(fd, buf, sizeof(buf));
    if (n <= 0) break;
    resp.append(buf, n);
  }
  close(fd);
  if (resp.find('\n') == std::string::npos) return "";
  resp.resize(resp.find('\n'));
  while (!resp.empty() && resp.back() == '\r') resp.pop_back();
  return resp;
}

// Serialize the whole store (step-down adoption + DUMP).  Values are
// the workload's integers, so the ,=: framing never collides.
std::string state_str() {
  std::lock_guard<std::mutex> l(g_mu);
  std::ostringstream out;
  bool first = true;
  for (auto& e : g_kv) {
    if (!first) out << ",";
    out << e.first << "=" << e.second.ts << ":" << e.second.wid << ":"
        << e.second.val;
    first = false;
  }
  return out.str();
}

void adopt_state(const std::string& s) {
  std::map<std::string, Entry> kv;
  std::stringstream ss(s);
  std::string item;
  while (std::getline(ss, item, ',')) {
    if (item.empty()) continue;
    auto eq = item.find('=');
    auto c1 = item.find(':', eq);
    auto c2 = item.find(':', c1 + 1);
    Entry e;
    e.ts = atoll(item.substr(eq + 1, c1 - eq - 1).c_str());
    e.wid = atoi(item.substr(c1 + 1, c2 - c1 - 1).c_str());
    e.val = item.substr(c2 + 1);
    kv[item.substr(0, eq)] = e;
  }
  std::lock_guard<std::mutex> l(g_mu);
  // WHOLESALE replacement, not a merge: everything this node accepted
  // while it wrongly led is discarded — the lost-update bug under test.
  g_kv.swap(kv);
}

// Heartbeat + leadership thread.  Every 50 ms: beat every unblocked
// peer; then re-evaluate leadership.  A leader that sees a live
// lower-id peer steps down and adopts that peer's state.
void election_loop() {
  while (true) {
    for (auto& p : g_peers) {
      if (blocked(p.id)) continue;
      std::string resp =
          peer_rpc(p, "HB " + std::to_string(g_id) + "\n");
      if (resp == "HBACK") {
        std::lock_guard<std::mutex> l(g_mu);
        g_last_heard[p.id] = Clock::now();
      }
    }
    if (!g_quorum) {
      int lower_live = -1;
      bool was_leader;
      {
        std::lock_guard<std::mutex> l(g_mu);
        was_leader = g_leader;
        auto now = Clock::now();
        for (auto& p : g_peers) {
          if (p.id >= g_id) continue;
          auto it = g_last_heard.find(p.id);
          if (it != g_last_heard.end() &&
              now - it->second <
                  std::chrono::milliseconds(g_stale_ms)) {
            lower_live = p.id;
            break;
          }
        }
        g_leader = lower_live < 0;
      }
      if (was_leader && lower_live >= 0) {
        // Stepping down on heal: pull the surviving leader's state.
        // The distress line below is the log-file-pattern checker's
        // quarry (checker.clj:863-905's role: server-side events the
        // history can't see) — wholesale adoption is precisely the
        // moment this node's split-brain acks become lies.
        size_t local;
        {
          std::lock_guard<std::mutex> l(g_mu);
          local = g_kv.size();
        }
        if (local > 0) {
          // Gated on actually holding data: distress requires
          // something to lose.  (Boot self-election is already
          // prevented by main()'s heartbeat grace priming; what this
          // gate suppresses is the data-LESS step-down — a follower
          // that briefly self-elected during a heartbeat hiccup or a
          // partition in which it never acked a write.  Cost: a
          // split-brain loser that only served reads steps down
          // silently, so the log evidence is strictly a subset of
          // the history evidence — the checker pair in
          // suites/electd.py treats it as corroboration, not as the
          // primary verdict.)
          fprintf(stderr,
                  "electd id=%d STEPPING DOWN to leader %d: adopting "
                  "remote state wholesale (replacing %zu local "
                  "entries)\n",
                  g_id, lower_live, local);
          fflush(stderr);
        }
        for (auto& p : g_peers) {
          if (p.id != lower_live) continue;
          std::string resp =
              peer_rpc(p, "DUMP " + std::to_string(g_id) + "\n");
          if (resp.rfind("STATE", 0) == 0)
            adopt_state(resp.size() > 6 ? resp.substr(6) : "");
        }
      }
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
}

int majority() { return ((int)g_peers.size() + 1) / 2 + 1; }

// ABD phase 1: collect (ts, wid, val) from self + a majority.
// Returns false when too few nodes answered.
bool quorum_read(const std::string& k, Entry* out) {
  Entry best;
  {
    std::lock_guard<std::mutex> l(g_mu);
    auto it = g_kv.find(k);
    if (it != g_kv.end()) best = it->second;
  }
  int heard = 1;  // self
  for (auto& p : g_peers) {
    if (blocked(p.id)) continue;
    std::string resp = peer_rpc(
        p, "QREAD " + std::to_string(g_id) + " " + k + "\n");
    long long ts;
    int wid;
    char val[3900];
    if (sscanf(resp.c_str(), "QVAL %lld %d %3899s", &ts, &wid, val) ==
        3) {
      heard++;
      if (ts > best.ts || (ts == best.ts && wid > best.wid)) {
        best.ts = ts;
        best.wid = wid;
        best.val = strcmp(val, "__nil__") == 0 ? "" : val;
      }
    }
  }
  if (heard < majority()) return false;
  *out = best;
  return true;
}

// Appends one record durably.  Fail-stop on any I/O error: a node
// that cannot log must not ack (or serve) — dying here turns ENOSPC
// into a dead node, which the suite's fault model already covers,
// instead of into silently-volatile "durable" mode.
void wal_append(const std::string& k, long long ts, int wid,
                const std::string& v) {
  std::lock_guard<std::mutex> l(g_wal_mu);
  if (fprintf(g_wal, "%s %lld %d %s\n", k.c_str(), ts, wid,
              v.c_str()) < 0 ||
      fflush(g_wal) != 0 || fsync(fileno(g_wal)) != 0) {
    perror("electd: wal append failed, stopping");
    _exit(1);
  }
}

void local_store(const std::string& k, long long ts, int wid,
                 const std::string& v) {
  {
    std::lock_guard<std::mutex> l(g_mu);
    Entry& e = g_kv[k];
    if (ts < e.ts || (ts == e.ts && wid <= e.wid)) return;
  }
  // Durable BEFORE visible (and before the QACK/OK leaves this node):
  // once the entry is in g_kv another op can read it and ack the
  // value onward, so crashing after visibility but before the append
  // would lose an observed write even in durable mode.  The fsync
  // happens outside g_mu so a slow disk stalls only writers, not
  // reads/heartbeats.  A newer entry racing in between the append and
  // the apply just makes this record a no-op on disk and in memory —
  // replay applies with the same (ts, wid) precedence.
  if (g_wal) wal_append(k, ts, wid, v);
  std::lock_guard<std::mutex> l(g_mu);
  Entry& e = g_kv[k];
  if (ts > e.ts || (ts == e.ts && wid > e.wid)) {
    e.ts = ts;
    e.wid = wid;
    e.val = v;
  }
  if (ts > g_abd_clock) g_abd_clock = ts;
}

// Boot-time WAL replay: re-applies entries with local_store's own
// precedence (last state wins per key) and restores the clock floor
// so a restarted writer can never reuse a pre-crash timestamp.
// A kill can tear the final record (it was never fsync-acked, so
// dropping it is correct); the file is then TRUNCATED at the tear so
// the next append starts on a clean line boundary — otherwise a
// second incarnation's entries would glue onto the torn tail and a
// later replay would stop there, forgetting acked writes.
void wal_replay(const std::string& path) {
  FILE* f = fopen(path.c_str(), "r");
  if (!f) return;  // first boot: nothing yet
  char line[4600];
  char k[256], v[3900];
  long long ts;
  int wid;
  int applied = 0;
  long good_end = 0;
  while (fgets(line, sizeof(line), f)) {
    size_t n = strlen(line);
    if (n == 0 || line[n - 1] != '\n' ||
        sscanf(line, "%255s %lld %d %3899s", k, &ts, &wid, v) != 4)
      break;  // torn tail: everything before it was fsync'd whole
    good_end = ftell(f);
    std::lock_guard<std::mutex> l(g_mu);
    Entry& e = g_kv[k];
    if (ts > e.ts || (ts == e.ts && wid > e.wid)) {
      e.ts = ts;
      e.wid = wid;
      e.val = v;
    }
    if (ts > g_abd_clock) g_abd_clock = ts;
    applied++;
  }
  fclose(f);
  if (truncate(path.c_str(), good_end) != 0) {
    perror("electd: wal truncate failed, stopping");
    _exit(1);
  }
  fprintf(stderr, "electd id=%d wal replay: %d entries, clock %lld\n",
          g_id, applied, g_abd_clock);
}

// ABD phase 2: store (ts, wid, v) on self + a majority.
bool quorum_store(const std::string& k, long long ts, int wid,
                  const std::string& v) {
  local_store(k, ts, wid, v);
  int acked = 1;  // self
  for (auto& p : g_peers) {
    if (blocked(p.id)) continue;
    std::ostringstream req;
    req << "QSTORE " << g_id << " " << k << " " << ts << " " << wid
        << " " << v << "\n";
    if (peer_rpc(p, req.str()) == "QACK") acked++;
  }
  return acked >= majority();
}

void serve(int fd) {
  FILE* rf = fdopen(fd, "r");
  if (!rf) {
    close(fd);
    return;
  }
  char buf[4096];
  while (fgets(buf, sizeof(buf), rf)) {
    std::istringstream in(buf);
    std::string cmd;
    in >> cmd;
    std::string resp;
    if (cmd == "PING") {
      resp = "PONG";
    } else if (cmd == "ROLE") {
      if (g_quorum) {
        resp = "QUORUM";
      } else {
        std::lock_guard<std::mutex> l(g_mu);
        resp = g_leader ? "LEADER" : "FOLLOWER";
      }
    } else if (cmd == "HB") {
      int from;
      in >> from;
      if (blocked(from)) continue;  // partitioned: swallow, no reply
      {
        // Hearing a beat proves the sender alive — symmetric evidence
        // to getting our own beat acked.
        std::lock_guard<std::mutex> l(g_mu);
        g_last_heard[from] = Clock::now();
      }
      resp = "HBACK";
    } else if (cmd == "QREAD") {
      int from;
      std::string k;
      in >> from >> k;
      if (blocked(from)) continue;
      std::lock_guard<std::mutex> l(g_mu);
      auto it = g_kv.find(k);
      if (it == g_kv.end()) {
        resp = "QVAL 0 0 __nil__";
      } else {
        resp = "QVAL " + std::to_string(it->second.ts) + " " +
               std::to_string(it->second.wid) + " " +
               (it->second.val.empty() ? "__nil__" : it->second.val);
      }
    } else if (cmd == "QSTORE") {
      int from, wid;
      long long ts;
      std::string k, v;
      in >> from >> k >> ts >> wid >> v;
      if (blocked(from)) continue;
      local_store(k, ts, wid, v);
      resp = "QACK";
    } else if (cmd == "DUMP") {
      int from;
      in >> from;
      if (blocked(from)) continue;
      resp = "STATE " + state_str();
    } else if (cmd == "CLOCK") {
      // Admin observability: the ABD timestamp floor (replay must
      // restore it or a restarted writer can reuse pre-crash
      // timestamps and diverge replicas).
      std::lock_guard<std::mutex> l(g_mu);
      resp = "CLOCK " + std::to_string(g_abd_clock);
    } else if (cmd == "GET") {
      std::string k;
      in >> k;
      if (g_quorum) {
        Entry e;
        if (!quorum_read(k, &e)) {
          resp = "ERR noquorum";
        } else if (e.ts == 0) {
          resp = "NIL";
        } else if (!quorum_store(k, e.ts, e.wid, e.val)) {
          // Write-back failed: the read's value is not yet stable at
          // a majority, so exposing it would break atomicity.
          resp = "ERR noquorum";
        } else {
          resp = "VAL " + e.val;
        }
      } else {
        std::lock_guard<std::mutex> l(g_mu);
        if (!g_leader) {
          resp = "ERR notleader";
        } else {
          auto it = g_kv.find(k);
          resp = it == g_kv.end() || it->second.ts == 0
                     ? "NIL"
                     : ("VAL " + it->second.val);
        }
      }
    } else if (cmd == "SET") {
      std::string k, v;
      in >> k >> v;
      if (g_quorum) {
        Entry e;
        if (!quorum_read(k, &e)) {
          resp = "ERR noquorum";
        } else {
          // The new (ts, wid) pair must be UNIQUE per write: two
          // concurrent SETs through this same node share g_id, so a
          // plain e.ts + 1 would collide and leave replicas holding
          // different values under one timestamp (arrival order
          // would then decide each replica's winner — divergence).
          // A node-local monotonic clock merged with the read-phase
          // max keeps same-node writes distinct; wid breaks
          // cross-node ties.
          long long ts_new;
          {
            std::lock_guard<std::mutex> l(g_mu);
            ts_new = (e.ts > g_abd_clock ? e.ts : g_abd_clock) + 1;
            g_abd_clock = ts_new;
          }
          resp = quorum_store(k, ts_new, g_id, v) ? "OK"
                                                  : "ERR noquorum";
        }
      } else {
        std::lock_guard<std::mutex> l(g_mu);
        if (!g_leader) {
          resp = "ERR notleader";
        } else {
          Entry& e = g_kv[k];
          e.ts++;
          e.wid = g_id;
          e.val = v;
          resp = "OK";
        }
      }
    } else if (cmd == "CAS") {
      std::string k, oldv, newv;
      in >> k >> oldv >> newv;
      if (g_quorum) {
        // ABD has no conditional write: CAS requires consensus, which
        // electd does not implement.  The quorum workload is rw-only.
        resp = "ERR nocas";
      } else {
        std::lock_guard<std::mutex> l(g_mu);
        if (!g_leader) {
          resp = "ERR notleader";
        } else {
          auto it = g_kv.find(k);
          if (it == g_kv.end() || it->second.ts == 0) {
            resp = "NIL";
          } else if (it->second.val != oldv) {
            resp = "FAIL";
          } else {
            it->second.ts++;
            it->second.wid = g_id;
            it->second.val = newv;
            resp = "OK";
          }
        }
      }
    } else if (cmd == "BLOCK") {
      int id;
      in >> id;
      std::lock_guard<std::mutex> l(g_mu);
      g_blocked.insert(id);
      resp = "OK";
    } else if (cmd == "UNBLOCK") {
      std::string id;
      in >> id;
      std::lock_guard<std::mutex> l(g_mu);
      if (id == "*") g_blocked.clear();
      else g_blocked.erase(atoi(id.c_str()));
      resp = "OK";
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
  int port = 7400;
  std::string listen_addr = "127.0.0.1";
  std::string wal_path;
  std::string peers;  // "id@host:port,id@host:port"
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    auto next = [&]() { return std::string(argv[++i]); };
    if (a == "--port") port = atoi(next().c_str());
    else if (a == "--listen") listen_addr = next();
    else if (a == "--id") g_id = atoi(next().c_str());
    else if (a == "--peers") peers = next();
    else if (a == "--quorum") g_quorum = true;
    else if (a == "--wal") wal_path = next();
    else if (a == "--stale-ms") g_stale_ms = atoi(next().c_str());
    else if (a == "--peer-timeout-ms")
      g_peer_timeout_ms = atoi(next().c_str());
  }
  signal(SIGPIPE, SIG_IGN);

  if (!wal_path.empty()) {
    wal_replay(wal_path);
    g_wal = fopen(wal_path.c_str(), "a");
    if (!g_wal) {
      perror("wal");
      return 1;
    }
  }

  std::stringstream ps(peers);
  std::string item;
  while (std::getline(ps, item, ',')) {
    if (item.empty()) continue;
    auto at = item.find('@');
    auto colon = item.rfind(':');
    PeerAddr p;
    p.id = atoi(item.substr(0, at).c_str());
    p.host = item.substr(at + 1, colon - at - 1);
    p.port = atoi(item.substr(colon + 1).c_str());
    g_peers.push_back(p);
  }
  {
    // Boot grace: treat every lower peer as alive until proven dead,
    // so a follower doesn't claim leadership in the first beat gap.
    std::lock_guard<std::mutex> l(g_mu);
    auto now = Clock::now();
    for (auto& p : g_peers) g_last_heard[p.id] = now;
    g_leader = !g_quorum;
    for (auto& p : g_peers)
      if (p.id < g_id) g_leader = false;
  }
  std::thread(election_loop).detach();

  int srv = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  inet_pton(AF_INET, listen_addr.c_str(), &addr.sin_addr);
  if (bind(srv, (sockaddr*)&addr, sizeof(addr)) != 0) {
    perror("bind");
    return 1;
  }
  listen(srv, 64);
  fprintf(stderr, "electd id=%d on %s:%d (%s)\n", g_id,
          listen_addr.c_str(), port, g_quorum ? "quorum" : "unsafe");
  while (true) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    int nd = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &nd, sizeof(nd));
    std::thread(serve, fd).detach();
  }
}
