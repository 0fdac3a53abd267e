// repkv: a deliberately small REPLICATED key-value store — the
// framework's multi-node demo system, playing the role a real
// replicated database (etcd/zookeeper) plays for the reference's
// suites.  N processes form a primary/backup group: the primary
// accepts writes and streams them to backups; any node serves reads.
//
// Replication is primary -> backup over persistent TCP connections.
// In the default (async) mode the primary acknowledges writes without
// waiting for backups; with --sync it waits for every *reachable*
// backup's ack, but silently degrades to async for peers that time
// out — exactly the kind of "mostly synchronous" replication that
// looks linearizable until a partition makes backup reads stale.
// Split-brain is reachable too: PROMOTE turns a backup into a second
// primary.  The checker, not the server, is supposed to catch all of
// this.
//
// Client protocol (one request per line):
//   GET <k>              -> VAL <v> | NIL
//   SET <k> <v>          -> OK | ERR notprimary
//   CAS <k> <old> <new>  -> OK | FAIL | NIL | ERR notprimary
//   PING                 -> PONG
//   ROLE                 -> PRIMARY | BACKUP
//   PROMOTE / DEMOTE     -> OK            (failover / fault injection)
//   BLOCK <id>           -> OK  (drop replication to/from peer <id> —
//   UNBLOCK <id> | *     -> OK   app-level partition injection, used
//                                by the suite's Net implementation)
// Membership (grow/shrink; the target of the membership nemesis,
// reference design nemesis/membership.clj:1-47):
//   VIEW                 -> VIEW <view_id> <id@host:port,...>
//   JOIN <id> <host:port>-> OK | ERR notprimary | ERR member
//   LEAVE <id>           -> OK | ERR notprimary | ERR nomember|self
// View changes are decided by the primary and PROPAGATE over the
// ordered replication stream (REPL ... VIEW lines), so backups learn
// with replication lag — and a node removed by LEAVE is deliberately
// never told: it keeps its stale view and keeps serving reads from
// data frozen at removal time.  That removed-but-unaware replica is
// the membership suite's checker-visible violation.
// Known limitation (deliberate — repkv is a fault playground, not a
// consensus system): views live only in memory.  A killed-and-
// restarted node reboots with its static --peers membership at view 1
// and, if it is the primary, its next view change is rejected by
// backups holding a higher view id (install_view ignores stale ids) —
// the suite's resolve_op abandons such ops rather than wedging.  Real
// systems persist membership in their log; repkv's whole point is to
// show what happens when pieces like that go missing.
// Peer protocol (on the same port):
//   REPL <from> <seq> SET <k> <v>   -> ACK <seq>   (unless blocked)
//   REPL <from> <seq> CAS ... same shape.
//   REPL <from> <seq> VIEW <view_id> <id@host:port,...> -> ACK <seq>.
//
// Fresh implementation for this framework's demo suite.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

int g_id = 0;
bool g_sync = false;
int g_ack_timeout_ms = 150;
std::mutex g_mu;
std::map<std::string, std::string> g_kv;
long long g_seq = 0;          // last locally applied sequence
bool g_primary = false;
std::set<int> g_blocked;      // peer ids we refuse to talk to
std::map<int, long long> g_applied_from;  // per-sender dedup watermark

struct Peer {
  int id;
  std::string host;
  int port;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::string> queue;   // REPL lines to ship
  long long acked = 0;
  bool stop = false;
};

std::vector<Peer*> g_peers;   // channels to current members (guarded
                              // by g_peers_mu; stopped peers stay in
                              // the vector with stop=true — never
                              // freed, so replicate() can't race a
                              // delete)
std::mutex g_peers_mu;
std::mutex g_ack_mu;
std::condition_variable g_ack_cv;

// Membership view: id -> "host:port" for every member INCLUDING self.
long long g_view_id = 1;
std::map<int, std::string> g_members;
std::string g_self_addr;

bool blocked(int id) {
  std::lock_guard<std::mutex> l(g_mu);
  return g_blocked.count(id) > 0;
}

// One writer thread per peer: connect, ship queued REPL lines, read
// ACKs.  Reconnects forever; drops the connection while blocked.
void peer_loop(Peer* p) {
  int fd = -1;
  FILE* rf = nullptr;
  std::string carry;
  while (true) {
    std::string line;
    {
      std::unique_lock<std::mutex> l(p->mu);
      p->cv.wait_for(l, std::chrono::milliseconds(100), [&] {
        return p->stop || !p->queue.empty();
      });
      if (p->stop) break;
      if (p->queue.empty()) continue;
      line = p->queue.front();
    }
    if (blocked(p->id)) {
      // Simulated partition: connection torn down, nothing shipped.
      if (fd >= 0) { fclose(rf); rf = nullptr; close(fd); fd = -1; }
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
      continue;
    }
    if (fd < 0) {
      fd = socket(AF_INET, SOCK_STREAM, 0);
      sockaddr_in a{};
      a.sin_family = AF_INET;
      a.sin_port = htons(p->port);
      inet_pton(AF_INET, p->host.c_str(), &a.sin_addr);
      if (connect(fd, (sockaddr*)&a, sizeof(a)) != 0) {
        close(fd);
        fd = -1;
        std::this_thread::sleep_for(std::chrono::milliseconds(50));
        continue;
      }
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      // Bounded ack wait: a receiver that swallows a REPL line (its
      // side of a partition) must not wedge this thread in fgets
      // forever — timeout, drop the conn, retry the queued line.
      timeval tv{};
      tv.tv_sec = 0;
      tv.tv_usec = 500 * 1000;
      setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      rf = fdopen(fd, "r");
    }
    if (write(fd, line.data(), line.size()) != (ssize_t)line.size()) {
      fclose(rf); rf = nullptr; close(fd); fd = -1;
      continue;
    }
    char buf[256];
    if (!fgets(buf, sizeof(buf), rf)) {
      fclose(rf); rf = nullptr; close(fd); fd = -1;
      continue;
    }
    long long seq = 0;
    if (sscanf(buf, "ACK %lld", &seq) == 1) {
      {
        std::lock_guard<std::mutex> l(p->mu);
        if (seq > p->acked) p->acked = seq;
        p->queue.pop_front();
      }
      g_ack_cv.notify_all();
    }
  }
  if (rf) fclose(rf);
  else if (fd >= 0) close(fd);
}

// Starts (or restarts) the replication channel to member <id>.
// Caller must NOT hold g_peers_mu.
void ensure_peer(int id, const std::string& hostport) {
  std::lock_guard<std::mutex> l(g_peers_mu);
  for (Peer* p : g_peers) {
    if (p->id == id) {
      std::lock_guard<std::mutex> pl(p->mu);
      if (!p->stop) return;  // already live
    }
  }
  auto colon = hostport.rfind(':');
  Peer* p = new Peer();
  p->id = id;
  p->host = hostport.substr(0, colon);
  p->port = atoi(hostport.substr(colon + 1).c_str());
  g_peers.push_back(p);
  std::thread(peer_loop, p).detach();
}

void retire_peer(int id) {
  std::lock_guard<std::mutex> l(g_peers_mu);
  for (Peer* p : g_peers) {
    if (p->id == id) {
      std::lock_guard<std::mutex> pl(p->mu);
      p->stop = true;
      p->cv.notify_one();
    }
  }
}

// "id@host:port,id@host:port" for the current members, sorted by id.
// Caller holds g_mu.
std::string view_members_str() {
  std::ostringstream out;
  bool first = true;
  for (auto& m : g_members) {
    if (!first) out << ",";
    out << m.first << "@" << m.second;
    first = false;
  }
  return out.str();
}

// Installs a view received over replication (or decided locally).
// Caller holds g_mu; peer channel reconciliation happens lazily by the
// caller OUTSIDE g_mu via the returned flag.
bool install_view(long long view_id, const std::string& members) {
  if (view_id <= g_view_id) return false;
  g_view_id = view_id;
  g_members.clear();
  std::stringstream ms(members);
  std::string item;
  while (std::getline(ms, item, ',')) {
    if (item.empty()) continue;
    auto at = item.find('@');
    g_members[atoi(item.substr(0, at).c_str())] = item.substr(at + 1);
  }
  return true;
}

// Brings replication channels in line with g_members: channels only
// for members other than self; removed members' channels retire.
void reconcile_peers() {
  std::map<int, std::string> members;
  {
    std::lock_guard<std::mutex> l(g_mu);
    members = g_members;
  }
  std::vector<int> live;
  {
    std::lock_guard<std::mutex> l(g_peers_mu);
    for (Peer* p : g_peers) live.push_back(p->id);
  }
  for (int id : live)
    if (!members.count(id)) retire_peer(id);
  for (auto& m : members)
    if (m.first != g_id) ensure_peer(m.first, m.second);
}

// Applies a mutation under g_mu; returns the response for the client.
std::string apply(const std::string& op, const std::string& k,
                  const std::string& a, const std::string& b,
                  bool* mutated) {
  *mutated = false;
  if (op == "SET") {
    g_kv[k] = a;
    *mutated = true;
    return "OK";
  }
  auto it = g_kv.find(k);
  if (it == g_kv.end()) return "NIL";
  if (it->second != a) return "FAIL";
  it->second = b;
  *mutated = true;
  return "OK";
}

// Enqueues an already-applied mutation onto every live peer channel.
// MUST be called while still holding g_mu (the lock that assigned the
// line's seq): releasing between seq assignment and enqueue lets a
// racing higher-seq line enqueue first, and the receiver's per-sender
// watermark then drops the lower-seq line forever — survivable for a
// SET, fatal for a VIEW change (a backup stuck on stale membership).
// Lock order g_mu -> g_peers_mu is used consistently.  Retired
// channels (members removed by LEAVE) are skipped: the removed node
// silently stops receiving updates.
void enqueue_all_g_mu_held(const std::string& line) {
  std::lock_guard<std::mutex> l(g_peers_mu);
  for (Peer* p : g_peers) {
    std::lock_guard<std::mutex> pl(p->mu);
    if (p->stop) continue;
    p->queue.push_back(line);
    p->cv.notify_one();
  }
}

// In --sync mode, wait for acks from unblocked live peers (timeout
// degrades to async — the bug).  Called WITHOUT g_mu.
void await_acks(long long seq) {
  if (!g_sync) return;
  std::vector<Peer*> peers;
  {
    std::lock_guard<std::mutex> l(g_peers_mu);
    peers = g_peers;
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(g_ack_timeout_ms);
  std::unique_lock<std::mutex> l(g_ack_mu);
  g_ack_cv.wait_until(l, deadline, [&] {
    for (Peer* p : peers) {
      if (blocked(p->id)) continue;
      std::lock_guard<std::mutex> pl(p->mu);
      if (p->stop) continue;
      if (p->acked < seq) return false;
    }
    return true;
  });
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
    } else if (cmd == "GET") {
      std::string k;
      in >> k;
      std::lock_guard<std::mutex> l(g_mu);
      auto it = g_kv.find(k);
      resp = it == g_kv.end() ? "NIL" : ("VAL " + it->second);
    } else if (cmd == "SET" || cmd == "CAS") {
      std::string k, a, b;
      in >> k >> a;
      if (cmd == "CAS") in >> b;
      long long seq = 0;
      bool mutated = false;
      {
        std::lock_guard<std::mutex> l(g_mu);
        if (!g_primary) {
          resp = "ERR notprimary";
        } else {
          resp = apply(cmd, k, a, b, &mutated);
          if (mutated) {
            seq = ++g_seq;
            std::ostringstream repl;
            repl << "REPL " << g_id << " " << seq << " SET " << k << " "
                 << (cmd == "SET" ? a : b) << "\n";
            enqueue_all_g_mu_held(repl.str());
          }
        }
      }
      if (mutated) await_acks(seq);
    } else if (cmd == "ADD") {
      // Set face: primary-only atomic append to a comma-joined
      // element list, replicated INCREMENTALLY (one small
      // "REPL .. ADD k v" line per element — a full-list SET line
      // would outgrow the 4096-byte request buffers within a
      // minute-long run and tear on the wire).  The per-peer queue
      // retains lines until ACKed and ships them FIFO, so a healed
      // partition converges; DURING it, backups serve frozen lists —
      // the staleness the set-full checker measures.
      std::string k, v;
      in >> k >> v;
      long long seq = 0;
      bool mutated = false;
      {
        std::lock_guard<std::mutex> l(g_mu);
        if (!g_primary) {
          resp = "ERR notprimary";
        } else {
          std::string& cur = g_kv[k];
          cur = cur.empty() ? v : cur + "," + v;
          mutated = true;
          seq = ++g_seq;
          std::ostringstream repl;
          repl << "REPL " << g_id << " " << seq << " ADD " << k << " "
               << v << "\n";
          enqueue_all_g_mu_held(repl.str());
          resp = "OK";
        }
      }
      if (mutated) await_acks(seq);
    } else if (cmd == "MEMBERS") {
      std::string k;
      in >> k;
      std::lock_guard<std::mutex> l(g_mu);
      auto it = g_kv.find(k);
      resp = (it == g_kv.end() || it->second.empty())
                 ? "NIL"
                 : ("VAL " + it->second);
    } else if (cmd == "REPL") {
      int from;
      long long seq;
      std::string op, k, v;
      in >> from >> seq >> op >> k >> v;
      if (blocked(from)) {
        // Partitioned: swallow silently (no ack) so the sender times
        // out, like a dropped packet.
        continue;
      }
      bool views_changed = false;
      {
        // Idempotent apply: a slow ack (> the sender's recv timeout)
        // makes the sender re-ship the line on a fresh connection, so
        // replays at or below the per-sender watermark are ACKed
        // without re-applying.
        std::lock_guard<std::mutex> l(g_mu);
        long long& applied = g_applied_from[from];
        if (seq > applied) {
          if (op == "VIEW") {
            views_changed = install_view(atoll(k.c_str()), v);
          } else if (op == "ADD") {
            std::string& cur = g_kv[k];
            cur = cur.empty() ? v : cur + "," + v;
          } else {
            g_kv[k] = v;
          }
          applied = seq;
          if (seq > g_seq) g_seq = seq;
        }
      }
      if (views_changed) reconcile_peers();
      resp = "ACK " + std::to_string(seq);
    } else if (cmd == "VIEW") {
      std::lock_guard<std::mutex> l(g_mu);
      resp = "VIEW " + std::to_string(g_view_id) + " " +
             view_members_str();
    } else if (cmd == "JOIN" || cmd == "LEAVE") {
      int id;
      std::string hostport;
      in >> id;
      if (cmd == "JOIN") in >> hostport;
      long long seq = 0;
      bool changed = false;
      {
        std::lock_guard<std::mutex> l(g_mu);
        if (!g_primary) {
          resp = "ERR notprimary";
        } else if (cmd == "JOIN" &&
                   hostport.find(':') == std::string::npos) {
          resp = "ERR badaddr";
        } else if (cmd == "JOIN" && g_members.count(id)) {
          resp = "ERR member";
        } else if (cmd == "LEAVE" &&
                   (id == g_id || !g_members.count(id))) {
          resp = id == g_id ? "ERR self" : "ERR nomember";
        } else {
          if (cmd == "JOIN") g_members[id] = hostport;
          else g_members.erase(id);
          g_view_id++;
          resp = "OK";
          changed = true;
          seq = ++g_seq;
          // Channel changes and the view line's enqueue happen under
          // the SAME g_mu hold that assigned seq (see
          // enqueue_all_g_mu_held): a joined member's channel exists
          // before the line ships so it hears the view; a removed
          // member's channel retires first so the leaver never learns
          // it left (the membership suite's stale-replica physics).
          if (cmd == "JOIN") ensure_peer(id, hostport);
          else retire_peer(id);
          std::ostringstream repl;
          repl << "REPL " << g_id << " " << seq << " VIEW " << g_view_id
               << " " << view_members_str() << "\n";
          enqueue_all_g_mu_held(repl.str());
        }
      }
      if (changed) await_acks(seq);
    } else if (cmd == "ROLE") {
      std::lock_guard<std::mutex> l(g_mu);
      resp = g_primary ? "PRIMARY" : "BACKUP";
    } else if (cmd == "PROMOTE") {
      std::lock_guard<std::mutex> l(g_mu);
      g_primary = true;
      resp = "OK";
    } else if (cmd == "DEMOTE") {
      std::lock_guard<std::mutex> l(g_mu);
      g_primary = false;
      resp = "OK";
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
  int port = 7100;
  std::string listen_addr = "127.0.0.1";
  std::string advertise;  // routable self-address for views
  std::string peers;  // "id@host:port,id@host:port"
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    auto next = [&]() { return std::string(argv[++i]); };
    if (a == "--port") port = atoi(next().c_str());
    else if (a == "--listen") listen_addr = next();
    else if (a == "--advertise") advertise = next();
    else if (a == "--id") g_id = atoi(next().c_str());
    else if (a == "--peers") peers = next();
    else if (a == "--primary") g_primary = true;
    else if (a == "--sync") g_sync = true;
    else if (a == "--ack-timeout-ms") g_ack_timeout_ms = atoi(next().c_str());
  }
  signal(SIGPIPE, SIG_IGN);

  // The advertised self-address enters membership views and is what
  // OTHER nodes dial after a failover: it must be routable, so a
  // wildcard --listen needs an explicit --advertise.
  g_self_addr = advertise.empty()
                    ? listen_addr + ":" + std::to_string(port)
                    : advertise;
  g_members[g_id] = g_self_addr;
  std::stringstream ps(peers);
  std::string item;
  while (std::getline(ps, item, ',')) {
    if (item.empty()) continue;
    auto at = item.find('@');
    g_members[atoi(item.substr(0, at).c_str())] = item.substr(at + 1);
  }
  reconcile_peers();

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
  fprintf(stderr, "repkv id=%d %s on %s:%d (%s)\n", g_id,
          g_primary ? "PRIMARY" : "backup", listen_addr.c_str(), port,
          g_sync ? "sync" : "async");
  while (true) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    int nd = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &nd, sizeof(nd));
    std::thread(serve, fd).detach();
  }
}
