// txnd: a tiny MVCC key-value store with snapshot-isolation
// transactions — and snapshot isolation's signature bug, write skew.
//
// The role: a REAL transactional system for the elle-equivalent
// checkers (jepsen_tpu/checker/elle) to convict, the way the
// reference project aims elle at tidb/cockroachdb/yugabyte (SURVEY.md
// §2.5).  kvdb/repkv/logd cover durability, replication, and logs;
// this covers transactions.
//
// Storage: versioned values per key, each stamped with the commit
// sequence number that wrote it.  A transaction takes a snapshot
// (the commit counter at BEGIN), reads the latest version <= its
// snapshot, buffers writes, and at COMMIT aborts iff some written
// key gained a version after the snapshot — first-committer-wins on
// WRITE-write conflicts only.  That is textbook snapshot isolation:
// two transactions that READ overlapping keys but WRITE disjoint
// ones both commit, producing G2/write-skew anomalies (Berenson et
// al. 1995; Adya's G2) that serializability forbids.
//
// --serializable widens commit validation to the READ set (aborts if
// any key read has a newer version than the snapshot — backward
// OCC), which closes the skew window: the control group.
//
// --read-committed drops BOTH the snapshot and commit validation:
// each read is its own statement against the latest committed state
// (lock taken and released per read), and writes apply blindly.
// That is READ COMMITTED — no dirty reads (only committed versions
// are ever visible), but read skew (a multi-key read straddling a
// concurrent commit) and lost updates (two read-modify-writes off
// the same stale read) are both admitted.  The bank workload's
// conserved-total invariant convicts exactly this level, the way the
// reference's bank test convicts weak MySQL/Galera settings
// (tests/bank.clj:56-120); snapshot isolation is its control group.
//
// --think-us N sleeps between snapshot acquisition and commit
// validation (and, under --read-committed, between the per-statement
// reads), widening the race window so short test runs reliably
// exhibit the anomaly (a production system's window is its
// transaction duration; we just make ours honest and visible).
//
// Protocol (line-based TCP, one txn per line, executed server-side;
// micro-ops execute in client order with intra-txn visibility):
//   TXN [r <k> | w <k> <v> | a <k> <v>] ...\n
//     -> OK [<read-val-or-NIL> per r, in order]\n   committed
//        (list keys read back comma-joined: "1,2,3")
//     -> ABORT\n                                    conflict: nothing applied
//   `a` appends to a comma-joined list — the elle list-append
//   workload's mop, a read-modify-write that rides the same
//   isolation machinery (FCW guards it under SI; --read-committed
//   computes it off a per-statement read and loses appends).
//   TRANSFER <from> <to> <amount>\n    server-side read-modify-write
//     -> OK\n          committed: from -= amount, to += amount
//     -> NSF\n         insufficient funds: nothing applied
//     -> ABORT\n       first-committer-wins conflict: nothing applied
//   PING\n -> PONG\n
//
// --init <key> <value> (repeatable) seeds a committed version before
// the listener opens — bank accounts exist race-free from op one.
//
// Values are integers; TXN writes are expected globally unique per
// key (the elle rw-register workload guarantees this).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <stdio.h>
#include <stdint.h>
#include <stdlib.h>
#include <time.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <map>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

struct Version {
  long long seq;
  std::string value;  // int string (wr/bank) or comma list (append)
};

static std::map<std::string, std::vector<Version>> g_store;
static long long g_commit_seq = 0;
static std::mutex g_mu;  // guards g_store + g_commit_seq

static bool g_serializable = false;
static bool g_read_committed = false;
static long g_think_us = 2000;

static void think() {
  // Uniform in [0, 2*think_us] (mean = think_us): real transactions
  // have VARIED durations, and heterogeneity is load-bearing for
  // observability — with a fixed gap, every read in a group sits on
  // the same side of the write-separation threshold, so e.g. the
  // long-fork anomaly's two contradictory read directions can never
  // coexist (measured: 82 partial-sighting groups, all one-sided).
  if (g_think_us <= 0) return;
  thread_local unsigned seed =
      (unsigned)(uintptr_t)&seed ^ (unsigned)time(nullptr);
  long us = (long)(rand_r(&seed) % (2 * g_think_us + 1));
  std::this_thread::sleep_for(std::chrono::microseconds(us));
}

// One transaction micro-op, in client order: 'r' read, 'w' blind
// write, 'a' list-append (read-modify-write of a comma-joined list).
struct Mop {
  char type;
  std::string key;
  std::string value;
};

// Latest committed value of key visible at `snap`; false if none.
static bool read_at(const std::string &key, long long snap,
                    std::string *out) {
  auto it = g_store.find(key);
  if (it == g_store.end()) return false;
  const auto &vs = it->second;
  for (auto r = vs.rbegin(); r != vs.rend(); ++r) {
    if (r->seq <= snap) {
      *out = r->value;
      return true;
    }
  }
  return false;
}

// Newest version seq of key (0 if never written).
static long long newest_seq(const std::string &key) {
  auto it = g_store.find(key);
  if (it == g_store.end() || it->second.empty()) return 0;
  return it->second.back().seq;
}

static std::string run_txn(const std::vector<Mop> &mops) {
  long long snap = 0;
  std::vector<std::pair<bool, std::string>> results;  // per 'r' mop
  // Txn-local effects: later mops of this txn see earlier ones
  // (standard intra-txn visibility; elle's intermediate-read analysis
  // depends on it).  Committed atomically at the end.
  std::map<std::string, std::string> buffered;

  // Reads a key as this txn sees it mid-flight: its own buffered
  // write first, else the committed version at `at`.
  auto visible = [&](const std::string &k, long long at,
                     std::string *out) -> bool {
    auto b = buffered.find(k);
    if (b != buffered.end()) {
      *out = b->second;
      return true;
    }
    return read_at(k, at, out);
  };

  auto apply = [&](const Mop &m, long long at) {
    std::string v;
    if (m.type == 'r') {
      bool have = visible(m.key, at, &v);
      results.push_back({have, v});
    } else if (m.type == 'w') {
      buffered[m.key] = m.value;
    } else {  // 'a': append to the list this txn can see
      bool have = visible(m.key, at, &v);
      buffered[m.key] = have && !v.empty() ? v + "," + m.value
                                           : m.value;
    }
  };

  if (g_read_committed) {
    // Each mop is its own statement: lock per statement, latest
    // committed state, think between statements.  A commit landing
    // in a gap is read skew; an append computed off a stale read is
    // a lost append.
    for (size_t i = 0; i < mops.size(); i++) {
      if (i > 0) think();
      std::lock_guard<std::mutex> lk(g_mu);
      apply(mops[i], g_commit_seq);
    }
  } else {
    std::lock_guard<std::mutex> lk(g_mu);
    snap = g_commit_seq;
    for (const auto &m : mops) apply(m, snap);
  }

  // The transaction "thinks" between snapshot and commit — the window
  // in which a concurrent committer can invalidate its premises.
  if (!buffered.empty()) think();

  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (!g_read_committed) {
      // First-committer-wins on the write set (appends included:
      // they read the key they write, so FCW also guards their
      // read-modify-write premise).
      for (const auto &w : buffered)
        if (newest_seq(w.first) > snap) return "ABORT";
      if (g_serializable)
        for (const auto &m : mops)
          if (m.type == 'r' && newest_seq(m.key) > snap)
            return "ABORT";
    }
    if (!buffered.empty()) {
      long long seq = ++g_commit_seq;
      for (const auto &w : buffered)
        g_store[w.first].push_back({seq, w.second});
    }
  }

  std::ostringstream out;
  out << "OK";
  for (const auto &res : results) {
    if (res.first && !res.second.empty())
      out << " " << res.second;
    else
      out << " NIL";
  }
  return out.str();
}

// Server-side read-modify-write: from -= amount, to += amount.  The
// balances the writes are computed FROM come out of the same
// isolation machinery as TXN reads — a snapshot (validated
// first-committer-wins at commit) or, under --read-committed,
// per-statement latest reads applied blindly, which is where lost
// updates and skewed totals come from.
static std::string run_transfer(const std::string &from,
                                const std::string &to,
                                long long amount) {
  // Self-transfers would push two same-seq versions of one key and
  // negative amounts would bypass the NSF check — either mints or
  // destroys money under EVERY isolation level, which the bank
  // checker would then blame on isolation.  Malformed, not a txn.
  if (from == to || amount <= 0) return "ERR bad transfer";
  long long snap = 0;
  std::string raw_from, raw_to;
  bool have_from = false, have_to = false;
  if (g_read_committed) {
    {
      std::lock_guard<std::mutex> lk(g_mu);
      have_from = read_at(from, g_commit_seq, &raw_from);
    }
    think();
    {
      std::lock_guard<std::mutex> lk(g_mu);
      have_to = read_at(to, g_commit_seq, &raw_to);
    }
  } else {
    std::lock_guard<std::mutex> lk(g_mu);
    snap = g_commit_seq;
    have_from = read_at(from, snap, &raw_from);
    have_to = read_at(to, snap, &raw_to);
  }
  long long bal_from = atoll(raw_from.c_str());
  long long bal_to = atoll(raw_to.c_str());
  if (!have_from || bal_from < amount) return "NSF";

  think();

  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (!g_read_committed) {
      // Write set = {from, to}; read set is the same, so SI and
      // serializable validation coincide for transfers.
      if (newest_seq(from) > snap || newest_seq(to) > snap)
        return "ABORT";
    }
    long long seq = ++g_commit_seq;
    g_store[from].push_back({seq, std::to_string(bal_from - amount)});
    g_store[to].push_back(
        {seq, std::to_string(have_to ? bal_to + amount : amount)});
  }
  return "OK";
}

static void serve(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  FILE *in = fdopen(fd, "r");
  FILE *out = fdopen(dup(fd), "w");
  if (!in || !out) {
    close(fd);
    return;
  }
  char line[65536];
  while (fgets(line, sizeof(line), in)) {
    std::istringstream ss(line);
    std::string cmd;
    ss >> cmd;
    std::string resp;
    if (cmd == "PING") {
      resp = "PONG";
    } else if (cmd == "TXN") {
      std::vector<Mop> mops;
      std::string op;
      bool bad = false;
      while (ss >> op) {
        if (op == "r") {
          std::string k;
          if (!(ss >> k)) { bad = true; break; }
          mops.push_back({'r', k, ""});
        } else if (op == "w" || op == "a") {
          std::string k, v;
          if (!(ss >> k >> v)) { bad = true; break; }
          // Values are integers on the wire (appends build the comma
          // lists server-side).  The old `>> long long` rejected
          // garbage; keep that guard — a committed non-numeric value
          // would silently zero bank balances via atoll later.
          size_t p = (v[0] == '-') ? 1 : 0;
          if (p >= v.size() ||
              v.find_first_not_of("0123456789", p) != std::string::npos) {
            bad = true;
            break;
          }
          mops.push_back({op[0], k, v});
        } else {
          bad = true;
          break;
        }
      }
      resp = bad ? "ERR bad txn" : run_txn(mops);
    } else if (cmd == "TRANSFER") {
      std::string from, to;
      long long amount;
      if (ss >> from >> to >> amount)
        resp = run_transfer(from, to, amount);
      else
        resp = "ERR bad transfer";
    } else {
      resp = "ERR unknown command";
    }
    fputs(resp.c_str(), out);
    fputc('\n', out);
    fflush(out);
  }
  fclose(in);
  fclose(out);
}

int main(int argc, char **argv) {
  int port = 7500;
  std::string listen_addr = "127.0.0.1";
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    if (a == "--port" && i + 1 < argc)
      port = atoi(argv[++i]);
    else if (a == "--listen" && i + 1 < argc)
      listen_addr = argv[++i];
    else if (a == "--serializable")
      g_serializable = true;
    else if (a == "--read-committed")
      g_read_committed = true;
    else if (a == "--think-us" && i + 1 < argc)
      g_think_us = atol(argv[++i]);
    else if (a == "--init" && i + 2 < argc) {
      std::string key = argv[++i];
      std::string value = argv[++i];
      g_store[key].push_back({++g_commit_seq, value});
    } else {
      fprintf(stderr, "unknown arg %s\n", a.c_str());
      return 2;
    }
  }
  signal(SIGPIPE, SIG_IGN);

  int srv = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, listen_addr.c_str(), &addr.sin_addr) != 1) {
    fprintf(stderr, "bad --listen address %s\n", listen_addr.c_str());
    return 2;
  }
  if (bind(srv, (sockaddr *)&addr, sizeof(addr)) != 0) {
    perror("bind");
    return 1;
  }
  listen(srv, 64);
  fprintf(stderr, "txnd listening on %s:%d (%s, think %ld us)\n",
          listen_addr.c_str(), port,
          g_read_committed ? "read-committed"
          : g_serializable ? "serializable"
                           : "snapshot-isolation",
          g_think_us);
  for (;;) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    std::thread(serve, fd).detach();
  }
}
