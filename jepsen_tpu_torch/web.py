"""Web dashboard: browse stored test runs over HTTP.

The port's copy of `jepsen_tpu/web.py` (host code: it takes no device;
`/metrics` reads `ops.degrade.chip_state()`, the state the last probe
left, and never probes the card).  Its pages are the reference's, byte
for byte, for the same store.  jepsen.web's equivalent: an index of
runs with name, time, and validity (web.clj:51-66 cached rows), per-run
file listings, and file serving.  Stdlib http.server instead of
http-kit/hiccup; no external deps.
"""

from __future__ import annotations

import html
import http.server
import json
import logging
import os
import urllib.parse
from typing import Any, Optional

from . import store

log = logging.getLogger(__name__)

_STYLE = """
body { font-family: sans-serif; margin: 2em; }
table { border-collapse: collapse; }
td, th { padding: 0.3em 1em; border-bottom: 1px solid #ddd; text-align: left; }
.valid-true { color: #0a0; } .valid-false { color: #a00; }
.valid-unknown { color: #a60; }
a { text-decoration: none; }
.spark-row { display: flex; align-items: center; margin: 2px 0; }
.spark-label { width: 22em; font-family: monospace; font-size: 0.85em;
               overflow: hidden; text-overflow: ellipsis; }
.spark-val { margin-left: 0.8em; font-family: monospace;
             font-size: 0.85em; color: #555; }
.spark-row canvas { border-bottom: 1px solid #eee; }
"""


#: The /monitor page's client: one canvas sparkline per series,
#: bootstrapped from /api/series, then appended live from the SSE
#: stream.  Vanilla JS, no external assets — the dashboard must render
#: inside an airgapped pod.
_MONITOR_JS = """
<script>
(function () {
  var qs = new URLSearchParams(location.search);
  var dirq = qs.get('dir') ? '&dir=' + encodeURIComponent(qs.get('dir')) : '';
  var tier = qs.get('tier') || '0';
  var PIN = [
    'monitor.verdict-lag-s', 'wgl.online.verdict-lag-s.p95',
    'monitor.ops-per-s', 'monitor.ingest-ops-per-s',
    'checkerd.queue-depth',
    'monitor.resident-history-bytes', 'monitor.series-disk-bytes',
    'monitor.cost-drift-ratio', 'monitor.epoch-restarts',
    'monitor.discards', 'chip.health'
  ];
  var MAXPTS = 300;
  var charts = {};
  function rank(n) {
    var i = PIN.indexOf(n);
    if (i >= 0) return i;
    if (n.indexOf('monitor.') === 0) return 100;
    if (n.indexOf('slo.') === 0) return 200;
    return 300;
  }
  function fmt(v) {
    if (v == null) return '-';
    if (Math.abs(v) >= 1048576) return (v / 1048576).toFixed(1) + 'M';
    if (Math.abs(v) >= 1024) return (v / 1024).toFixed(1) + 'k';
    return (Math.round(v * 1000) / 1000).toString();
  }
  function addChart(name) {
    if (charts[name]) return charts[name];
    var row = document.createElement('div');
    row.className = 'spark-row';
    var label = document.createElement('span');
    label.className = 'spark-label';
    label.textContent = name;
    var canvas = document.createElement('canvas');
    canvas.width = 320; canvas.height = 40;
    var val = document.createElement('span');
    val.className = 'spark-val';
    row.appendChild(label); row.appendChild(canvas); row.appendChild(val);
    var box = document.getElementById('charts');
    var rows = box.children, r = rank(name), inserted = false;
    for (var i = 0; i < rows.length; i++) {
      var other = rows[i].getAttribute('data-rank');
      if (r < +other ||
          (r === +other && name < rows[i].getAttribute('data-name'))) {
        box.insertBefore(row, rows[i]); inserted = true; break;
      }
    }
    if (!inserted) box.appendChild(row);
    row.setAttribute('data-rank', r);
    row.setAttribute('data-name', name);
    charts[name] = {pts: [], canvas: canvas, val: val};
    return charts[name];
  }
  function draw(name) {
    var c = charts[name], ctx = c.canvas.getContext('2d');
    var w = c.canvas.width, h = c.canvas.height, pts = c.pts;
    ctx.clearRect(0, 0, w, h);
    if (!pts.length) { c.val.textContent = '-'; return; }
    var lo = Infinity, hi = -Infinity;
    for (var i = 0; i < pts.length; i++) {
      if (pts[i][1] < lo) lo = pts[i][1];
      if (pts[i][1] > hi) hi = pts[i][1];
    }
    if (hi === lo) { hi += 1; lo -= 1; }
    ctx.strokeStyle = '#47a'; ctx.lineWidth = 1.5; ctx.beginPath();
    for (var j = 0; j < pts.length; j++) {
      var x = pts.length > 1 ? j * (w - 4) / (pts.length - 1) + 2 : w / 2;
      var y = h - 3 - (pts[j][1] - lo) * (h - 6) / (hi - lo);
      if (j === 0) ctx.moveTo(x, y); else ctx.lineTo(x, y);
    }
    ctx.stroke();
    c.val.textContent = fmt(pts[pts.length - 1][1]) +
      ' (' + fmt(lo) + '..' + fmt(hi) + ')';
  }
  function push(name, t, v) {
    if (v && typeof v === 'object') {
      v = v.mean != null ? v.mean : v.last;
    }
    if (typeof v !== 'number' || !isFinite(v)) return;
    var c = addChart(name);
    if (c.pts.length && c.pts[c.pts.length - 1][0] >= t) return;
    c.pts.push([t, v]);
    if (c.pts.length > MAXPTS) c.pts.shift();
    draw(name);
  }
  fetch('/api/series?tier=' + tier + dirq)
    .then(function (r) { return r.json(); })
    .then(function (d) {
      (d.names || []).forEach(function (n) {
        addChart(n);
        fetch('/api/series?name=' + encodeURIComponent(n) +
              '&tier=' + tier + '&limit=' + MAXPTS + dirq)
          .then(function (r) { return r.json(); })
          .then(function (s) {
            charts[n].pts = (s.points || []).concat(charts[n].pts);
            if (charts[n].pts.length > MAXPTS) {
              charts[n].pts = charts[n].pts.slice(-MAXPTS);
            }
            draw(n);
          });
      });
      var es = new EventSource('/api/series/stream?tier=' + tier + dirq);
      es.onmessage = function (ev) {
        var p = JSON.parse(ev.data);
        var s = p.s || {};
        Object.keys(s).forEach(function (n) { push(n, p.t, s[n]); });
      };
    });
})();
</script>
"""

_FLEET_JS = """
<script>
(function () {
  'use strict';
  function fmtBytes(b) {
    if (b > 1048576) { return (b / 1048576).toFixed(1) + 'M'; }
    if (b > 1024) { return (b / 1024).toFixed(1) + 'K'; }
    return String(b);
  }
  function drawSpark(canvas, pts) {
    var ctx = canvas.getContext('2d');
    var W = canvas.width, H = canvas.height;
    ctx.clearRect(0, 0, W, H);
    if (!pts.length) { return; }
    var vs = pts.map(function (p) { return p[1]; });
    var mn = Math.min.apply(null, vs), mx = Math.max.apply(null, vs);
    var span = (mx - mn) || 1;
    ctx.strokeStyle = '#069';
    ctx.beginPath();
    pts.forEach(function (p, i) {
      var x = i / Math.max(1, pts.length - 1) * (W - 2) + 1;
      var y = H - 2 - (p[1] - mn) / span * (H - 4);
      if (i === 0) { ctx.moveTo(x, y); } else { ctx.lineTo(x, y); }
    });
    ctx.stroke();
  }
  var sparks = {};   // tenant -> points
  var streams = {};  // tenant -> EventSource
  function ensureStream(name, dir) {
    if (streams[name]) { return; }
    var es = new EventSource(
      '/api/series/stream?dir=' + encodeURIComponent(dir));
    es.onmessage = function (ev) {
      var p = JSON.parse(ev.data);
      var v = (p.s || {})['monitor.ops-per-s'];
      if (v === undefined) { return; }
      var pts = sparks[name] = sparks[name] || [];
      pts.push([p.t, v]);
      if (pts.length > 60) { pts.shift(); }
      var row = document.getElementById('t-' + name);
      if (row) { drawSpark(row.querySelector('.spark'), pts); }
    };
    streams[name] = es;
  }
  function refresh() {
    fetch('/api/fleet')
      .then(function (r) { return r.json(); })
      .then(function (d) {
        Object.keys(d.tenants || {}).forEach(function (name) {
          var t = d.tenants[name];
          var row = document.getElementById('t-' + name);
          if (!row) { return; }
          var sup = t.supervisor || {};
          var state = (t.spec || {}).state || '?';
          if (sup.alive === false && state === 'running') {
            state += ' (down)';
          }
          row.querySelector('.state').textContent = state;
          var firing = t['slo-firing'] || [];
          var slo = row.querySelector('.slo');
          slo.textContent = firing.length ? firing.join(', ') : 'ok';
          slo.style.color = firing.length ? '#b00' : '#080';
          row.querySelector('.restarts').textContent =
            String(sup.restarts || 0);
          row.querySelector('.shed').textContent =
            firing.indexOf('tenant-shed-backoff-rate') >= 0 ?
            'backing off' : 'ok';
          row.querySelector('.disk').textContent =
            fmtBytes(t['disk-bytes'] || 0);
          if (!sparks[name] && (t.spark || []).length) {
            sparks[name] = t.spark.slice(-60);
            drawSpark(row.querySelector('.spark'), sparks[name]);
          }
          ensureStream(name, t.dir);
        });
      });
  }
  refresh();
  setInterval(refresh, 5000);
})();
</script>
"""

#: {run_dir: (jtpu mtime, validity)} so the index doesn't re-scan every
#: test file on every page load (web.clj:51-66 caches its rows too).
_validity_cache: dict[str, tuple[float, str]] = {}


def _validity(run_dir: str) -> str:
    jtpu = os.path.join(run_dir, store.TEST_FILE)
    try:
        mtime = os.path.getmtime(jtpu)
    except OSError:
        return "?"
    cached = _validity_cache.get(run_dir)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    try:
        tf = store.load(run_dir)
        try:
            res = tf.results
            v = "?" if res is None else str(res.get("valid"))
        finally:
            tf.close()
    except Exception:  # noqa: BLE001
        v = "?"
    _validity_cache[run_dir] = (mtime, v)
    return v


def _slo_panel() -> str:
    """Per-rule SLO status table (telemetry/slo.py) for the index and
    /fleet pages.  Renders this process's engine — the dashboard
    co-hosted with runs or a daemon shows live state; a detached one
    shows the stock rules all-clear."""
    try:
        from .telemetry import slo

        rows = slo.status()
    except Exception:  # noqa: BLE001 — render, don't 500
        return ""
    if not rows:
        return ""
    trs = "".join(
        f"<tr><td>{html.escape(str(r['rule']))}</td>"
        f"<td>{html.escape(str(r['kind']))}</td>"
        f"<td>{html.escape(str(r['target']))}</td>"
        f"<td>{html.escape(str(r['threshold']))}</td>"
        f"<td class='valid-{'false' if r['firing'] else 'true'}'>"
        f"{'FIRING' if r['firing'] else 'ok'}</td>"
        f"<td>{html.escape(str(r['value']))}</td></tr>"
        for r in rows
    )
    return (
        "<h2>SLOs</h2><table><tr><th>rule</th><th>kind</th>"
        "<th>target</th><th>threshold</th><th>state</th><th>last value"
        "</th></tr>" + trs + "</table>"
    )


def _fmt_rate(v: Any) -> str:
    """Engineering-notation rate for roofline cells (1.2e9 -> 1.2 G)."""
    if not isinstance(v, (int, float)):
        return "-"
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"),
                          (1e3, "k")):
        if abs(v) >= scale:
            return f"{v / scale:.2f} {suffix}"
    return f"{v:.3f}"


def _roofline_panel(summary: Any) -> str:
    """Per-pass roofline table (telemetry/roofline.summarize shape):
    achieved FLOP/s and bytes/s vs device peak, arithmetic intensity
    against the memory/compute knee, and which side each pass lands
    on.  Shared by /fleet (from checkerd STATS) and /monitor (from the
    store's profiles.jsonl)."""
    if not isinstance(summary, dict) or not summary:
        return ""
    knee = None
    trs = ""
    for name, s in sorted(summary.items()):
        if not isinstance(s, dict):
            continue
        if knee is None and isinstance(s.get("knee_intensity"),
                                       (int, float)):
            knee = s["knee_intensity"]
        ratio = s.get("median_flops_ratio")
        pct = f"{ratio * 100:.4f}%" if isinstance(
            ratio, (int, float)) else "-"
        bound = s.get("bound") or "-"
        trs += (
            f"<tr><td>{html.escape(str(name))}</td>"
            f"<td>{s.get('n')}</td><td>{s.get('with_cost')}</td>"
            f"<td>{_fmt_rate(s.get('median_flops'))}</td>"
            f"<td>{_fmt_rate(s.get('median_achieved_flops_per_s'))}</td>"
            f"<td>{pct}</td>"
            f"<td>{_fmt_rate(s.get('median_achieved_bytes_per_s'))}</td>"
            f"<td>{_fmt_rate(s.get('median_arithmetic_intensity'))}</td>"
            f"<td>{html.escape(str(bound))}</td></tr>"
        )
    if not trs:
        return ""
    kneenote = (
        f" · knee at intensity {knee:.2f} FLOP/byte (left of the knee "
        "is memory-bound, right is compute-bound)"
        if isinstance(knee, (int, float)) else ""
    )
    return (
        "<h2>roofline (telemetry/roofline.py)</h2>"
        f"<p>per-pass medians vs device peak{kneenote}</p>"
        "<table><tr><th>pass</th><th>n</th><th>with cost</th>"
        "<th>flops</th><th>achieved FLOP/s</th><th>% of peak</th>"
        "<th>achieved B/s</th><th>intensity</th><th>bound</th></tr>"
        + trs + "</table>"
    )


def _page(title: str, body: str) -> bytes:
    return (
        f"<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title><style>{_STYLE}</style>"
        f"</head><body><h1>{html.escape(title)}</h1>{body}</body></html>"
    ).encode()


class Handler(http.server.BaseHTTPRequestHandler):
    store_dir = "store"

    def log_message(self, fmt: str, *args) -> None:  # quiet
        log.debug("web: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str = "text/html") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        raw_path, _, raw_query = self.path.partition("?")
        path = urllib.parse.unquote(raw_path)
        self._query = urllib.parse.parse_qs(raw_query)
        try:
            if path in ("/", ""):
                self._index()
            elif path.startswith("/files/"):
                self._file(path[len("/files/"):])
            elif path.startswith("/zip/"):
                self._zip(path[len("/zip/"):])
            elif path.startswith("/telemetry/"):
                self._telemetry(path[len("/telemetry/"):])
            elif path.startswith("/search/"):
                self._search(path[len("/search/"):])
            elif path.rstrip("/") == "/fleet":
                self._fleet()
            elif path.rstrip("/") == "/metrics":
                self._metrics()
            elif path.rstrip("/") == "/monitor":
                self._monitor()
            elif path.rstrip("/") == "/api/series/stream":
                self._series_stream()
            elif path.rstrip("/") == "/api/series":
                self._series_api()
            elif path.rstrip("/") == "/api/fleet":
                self._fleet_api()
            else:
                self._send(404, _page("404", "<p>not found</p>"))
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001
            log.exception("web error")
            self._send(500, _page("error", f"<pre>{html.escape(repr(e))}</pre>"))

    def _index(self) -> None:
        # Fault-search dirs (`jepsen search` state under
        # <store>/<name>-search/) get their own coverage-panel links
        # and stay out of the test-run table — their subdirs are
        # corpus/cells/runs, not timestamped runs.
        search_names = set()
        root = self.store_dir
        if os.path.isdir(root):
            for name in sorted(os.listdir(root)):
                d = os.path.join(root, name)
                if os.path.isfile(os.path.join(d, "search.json")):
                    search_names.add(name)
        searches = [
            f"<li><a href='/search/{urllib.parse.quote(n)}'>"
            f"{html.escape(n)}</a></li>"
            for n in sorted(search_names)
        ]
        rows = []
        for name, runs in sorted(store.tests(self.store_dir).items()):
            if name in search_names:
                continue
            for t, d in sorted(runs.items(), reverse=True):
                v = _validity(d)
                rel = os.path.relpath(d, self.store_dir)
                q = urllib.parse.quote(rel)
                tel = (
                    f"<a href='/telemetry/{q}'>telemetry</a>"
                    if os.path.isfile(os.path.join(d, "telemetry.json"))
                    else ""
                )
                forens = (
                    f"<a href='/files/{q}/forensics/'>forensics</a>"
                    if os.path.isdir(os.path.join(d, "forensics"))
                    else ""
                )
                rows.append(
                    f"<tr><td><a href='/files/{q}/'>"
                    f"{html.escape(name)}</a></td>"
                    f"<td>{html.escape(t)}</td>"
                    f"<td class='valid-{html.escape(v.lower())}'>{html.escape(v)}</td>"
                    f"<td>{tel}</td>"
                    f"<td>{forens}</td>"
                    f"<td><a href='/zip/{q}'>zip</a></td></tr>"
                )
        body = (
            "<p><a href='/fleet'>checker fleet</a> · "
            "<a href='/monitor'>monitor observatory</a></p>"
            + (
                "<h2>fault searches</h2><ul>" + "".join(searches)
                + "</ul>" if searches else ""
            )
            + "<table><tr><th>test</th><th>time</th><th>valid?</th>"
            "<th></th><th></th><th></th></tr>"
            + "".join(rows)
            + "</table>"
            + _slo_panel()
        )
        self._send(200, _page("jepsen-tpu store", body))

    def _fleet(self) -> None:
        """Live stats of a checkerd daemon (checkerd/scheduler.py
        stats()): per-run queue depth, cohort merge ratio, device
        utilization, verdict latency.  The daemon address comes from
        ?addr=host:port, the JEPSEN_CHECKERD env var, or the default
        port on localhost."""
        from .checkerd import ADDR_ENV, DEFAULT_PORT

        addr = (
            (self._query.get("addr") or [None])[0]
            or os.environ.get(ADDR_ENV)
            or f"127.0.0.1:{DEFAULT_PORT}"
        )
        hint = (
            "<p>point this page elsewhere with <code>?addr=host:port"
            "</code>; start a daemon with <code>jepsen checkerd</code>"
            " and route runs through it with <code>--remote</code></p>"
        )
        lint_tbl = ""
        try:
            from .analysis.core import read_store_summary

            summary = read_store_summary(self.store_dir)
        except Exception:  # noqa: BLE001 — render, don't 500
            summary = None
        if summary:
            counts = summary.get("counts") or {}
            families = summary.get("families") or {}
            lrows = "".join(
                f"<tr><td>{html.escape(str(k))}</td>"
                f"<td>{html.escape(str(v))}</td></tr>"
                for k, v in [
                    ("last run", summary.get("at")),
                    ("clean", summary.get("clean")),
                    ("unbaselined", summary.get("unbaselined")),
                    ("baselined", summary.get("baselined")),
                    ("errors", counts.get("error")),
                    ("warnings", counts.get("warning")),
                    ("advice", counts.get("advice")),
                    ("files", summary.get("files")),
                    ("duration s", summary.get("duration_s")),
                ]
            )
            frows = "".join(
                f"<tr><td>{html.escape(str(fam))}</td>"
                f"<td>{sevs.get('error', 0)}</td>"
                f"<td>{sevs.get('warning', 0)}</td>"
                f"<td>{sevs.get('advice', 0)}</td></tr>"
                for fam, sevs in sorted(families.items())
                if isinstance(sevs, dict)
            )
            fam_tbl = (
                "<h3>by family</h3><table><tr><th>family</th>"
                "<th>errors</th><th>warnings</th><th>advice</th></tr>"
                f"{frows}</table>" if frows else ""
            )
            lint_tbl = (
                "<h2>static analysis (jepsenlint)</h2>"
                f"<table>{lrows}</table>" + fam_tbl
            )
        try:
            from .checkerd.client import fetch_stats

            stats = fetch_stats(addr, timeout=2.0)
        except Exception as e:  # noqa: BLE001 — render, don't 500
            self._send(200, _page(
                "checker fleet",
                f"<p>checkerd at <code>{html.escape(addr)}</code> "
                f"is unreachable: <code>{html.escape(repr(e))}</code>"
                f"</p>" + _slo_panel() + lint_tbl + hint,
            ))
            return
        if stats.get("router"):
            # The address is a federation router (checkerd/router.py):
            # render the fleet-wide panel instead of single-daemon stats.
            self._send(200, _page(
                "checker federation",
                self._federation_panel(addr, stats)
                + _slo_panel() + lint_tbl + hint,
            ))
            return
        devs = stats.get("devices") or {}
        lat = stats.get("verdict-latency") or {}
        overview = [
            ("daemon", addr),
            ("uptime s", stats.get("uptime-s")),
            ("devices", f"{devs.get('count')} x {devs.get('platform')}"),
            ("device utilization", stats.get("utilization")),
            ("queue depth", stats.get("queue-depth")),
            ("requests", stats.get("requests")),
            ("keys", stats.get("keys")),
            ("cohorts", stats.get("cohorts")),
            ("cohorts merged (>1 run)", stats.get("cohorts-merged")),
            ("merge ratio", stats.get("merge-ratio")),
            ("models cached", stats.get("models-cached")),
            ("chip health", stats.get("chip-health")),
            ("profile records", stats.get("profile-records")),
            ("verdict latency mean s", lat.get("mean-s")),
            ("verdict latency max s", lat.get("max-s")),
        ]
        orows = "".join(
            f"<tr><td>{html.escape(str(k))}</td>"
            f"<td>{html.escape(str(v))}</td></tr>"
            for k, v in overview
        )
        rrows = ""
        for run, d in sorted((stats.get("runs") or {}).items()):
            rrows += (
                f"<tr><td>{html.escape(str(run))}</td>"
                f"<td>{d.get('queued')}</td><td>{d.get('running')}</td>"
                f"<td>{d.get('submitted')}</td><td>{d.get('done')}</td>"
                f"<td>{d.get('merged')}</td>"
                f"<td>{d.get('last-latency-s')}</td></tr>"
            )
        runs_tbl = (
            "<h2>runs</h2><table><tr><th>run</th><th>queued</th>"
            "<th>running</th><th>submitted</th><th>done</th>"
            "<th>merged</th><th>last latency s</th></tr>"
            + rrows + "</table>"
        ) if rrows else "<p>no runs have submitted yet</p>"
        plan_tbl = ""
        plan = stats.get("plan") or {}
        if plan:
            cache = plan.get("cache") or {}
            memo = cache.get("memo") or {}
            cm = plan.get("costmodel") or {}
            prows = "".join(
                f"<tr><td>{html.escape(str(k))}</td>"
                f"<td>{html.escape(str(v))}</td></tr>"
                for k, v in [
                    ("plan executor", "on" if plan.get("enabled")
                     else "off"),
                    ("cache dir", cache.get("dir") or "(not configured)"),
                    ("memo entries", memo.get("entries")),
                    ("memo hits", memo.get("hits")),
                    ("memo misses", memo.get("misses")),
                    ("memo stores", memo.get("puts")),
                    ("xla cache files", cache.get("xla_files")),
                    ("cost model", "trained" if cm.get("loaded")
                     else "heuristics"),
                    ("cost model passes", ", ".join(cm.get("passes") or [])
                     or "-"),
                ]
            )
            plan_tbl = (
                "<h2>plan cache (plan/cache.py)</h2>"
                f"<table>{prows}</table>"
            )
        ov_tbl = ""
        ov = stats.get("overload") or {}
        if ov:
            weights = ov.get("weights") or {}
            head = "".join(
                f"<tr><td>{html.escape(str(k))}</td>"
                f"<td>{html.escape(str(v))}</td></tr>"
                for k, v in [
                    ("brownout level", ov.get("brownout-level")),
                    ("sheds total", ov.get("shed")),
                    ("fair-queue quantum (key-credits)",
                     ov.get("quantum")),
                ]
            )
            trows = "".join(
                f"<tr><td>{html.escape(str(t))}</td>"
                f"<td>{weights.get(t, 1.0)}</td>"
                f"<td>{d.get('served')}</td><td>{d.get('shed')}</td>"
                f"<td>{d.get('queue-wait-p95-s')}</td></tr>"
                for t, d in sorted((ov.get("tenants") or {}).items())
                if isinstance(d, dict)
            )
            tenants_tbl = (
                "<h3>tenants (deficit round-robin)</h3><table>"
                "<tr><th>tenant</th><th>weight</th><th>served</th>"
                "<th>shed</th><th>queue-wait p95 s</th></tr>"
                + trows + "</table>"
            ) if trows else ""
            ov_tbl = (
                "<h2>overload control (checkerd/overload.py)</h2>"
                f"<table>{head}</table>" + tenants_tbl
            )
        self._send(200, _page(
            "checker fleet",
            f"<table>{orows}</table>" + runs_tbl + ov_tbl + plan_tbl
            + _roofline_panel(stats.get("roofline"))
            + _slo_panel() + lint_tbl + hint,
        ))

    def _federation_panel(self, addr: str, stats: dict) -> str:
        """The /fleet body for a federation router: router overview
        (placement, failover, admission counters) plus one row per
        daemon with its health state, queue depth and cache warmth."""
        quota = stats.get("quota") or {}
        qj = stats.get("queue-journal") or {}
        overview = [
            ("router", addr),
            ("uptime s", stats.get("uptime-s")),
            ("daemons", len(stats.get("daemons") or {})),
            ("fleet queue depth", stats.get("queue-depth")),
            ("tickets in flight", stats.get("inflight")),
            ("submits placed", stats.get("submits")),
            ("results relayed", stats.get("results")),
            ("failovers", stats.get("failovers")),
            ("admission rejected", stats.get("admission-rejected")),
            ("replayed from journal", stats.get("replayed")),
            ("tenant quota", quota.get("tenant-quota") or "unlimited"),
            ("max in-flight", quota.get("max-inflight") or "unlimited"),
            ("ticket journal", qj.get("path") or "(not configured)"),
        ]
        orows = "".join(
            f"<tr><td>{html.escape(str(k))}</td>"
            f"<td>{html.escape(str(v))}</td></tr>"
            for k, v in overview
        )
        health = stats.get("health") or {}
        # Model-cache affinity inverted: daemon -> spec count (which
        # caches placement considers warm there).
        warm: dict = {}
        for _spec, d in (stats.get("affinity") or {}).items():
            warm[d] = warm.get(d, 0) + 1
        drows = ""
        for d, st in sorted((stats.get("daemons") or {}).items()):
            h = health.get(str(d)) or {}
            if not isinstance(st, dict) or st.get("unreachable"):
                drows += (
                    f"<tr><td>{html.escape(str(d))}</td>"
                    f"<td>{html.escape(str(h.get('state') or '?'))}</td>"
                    f"<td colspan=4>unreachable</td></tr>"
                )
                continue
            drows += (
                f"<tr><td>{html.escape(str(d))}</td>"
                f"<td>{html.escape(str(h.get('state') or 'healthy'))}</td>"
                f"<td>{html.escape(str(st.get('queue-depth')))}</td>"
                f"<td>{html.escape(str(st.get('requests')))}</td>"
                f"<td>{html.escape(str(st.get('models-cached')))}</td>"
                f"<td>{html.escape(str(warm.get(str(d), 0)))}</td></tr>"
            )
        daemons_tbl = (
            "<h2>daemons</h2><table><tr><th>daemon</th><th>health</th>"
            "<th>queue depth</th><th>requests</th><th>models cached</th>"
            "<th>affinity specs</th></tr>" + drows + "</table>"
        )
        shed_tbl = ""
        sheds = stats.get("shed-by-tenant") or {}
        if sheds:
            srows = "".join(
                f"<tr><td>{html.escape(str(t))}</td>"
                f"<td>{html.escape(str(n))}</td></tr>"
                for t, n in sorted(sheds.items())
            )
            shed_tbl = (
                "<h2>admission sheds by tenant</h2><table>"
                "<tr><th>tenant</th><th>sheds</th></tr>"
                + srows + "</table>"
            )
        return f"<table>{orows}</table>" + daemons_tbl + shed_tbl

    def _metrics(self) -> None:
        """Prometheus text scrape surface: this process's telemetry
        counters/gauges/span totals plus the chip-health one-hot.  The
        dashboard usually runs in a different process from the test
        runs, so the interesting numbers here are the daemon-side ones
        when the dashboard and checkerd are co-hosted — checkerd also
        exposes its own /metrics (see checkerd.server.make_metrics_server)
        for the common split deployment."""
        from . import telemetry
        from .ops import degrade

        extra = {}
        try:
            from .checkerd.client import fetch_stats

            stats = fetch_stats(
                self._query.get("addr", ["127.0.0.1:7462"])[0],
                timeout=2.0,
            )
            for key in ("queue-depth", "utilization", "uptime-s",
                        "requests", "cohorts", "merge-ratio",
                        "profile-records"):
                if stats.get(key) is not None:
                    extra[f"checkerd.{key}"] = float(stats[key])
        except Exception:  # noqa: BLE001 — scrape must not 500
            pass
        lint_counts = None
        try:
            from .analysis.core import read_store_summary

            summary = read_store_summary(self.store_dir)
            if summary:
                # Prefer the per-family breakdown (adds the `family`
                # label); older summaries only carry flat counts.
                lint_counts = (summary.get("families")
                               or summary.get("counts"))
        except Exception:  # noqa: BLE001 — scrape must not 500
            pass
        # Evaluate the SLO rules with the freshest samples this scrape
        # gathered (daemon gauges resolve through `extra`), so the
        # exported jepsen_slo_firing family reflects this instant.
        try:
            from .telemetry import slo

            slo.evaluate(extra, degrade.chip_state())
        except Exception:  # noqa: BLE001 — scrape must not 500
            pass
        body = telemetry.prometheus_text(
            extra_gauges=extra, chip_state=degrade.chip_state(),
            lint_findings=lint_counts,
        ).encode()
        self._send(200, body, ctype="text/plain; version=0.0.4")

    def _series_root(self) -> Optional[str]:
        """Directory holding the monitor's series-t*.jtpu files: the
        store dir itself (a co-hosted `jepsen monitor --serve-port`),
        an explicit ?dir= subdir, or the first subdir that has them (a
        detached `jepsen serve store` over `store/monitor`)."""
        from .telemetry import timeseries

        root = os.path.realpath(self.store_dir)
        sub = (self._query.get("dir") or [""])[0].strip("/")
        if sub:
            cand = os.path.realpath(os.path.join(root, sub))
            if cand == root or cand.startswith(root + os.sep):
                return cand
            return None
        if os.path.isfile(timeseries.series_path(root, 0)):
            return root
        if os.path.isdir(root):
            for name in sorted(os.listdir(root)):
                d = os.path.join(root, name)
                if os.path.isfile(timeseries.series_path(d, 0)):
                    return d
        return None

    def _series_api(self) -> None:
        """JSON read API over the durable series store, straight from
        disk so it works cross-process and across monitor restarts.
        Without ?name= lists series names; with it returns points."""
        from .telemetry import timeseries

        root = self._series_root()
        if root is None:
            self._send(404, b'{"error": "no series store found"}',
                       "application/json")
            return
        q = self._query
        try:
            tier = min(2, max(0, int((q.get("tier") or ["0"])[0])))
        except ValueError:
            tier = 0
        name = (q.get("name") or [""])[0]
        if not name:
            body: dict = {
                "tier": tier,
                "names": timeseries.read_disk_names(root, tier),
            }
        else:
            try:
                since = (float(q["since"][0])
                         if q.get("since") else None)
            except ValueError:
                since = None
            try:
                limit = int((q.get("limit") or ["0"])[0])
            except ValueError:
                limit = 0
            body = {
                "name": name,
                "tier": tier,
                "points": timeseries.read_disk_series(
                    root, name, tier=tier, since=since, limit=limit
                ),
            }
        self._send(200, json.dumps(body).encode(), "application/json")

    def _series_stream(self) -> None:
        """Server-sent events: tails the tier file and pushes each new
        sample payload ({"t": ..., "s": {name: value}}) as one event.
        The dashboard's EventSource reconnects on its own, so each
        connection is capped rather than held forever."""
        import time as _time

        from .telemetry import timeseries

        root = self._series_root()
        if root is None:
            self._send(404, b'{"error": "no series store found"}',
                       "application/json")
            return
        try:
            tier = min(2, max(0, int(
                (self._query.get("tier") or ["0"])[0]
            )))
        except ValueError:
            tier = 0
        tail = timeseries.SeriesTail(timeseries.series_path(root, tier))
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            deadline = _time.monotonic() + 3600.0
            while _time.monotonic() < deadline:
                for payload in tail.poll():
                    self.wfile.write(
                        b"data: " + json.dumps(payload).encode() + b"\n\n"
                    )
                # Keepalive comment doubles as disconnect detection.
                self.wfile.write(b": keepalive\n\n")
                self.wfile.flush()
                _time.sleep(2.0)
        finally:
            tail.close()

    def _fleet_root(self) -> Optional[str]:
        """Directory holding a fleet registry (fleet.json): the store
        dir itself or a contained ?dir= subdir."""
        root = os.path.realpath(self.store_dir)
        sub = (self._query.get("dir") or [""])[0].strip("/")
        if sub:
            cand = os.path.realpath(os.path.join(root, sub))
            if not (cand == root or cand.startswith(root + os.sep)):
                return None
            root = cand
        from .monitor.fleet import FLEET_FILE
        if os.path.isfile(os.path.join(root, FLEET_FILE)):
            return root
        return None

    def _fleet_api(self) -> None:
        """JSON fleet overview: registry + supervisor status + one
        summary/SLO/sparkline row per tenant, read straight from each
        tenant's own store dir (crash-safe files only, so this works
        with the supervisor dead)."""
        from .monitor import fleet as mfleet
        from .monitor.retention import disk_bytes
        from .telemetry import slo as tslo
        from .telemetry import timeseries

        root = self._fleet_root()
        if root is None:
            self._send(404, b'{"error": "no fleet registry found"}',
                       "application/json")
            return
        registry = mfleet.FleetRegistry(root).load()
        status = mfleet.read_status(root)
        sup_rows = status.get("tenants") or {}
        tenants = {}
        for name, spec in sorted(registry.items()):
            tstore = mfleet.tenant_store_dir(root, name)
            row: dict = {
                "spec": spec.to_json(),
                "supervisor": sup_rows.get(name) or {},
                "dir": os.path.relpath(
                    tstore, os.path.realpath(self.store_dir)),
            }
            for fname, key in (("monitor-summary.json", "summary"),
                               ("live-status.json", "live")):
                try:
                    with open(os.path.join(tstore, fname)) as f:
                        row[key] = json.load(f)
                except (OSError, ValueError):
                    row[key] = {}
            last: dict = {}
            for rec in tslo.read(tslo.slo_path(tstore)):
                last[rec.get("rule")] = rec
            row["slo-firing"] = sorted(
                r for r, rec in last.items()
                if rec.get("rec") == "firing")
            row["disk-bytes"] = (disk_bytes(tstore)
                                 if os.path.isdir(tstore) else 0)
            try:
                row["spark"] = timeseries.read_disk_series(
                    tstore, "monitor.ops-per-s", limit=60)
            except OSError:
                row["spark"] = []
            tenants[name] = row
        body = {"t": status.get("t"), "root": root,
                "endpoint": status.get("endpoint"),
                "tenants": tenants}
        self._send(200, json.dumps(body).encode(), "application/json")

    def _monitor(self) -> None:
        """Live observatory for a `jepsen monitor` run: one sparkline
        per stored series (pinned ones first), bootstrapped from
        /api/series and updated over the SSE stream.  When the store
        dir is a fleet root (fleet.json) and no ?dir= selects a
        tenant, renders the fleet-scale view instead: one row per
        tenant, linking into each tenant's own dashboard."""
        if not (self._query.get("dir") or [""])[0].strip("/"):
            froot = self._fleet_root()
            if froot is not None:
                self._fleet_view(froot)
                return
        root = self._series_root()
        if root is None:
            # No series yet — the roofline panel still renders off any
            # profiles.jsonl under the store dir.
            self._send(200, _page(
                "monitor observatory",
                "<p>no series store found under "
                f"<code>{html.escape(self.store_dir)}</code> — start "
                "one with <code>jepsen monitor --store-dir "
                f"{html.escape(self.store_dir)}/monitor</code> or point "
                "this page at a subdir with <code>?dir=name</code></p>"
                + self._monitor_roofline(
                    os.path.realpath(self.store_dir)),
            ))
            return
        summ_html = ""
        spath = os.path.join(root, "monitor-summary.json")
        try:
            with open(spath) as f:
                summ = json.load(f)
            rows = "".join(
                f"<tr><td>{html.escape(str(k))}</td>"
                f"<td>{html.escape(str(summ.get(k)))}</td></tr>"
                for k in ("ops", "duration_s", "rate_measured",
                          "ok_keys", "unknown_keys", "verdict_lag_s",
                          "series_disk_bytes")
                if k in summ
            )
            summ_html = (
                "<h2>last completed run</h2>"
                f"<table>{rows}</table>"
            )
        except (OSError, ValueError):
            pass
        rel = os.path.relpath(root, os.path.realpath(self.store_dir))
        if rel == ".":
            rel = ""
        body = (
            f"<p>series store: <code>{html.escape(root)}</code> · "
            f"<a href='/api/series?dir={urllib.parse.quote(rel)}'>"
            "series API</a> · tiers: "
            + " ".join(
                f"<a href='/monitor?tier={t}&dir="
                f"{urllib.parse.quote(rel)}'>t{t}</a>"
                for t in (0, 1, 2)
            )
            + "</p><div id='charts'></div>"
            + _MONITOR_JS
            + summ_html
            + self._monitor_faults(root)
            + self._monitor_roofline(root)
            + _slo_panel()
        )
        self._send(200, _page("monitor observatory", body))

    def _fleet_view(self, froot: str) -> None:
        """Fleet-scale /monitor: one row per tenant (state, verdict
        sparkline, SLO state, restarts, shed backoffs, disk bytes),
        bootstrapped from /api/fleet (polled) with the sparkline kept
        live over each tenant's own SSE series stream."""
        from .monitor.fleet import FleetRegistry

        names = sorted(FleetRegistry(froot).load())
        rows = "".join(
            f"<tr id='t-{html.escape(n)}'>"
            f"<td><a href='/monitor?dir=tenants/"
            f"{urllib.parse.quote(n)}/store'>{html.escape(n)}</a></td>"
            "<td class='state'>–</td>"
            "<td><canvas class='spark' width='180' height='28'>"
            "</canvas></td>"
            "<td class='slo'>–</td><td class='restarts'>–</td>"
            "<td class='shed'>–</td><td class='disk'>–</td></tr>"
            for n in names
        )
        body = (
            f"<p>fleet root: <code>{html.escape(froot)}</code> · "
            f"{len(names)} tenant(s) · "
            "<a href='/api/fleet'>fleet API</a> · "
            "<a href='/metrics'>metrics</a></p>"
            "<table><tr><th>tenant</th><th>state</th>"
            "<th>ops/s</th><th>SLO</th><th>restarts</th>"
            "<th>shed</th><th>disk</th></tr>"
            f"{rows}</table>"
            + _FLEET_JS
        )
        self._send(200, _page("fleet observatory", body))

    def _monitor_faults(self, root: str) -> str:
        """Fault-timeline panel for a live (`--suite`) monitor:
        live-status.json's recent windows as a table — family mix,
        outcome fingerprint, novelty, epoch restarts, outstanding
        intent — plus the coverage-search totals."""
        path = os.path.join(root, "live-status.json")
        try:
            with open(path) as f:
                st = json.load(f)
        except (OSError, ValueError):
            return ""
        rows = "".join(
            f"<tr><td>{w.get('window')}</td>"
            f"<td>{html.escape(','.join(w.get('families') or []))}</td>"
            f"<td><code>{html.escape(str(w.get('fingerprint')))}"
            "</code></td>"
            f"<td>{len(w.get('novel') or [])}</td>"
            f"<td>{w.get('epoch-restarts')}</td>"
            f"<td>{w.get('outstanding')}</td>"
            f"<td>{html.escape(str(w.get('error') or ''))}</td></tr>"
            for w in (st.get("recent") or [])
        )
        return (
            "<h2>live fault windows</h2>"
            f"<p>{st.get('windows')} windows, "
            f"{st.get('novel-windows')} novel, "
            f"{st.get('coverage')} coverage features, "
            f"frontier {st.get('frontier')} "
            f"(families: {html.escape(','.join(st.get('families') or []))})"
            "</p><table><tr><th>#</th><th>families</th>"
            "<th>fingerprint</th><th>novel</th><th>epochs</th>"
            "<th>outstanding</th><th>error</th></tr>"
            f"{rows}</table>"
        )

    def _monitor_roofline(self, root: str) -> str:
        """Roofline panel for /monitor: summarizes the profiles.jsonl
        co-located with the series store (the monitored run's profile
        records), or the store dir's own when the subdir has none."""
        try:
            from .telemetry import profile, roofline

            for d in (root, os.path.realpath(self.store_dir)):
                p = os.path.join(d, profile.PROFILE_FILE)
                if os.path.isfile(p):
                    recs = profile.read(p)[-2000:]
                    return _roofline_panel(roofline.summarize(recs))
        except Exception:  # noqa: BLE001 — render, don't 500
            pass
        return ""

    def _telemetry(self, rel: str) -> None:
        """Renders a run's telemetry.json (written by a
        JEPSEN_TELEMETRY=1 run — see jepsen_tpu_torch/telemetry) as a
        spans-by-total-time table with counters and gauges, linking
        the raw JSON and the Perfetto-loadable trace.json."""
        root = os.path.realpath(self.store_dir)
        run_dir = os.path.realpath(os.path.join(root, rel.strip("/")))
        tpath = os.path.join(run_dir, "telemetry.json")
        if not (run_dir.startswith(root + os.sep)
                and os.path.isfile(tpath)):
            self._send(404, _page("404", "<p>no telemetry for this run"
                                         "</p>"))
            return
        try:
            with open(tpath) as f:
                summ = json.load(f)
        except (OSError, ValueError) as e:
            self._send(500, _page("error",
                                  f"<pre>{html.escape(repr(e))}</pre>"))
            return
        spans = sorted(
            (summ.get("spans") or {}).items(),
            key=lambda kv: kv[1].get("total_s", 0), reverse=True,
        )
        rows = "".join(
            f"<tr><td>{html.escape(name)}</td>"
            f"<td>{st.get('count')}</td>"
            f"<td>{st.get('total_s')}</td>"
            f"<td>{st.get('mean_s')}</td>"
            f"<td>{st.get('max_s')}</td></tr>"
            for name, st in spans
        )
        extras = []
        # Resilience counters (op timeouts, blown checker budgets,
        # degradation-ladder steps) get their own table above the
        # generic counters: a regression in robustness should be as
        # visible on this page as one in throughput.
        from . import telemetry

        counters = summ.get("counters") or {}
        resil = {
            k: v for k, v in counters.items()
            if any(k.startswith(p)
                   for p in telemetry.RESILIENCE_COUNTER_PREFIXES)
        }
        # Per-node availability (results["resilience"]["nodes"], written
        # by the health monitor when any node went suspect): state plus
        # the quarantine/re-admission timeline.
        node_health: dict = {}
        streaming: dict = {}
        try:
            tf = store.load(run_dir)
            try:
                results = tf.results or {}
                node_health = (
                    results.get("resilience") or {}
                ).get("nodes") or {}
                streaming = results.get("streaming") or {}
            finally:
                tf.close()
        except Exception:  # noqa: BLE001 — no stored results: skip
            node_health = {}
            streaming = {}
        if node_health:
            nrows = ""
            for n, d in sorted(node_health.items()):
                probes = d.get("probes") or {}
                timeline = ", ".join(
                    "{}→{} ({})".format(
                        e.get("from"), e.get("to"), e.get("reason")
                    )
                    for e in d.get("timeline") or []
                ) or "-"
                nrows += (
                    f"<tr><td>{html.escape(str(n))}</td>"
                    f"<td>{html.escape(str(d.get('state')))}</td>"
                    f"<td>{d.get('signals')}</td>"
                    f"<td>{probes.get('pass')}/{probes.get('fail')}</td>"
                    f"<td>{html.escape(timeline)}</td></tr>"
                )
            extras.append(
                "<h2>node availability</h2><table><tr><th>node</th>"
                "<th>state</th><th>signals</th><th>probes ok/fail</th>"
                "<th>timeline</th></tr>" + nrows + "</table>"
            )
        # Online-checking panel (results["streaming"], written by a
        # --streaming run): how far behind the run the verdict was.
        # Verdict lag is the subsystem's whole point, so it leads.
        if streaming:
            lag = streaming.get("verdict-lag-s")
            lag_txt = "?" if lag is None else f"{lag:.3f} s"
            keys = streaming.get("keys") or 0
            proven = streaming.get("proven-online") or 0
            srows = "".join(
                f"<tr><td>{html.escape(str(k))}</td>"
                f"<td>{html.escape(json.dumps(v))}</td></tr>"
                for k, v in sorted(streaming.items())
                if k != "verdict-lag-s"
            )
            extras.append(
                "<h2>online checking</h2>"
                f"<p><b>verdict lag: {lag_txt}</b> — "
                f"{proven}/{keys} keys proven online"
                + (" · <b>broken:</b> "
                   + html.escape(str(streaming.get("broken")))
                   if streaming.get("broken") else "")
                + f"</p><table>{srows}</table>"
            )
        for title, d in (("resilience", resil),
                         ("counters", counters),
                         ("gauges", summ.get("gauges") or {})):
            if d:
                items = "".join(
                    f"<tr><td>{html.escape(str(k))}</td>"
                    f"<td>{html.escape(json.dumps(v))}</td></tr>"
                    for k, v in sorted(d.items())
                )
                extras.append(f"<h2>{title}</h2><table>{items}</table>")
        q = urllib.parse.quote(rel.strip("/"))
        links = (
            f"<p><a href='/files/{q}/telemetry.json'>telemetry.json"
            f"</a> · <a href='/files/{q}/trace.json'>trace.json</a> "
            f"(load in <a href='https://ui.perfetto.dev'>Perfetto</a>)"
            f"</p>"
        )
        body = (
            links
            + "<h2>spans</h2><table><tr><th>span</th><th>count</th>"
              "<th>total s</th><th>mean s</th><th>max s</th></tr>"
            + rows + "</table>" + "".join(extras)
        )
        self._send(200, _page(f"telemetry: {rel}", body))

    def _search(self, rel: str) -> None:
        """Coverage-growth panel for a `jepsen search` dir: the
        search.json checkpoint's per-iteration coverage as inline
        bars, the nemesis.search.* counters, and the shrunk
        reproducer cells with links into corpus/cells files."""
        root = os.path.realpath(self.store_dir)
        search_dir = os.path.realpath(os.path.join(root, rel.strip("/")))
        spath = os.path.join(search_dir, "search.json")
        if not (search_dir.startswith(root + os.sep)
                and os.path.isfile(spath)):
            self._send(404, _page("404", "<p>no search state here</p>"))
            return
        try:
            with open(spath) as f:
                state = json.load(f)
        except (OSError, ValueError) as e:
            self._send(500, _page("error",
                                  f"<pre>{html.escape(repr(e))}</pre>"))
            return
        q = urllib.parse.quote(rel.strip("/"))
        iters = state.get("iterations") or []
        peak = max((h.get("coverage") or 0 for h in iters), default=1)
        irows = ""
        for h in iters:
            cov = h.get("coverage") or 0
            width = int(300 * cov / max(1, peak))
            why = ", ".join(h.get("interesting") or []) or "-"
            irows += (
                f"<tr><td>{h.get('i')}</td>"
                f"<td>{html.escape(str(h.get('label')))}</td>"
                f"<td>{h.get('events')}</td>"
                f"<td>{html.escape(','.join(h.get('families') or []))}"
                f"</td><td>+{h.get('new_features')}</td>"
                f"<td><div style='background:#47a;height:0.8em;"
                f"width:{width}px;display:inline-block'></div> "
                f"{cov}</td>"
                f"<td>{html.escape(why)}</td></tr>"
            )
        crows = "".join(
            f"<tr><td><a href='/files/{q}/cells/"
            f"{urllib.parse.quote(c.get('name', ''))}.json'>"
            f"{html.escape(str(c.get('name')))}</a></td>"
            f"<td>{html.escape(str(c.get('reason')))}</td>"
            f"<td>{c.get('events')}</td><td>{c.get('from_events')}</td>"
            f"<td>{c.get('shrink_runs')}</td></tr>"
            for c in state.get("cells") or []
        )
        counters = state.get("counters") or {}
        overview = [
            ("families", ", ".join(state.get("families") or [])),
            ("seed", state.get("seed")),
            ("nodes / floor",
             f"{state.get('n_nodes')} / {state.get('min_nodes')}"),
            ("budget s", state.get("budget_s")),
            ("coverage features", state.get("coverage")),
            ("corpus entries", len(state.get("corpus") or [])),
        ] + sorted(counters.items())
        orows = "".join(
            f"<tr><td>{html.escape(str(k))}</td>"
            f"<td>{html.escape(str(v))}</td></tr>"
            for k, v in overview
        )
        body = (
            f"<p><a href='/files/{q}/search.json'>search.json</a> · "
            f"<a href='/files/{q}/corpus/'>corpus</a> · "
            f"<a href='/files/{q}/cells/'>cells</a> · "
            f"<a href='/files/{q}/runs/'>runs</a></p>"
            f"<table>{orows}</table>"
            + (
                "<h2>shrunk reproducers</h2><table><tr><th>cell</th>"
                "<th>reason</th><th>events</th><th>from</th>"
                "<th>shrink runs</th></tr>" + crows + "</table>"
                if crows else "<p>no reproducer cells yet</p>"
            )
            + "<h2>coverage growth</h2><table><tr><th>#</th>"
              "<th>label</th><th>events</th><th>families</th>"
              "<th>new</th><th>coverage</th><th>interesting</th></tr>"
            + irows + "</table>"
        )
        self._send(200, _page(f"fault search: {rel}", body))

    def _zip(self, rel: str) -> None:
        """Streams a test dir as a zip (web.clj's zip download).  Built
        in a spooled temp file (large runs would double in RSS as a
        BytesIO) and each member is realpath-checked like _file so a
        symlink inside a run dir can't pull outside files into the
        archive."""
        import shutil
        import tempfile
        import zipfile

        root = os.path.realpath(self.store_dir)
        target = os.path.realpath(os.path.join(root, rel.strip("/")))
        if not (target.startswith(root + os.sep) and os.path.isdir(target)):
            self._send(404, _page("404", "<p>not found</p>"))
            return
        with tempfile.TemporaryFile() as buf:
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
                for dirpath, _dirs, files in os.walk(target):
                    for fn in files:
                        full = os.path.join(dirpath, fn)
                        real = os.path.realpath(full)
                        if not real.startswith(root + os.sep):
                            continue  # symlink escaping the store
                        z.write(real, os.path.relpath(full, target))
            size = buf.tell()
            buf.seek(0)
            self.send_response(200)
            self.send_header("Content-Type", "application/zip")
            self.send_header("Content-Length", str(size))
            self.end_headers()
            shutil.copyfileobj(buf, self.wfile)

    def _file(self, rel: str) -> None:
        # Resolve inside the store dir only.
        root = os.path.realpath(self.store_dir)
        target = os.path.realpath(os.path.join(root, rel))
        if not target.startswith(root + os.sep) and target != root:
            self._send(403, _page("403", "<p>forbidden</p>"))
            return
        if os.path.isdir(target):
            entries = []
            for e in sorted(os.listdir(target)):
                q = urllib.parse.quote(os.path.join(rel, e).strip("/"))
                entries.append(f"<li><a href='/files/{q}'>{html.escape(e)}</a></li>")
            self._send(200, _page(rel or "store", f"<ul>{''.join(entries)}</ul>"))
        elif os.path.isfile(target):
            with open(target, "rb") as f:
                data = f.read()
            ctype = (
                "application/json"
                if target.endswith(".json")
                else "text/plain; charset=utf-8"
            )
            self._send(200, data, ctype)
        else:
            self._send(404, _page("404", "<p>not found</p>"))


def make_server(
    store_dir: str = "store", host: str = "127.0.0.1", port: int = 8080
) -> http.server.ThreadingHTTPServer:
    handler = type("BoundHandler", (Handler,), {"store_dir": store_dir})
    return http.server.ThreadingHTTPServer((host, port), handler)


def serve(store_dir: str = "store", *, host: str = "0.0.0.0", port: int = 8080) -> None:
    srv = make_server(store_dir, host, port)
    log.info("serving %s on http://%s:%d/", store_dir, host, port)
    print(f"Serving {store_dir} on http://{host}:{port}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
