"""The port's web dashboard (web.py) and `repl.py` on the CPU.

tests/test_core.py's `test_web_index_and_files` and
`test_web_zip_download` run through `jepsen_tpu_torch`
(tests/torch_ported.py).  Then one store (a stored run with its
telemetry, a monitor's series, a fleet registry with a tenant) is
copied, and each package's server serves its own copy: every page is
byte-identical once the store root is replaced, the zip holds the same
members, and the SSE route delivers a payload within a read deadline.
"""

import io
import json
import os
import shutil
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import zipfile

import pytest

import torch_ported

CORE = torch_ported.load("test_core")
WEB_CASES = ["test_web_index_and_files", "test_web_zip_download"]


@pytest.mark.parametrize("case", WEB_CASES)
def test_web_cases_through_the_port(case, request):
    torch_ported.run(CORE, case, request)


def test_web_case_list():
    assert set(WEB_CASES) <= set(torch_ported.cases(CORE))


def _store(tmp_path, monkeypatch) -> str:
    """A store root holding one stored run (with telemetry.json), a
    monitor's series under mon/, and a fleet registry under fleet/."""
    from jepsen_tpu_torch import core, device as D, telemetry
    from jepsen_tpu_torch.monitor import MonitorConfig, run_monitor
    from jepsen_tpu_torch.monitor import fleet

    resolve = D.resolve
    monkeypatch.setattr(D, "resolve", lambda device="cuda": resolve("cpu"))
    was = telemetry.enabled()
    telemetry.enable(True)
    try:
        core.run(CORE.register_test(tmp_path))
    finally:
        telemetry.enable(was)
    root = str(tmp_path / "store")
    run_monitor(MonitorConfig(store_dir=os.path.join(root, "mon"),
                              device="cpu", rate=1e6, max_ops=2000,
                              cadence_s=0.05, keys=2, advance_rows=256))
    froot = os.path.join(root, "fleet")
    reg = fleet.FleetRegistry(froot)
    reg.add(fleet.TenantSpec(name="t1", suite="kvdb", nodes=("n1",)))
    reg.add(fleet.TenantSpec(name="t2", suite="logd"))
    tstore = fleet.tenant_store_dir(froot, "t1")
    shutil.copytree(os.path.join(root, "mon"), tstore)
    fleet._atomic_json(os.path.join(froot, fleet.FLEET_STATUS), {
        "t": 1.0, "root": froot, "endpoint": None,
        "tenants": {"t1": {"state": "running", "alive": True,
                           "restarts": 1}}})
    return root


def _serve(web, root):
    srv = web.make_server(root, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=15) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_pages_are_byte_identical_to_the_references(tmp_path, monkeypatch):
    from jepsen_tpu import web as ref_web
    from jepsen_tpu.telemetry import slo as ref_slo
    from jepsen_tpu_torch import store, web
    from jepsen_tpu_torch.telemetry import slo

    port_root = _store(tmp_path, monkeypatch)
    ref_root = str(tmp_path / "ref-store")
    shutil.copytree(port_root, ref_root, symlinks=True,
                    copy_function=shutil.copy2)
    run = store.latest(port_root)
    rel = urllib.parse.quote(os.path.relpath(run, port_root))
    assert os.path.isfile(os.path.join(run, "telemetry.json"))
    ref_slo.reset()
    slo.reset()
    routes = ["/", f"/files/{rel}/", f"/files/{rel}/history.txt",
              f"/files/{rel}/telemetry.json", f"/telemetry/{rel}",
              "/monitor?dir=mon", "/monitor?dir=fleet", "/api/series?dir=mon",
              "/api/series?dir=mon&name=monitor.ops-per-s&limit=5",
              "/api/fleet?dir=fleet", "/files/..%2F..%2Fetc%2Fpasswd",
              "/telemetry/nope", "/nope", "/search/nope"]
    servers = []
    try:
        ref_srv, ref_base = _serve(ref_web, ref_root)
        servers.append(ref_srv)
        port_srv, port_base = _serve(web, port_root)
        servers.append(port_srv)
        for route in routes:
            rc, ref_body = _get(ref_base + route)
            pc, port_body = _get(port_base + route)
            assert pc == rc, route
            want = ref_body.replace(os.path.realpath(ref_root).encode(),
                                    os.path.realpath(port_root).encode())
            want = want.replace(ref_root.encode(), port_root.encode())
            assert port_body == want, route
        status = {r: _get(port_base + r)[0] for r in routes}
        assert [r for r in routes[:10] if status[r] != 200] == []
        assert b"register-smoke" in _get(port_base + "/")[1]
        # The zip: the same members with the same bytes.
        zips = []
        for base in (ref_base, port_base):
            code, data = _get(f"{base}/zip/{rel}")
            assert code == 200
            z = zipfile.ZipFile(io.BytesIO(data))
            zips.append({n: z.read(n) for n in z.namelist()})
        assert zips[0] == zips[1] and "history.txt" in zips[1]
        fleet = json.loads(_get(port_base + "/api/fleet?dir=fleet")[1])
        assert sorted(fleet["tenants"]) == ["t1", "t2"]
        assert fleet["tenants"]["t1"]["supervisor"]["restarts"] == 1
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def test_the_series_stream_delivers_a_payload(tmp_path):
    """/api/series/stream tails the tier-0 file: a sample appended after
    the connection opens arrives as one `data:` event, read under a
    deadline."""
    from jepsen_tpu_torch import web
    from jepsen_tpu_torch.telemetry import timeseries

    root = str(tmp_path)
    st = timeseries.SeriesStore(root)
    st.append({"monitor.ops-per-s": 1.0}, t=1000.0)
    srv, base = _serve(web, root)
    try:
        resp = urllib.request.urlopen(base + "/api/series/stream",
                                      timeout=10)
        try:
            time.sleep(0.2)
            st.append({"monitor.ops-per-s": 2.0}, t=1001.0)
            deadline = time.monotonic() + 10
            payload = None
            while payload is None and time.monotonic() < deadline:
                line = resp.readline()
                if line.startswith(b"data:"):
                    payload = json.loads(line[5:])
            assert payload == {"t": 1001.0, "s": {"monitor.ops-per-s": 2.0}}
        finally:
            resp.close()
    finally:
        st.close()
        srv.shutdown()
        srv.server_close()


def test_serve_through_the_suite_cli(tmp_path):
    """`kvdb serve` as a process answers `/` and stops on SIGTERM."""
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    (tmp_path / "store").mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.suites.kvdb", "serve",
         "--store-dir", str(tmp_path / "store"), "--host", "127.0.0.1",
         "--port", str(port)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                code, body = _get(f"http://127.0.0.1:{port}/")
                break
            except OSError:
                assert proc.poll() is None, "serve exited"
                assert time.monotonic() < deadline, "serve never listened"
                time.sleep(0.2)
        assert code == 200 and b"jepsen-tpu store" in body
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_repl_exports_what_the_references_does():
    import jepsen_tpu.repl as ref
    import jepsen_tpu_torch.repl as port

    names = {n for n in vars(ref) if not n.startswith("_")}
    assert names == {n for n in vars(port) if not n.startswith("_")}
    assert port.web.__name__ == "jepsen_tpu_torch.web"
    assert port.KV.__module__.startswith("jepsen_tpu_torch.")
