"""The benchmark of `jepsen_tpu_torch`, the PyTorch and CUDA port.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` once on the CUDA card and prints one
JSON line.  Everything a cell needs is found by name:

  * `configs/<config>.json`  — the deployment: the checker entry that
    the window drives, the shape of each key's history, the guarantee;
  * `traffic/<mix>.json`     — the mix: key count, planted violations,
    pool size, the checks the profiled slice covers;
  * `entries/<entry>.py`     — builds the port's checker and runs one
    check (the only files here that import the port);
  * `metrics/<metric>.py`    — one reader per metric, end-to-end or
    per-layer, over the run's readings.

`generate.py` (the traffic generator), `reference/` (the plain
linearizability decider that decides `correct`), `roofline.py` (the
byte count and the data-sheet peak) and `trace.py` (spans and the
profiler's trace, reduced to readings) are the yardstick; the port's
own copies are not read.  Nothing here imports JAX or `jepsen_tpu`.
"""
