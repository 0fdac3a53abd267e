"""Learned cost model over the per-pass profile store.

The port's copy of `jepsen_tpu/plan/costmodel.py`, unchanged in
behaviour, so a model file either package fitted and saved gives the
same predictions and the same knobs in the other.  The profile store
(telemetry/profile.py, `profiles.jsonl`) records every checking pass
with its shape features, plan knobs and measured time; `fit` trains a
small per-pass ridge regressor over log-transformed shape and knob
features predicting log cost, `CostModel.save` writes it as JSON, and
at run time the compiler asks the `choose_*` functions for knobs.  A
model loads only from a local file (`set_model_path` or
`JEPSEN_COSTMODEL`).

The contract with correctness: knobs and tier order are performance
choices — every pass family is sound in its declared direction whatever
the knobs — so a bad model can only waste time, never flip a verdict.
The hand heuristics (the hand-wired ladder's exact formulas: ~K/8 stream
segments, `max(8, K//2)` restarts, beam-32 batched starts, 2,048 x 32
witness blocks, half the high-water mark for finalize chunks) are the
explicit fallback whenever no model is loaded, the model lacks the
pass, or prediction fails.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
from typing import Iterable, Optional

log = logging.getLogger(__name__)

MODEL_ENV = "JEPSEN_COSTMODEL"
MODEL_VERSION = 1

#: Minimum records per pass before a fit is trusted.
MIN_SAMPLES = 4


# ---------------------------------------------------------------------------
# Hand heuristics — the untrained fallback, verbatim from the ladder.
# ---------------------------------------------------------------------------


def heuristic_stream_knobs(n_keys: int) -> dict:
    """The hand formulas from ops/wgl_stream.py: first-pass spans
    every key, post-death segments ~K/8, restart cap half the keys."""
    return {
        "segment": max(8, -(-n_keys // 8)),
        "max_restarts": max(8, n_keys // 2),
    }


def heuristic_batched_knobs(beam: int) -> dict:
    """parallel/independent.py's batched start: the kernel's smallest
    beam bucket so narrow keys settle in cheap passes."""
    return {"beam": min(beam, 32)}


def heuristic_witness_block_knobs() -> dict:
    """The witness chunk shape when no trained model covers the pass:
    2048 bars/block x 32 blocks/call (the JAX package's measured
    default on its TPU; the port keeps it so the two plan blocks
    alike)."""
    return {"bars_per_block": 2048, "blocks_per_call": 32}


def _candidate_witness_blocks() -> list:
    """Witness block-shape grid (bars/block x blocks/call); the chooser
    ranks only those the trained witness predictor has support for."""
    return [(512, 32), (1024, 32), (1024, 64),
            (2048, 16), (2048, 32), (4096, 16)]


def choose_witness_block_knobs(n_ops: int, n_ok: int,
                               model: "Optional[CostModel]" = None
                               ) -> tuple:
    """(knobs, source) for the witness chunk shape
    ({bars_per_block, blocks_per_call}): model-argmin over the bucket
    grid when a trained witness predictor covers the candidates, else
    the measured heuristic default."""
    heur = heuristic_witness_block_knobs()
    if model is None:
        model = active_model()
    if model is None or not model.has("witness"):
        return heur, "heuristic"
    feats = {"ops": n_ops, "ok": n_ok}
    best, best_cost = None, None
    for bars, nb in _candidate_witness_blocks():
        knobs = {"bars_per_block": bars, "blocks_per_call": nb}
        if not _in_support(model, "witness", knobs, heur):
            continue
        cost = model.predict_s("witness", feats, knobs)
        if cost is None:
            return heur, "heuristic"
        if best_cost is None or cost < best_cost:
            best, best_cost = knobs, cost
    return (best, "model") if best else (heur, "heuristic")


#: Floor for streaming-finalize chunk rows.
FINALIZE_MIN_ROWS = 192


def heuristic_finalize_rows(hwm: int) -> int:
    """The streaming finalize's hand formula: chunks capped at half
    the high-water mark the mid-run stream batches reached, floored at
    192 rows."""
    return max(FINALIZE_MIN_ROWS, int(hwm) // 2)


# ---------------------------------------------------------------------------
# Featurization
# ---------------------------------------------------------------------------

#: Shape features (from record["features"]) and knobs (from
#: record["plan"]) the regressor may see, all log1p-transformed.
#: Unknown keys are ignored; missing ones contribute 0 — schema drift
#: between client- and daemon-side records degrades gracefully.
SHAPE_KEYS = ("keys", "ops", "ok")
KNOB_KEYS = ("segment", "max_restarts", "beam", "max_beam", "block")


#: Cost features a v2 profile record can contribute: log-scaled like
#: everything else, and absent (0.0 via x.get default) when the record's
#: cost block is null — as the port's are — so mixed stores train and
#: predict without special-casing.
COST_KEYS = ("flops", "bytes_accessed")


def featurize(features: dict, plan: dict,
              cost: Optional[dict] = None) -> dict[str, float]:
    x: dict[str, float] = {}
    cvals: dict[str, float] = {}
    for k in COST_KEYS:
        v = (cost or {}).get(k)
        if isinstance(v, (int, float)) and v >= 0:
            cvals[k] = float(v)
            x[f"log_{k}"] = math.log1p(float(v))
    if cvals.get("bytes_accessed"):
        x["log_intensity"] = math.log1p(
            cvals.get("flops", 0.0) / cvals["bytes_accessed"])
    for k in SHAPE_KEYS:
        v = features.get(k)
        if isinstance(v, (int, float)) and v >= 0:
            x[f"log_{k}"] = math.log1p(float(v))
    ks = features.get("keys")
    ops = features.get("ops")
    if isinstance(ks, (int, float)) and isinstance(ops, (int, float)) \
            and ks and ks > 0:
        x["log_ops_per_key"] = math.log1p(float(ops) / float(ks))
    for k in KNOB_KEYS:
        v = plan.get(k)
        if isinstance(v, (int, float)) and v >= 0:
            lv = math.log1p(float(v))
            x[f"log_knob_{k}"] = lv
            # The squared term lets the fit bend: knob cost curves are
            # U-shaped (tiny segments pay per-restart overhead, huge
            # ones pay per-death replay), and a purely linear-in-log
            # model could only ever pick an endpoint of the grid.
            x[f"log_knob_{k}_sq"] = lv * lv
    return x


def record_cost_s(rec: dict) -> float:
    """Cost target: device execute seconds, falling back to wall
    total."""
    t = rec.get("timing") or {}
    ex = t.get("execute_s") or 0.0
    return float(ex if ex > 0 else t.get("total_s") or 0.0)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class CostModel:
    """Per-pass linear predictors over the featurized records.
    `passes[name] = {"names": [...], "coef": [...], "n": int}` with an
    implicit intercept at coef[0]."""

    def __init__(self, passes: dict[str, dict], *, meta: Optional[dict] = None):
        self.passes = passes
        self.meta = dict(meta or {})

    # -- inference ----------------------------------------------------------

    def has(self, pass_name: str) -> bool:
        return pass_name in self.passes

    def predict_s(self, pass_name: str, features: dict,
                  plan: dict, cost: Optional[dict] = None
                  ) -> Optional[float]:
        p = self.passes.get(pass_name)
        if p is None:
            return None
        try:
            x = featurize(features, plan, cost)
            coef = p["coef"]
            y = float(coef[0])
            for name, c in zip(p["names"], coef[1:]):
                y += float(c) * x.get(name, 0.0)
            # Target is log1p(cost): invert, clamp to sane seconds.
            cost = math.expm1(min(y, 25.0))
            return max(cost, 0.0)
        except (KeyError, TypeError, ValueError, IndexError):
            return None

    # -- persistence --------------------------------------------------------

    def to_dict(self) -> dict:
        return {"v": MODEL_VERSION, "meta": self.meta,
                "passes": self.passes}

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> Optional["CostModel"]:
        """None on any problem — a broken model file must degrade to
        the heuristics, never break checking."""
        try:
            with open(path) as f:
                d = json.load(f)
            if not isinstance(d, dict) or d.get("v") != MODEL_VERSION:
                log.warning("cost model %s: unsupported version %r",
                            path, d.get("v") if isinstance(d, dict) else d)
                return None
            passes = d.get("passes")
            if not isinstance(passes, dict):
                return None
            return cls(passes, meta=d.get("meta") or {})
        except (OSError, ValueError) as e:
            log.warning("cost model %s unreadable: %r", path, e)
            return None


def fit(records: Iterable[dict], *,
        min_samples: int = MIN_SAMPLES) -> CostModel:
    """Ridge-fits one predictor per pass name over the records.  Pure
    numpy; passes with too few intact records are skipped (the runtime
    then falls back to the heuristics for them)."""
    import numpy as np

    by_pass: dict[str, list[tuple[dict[str, float], float]]] = {}
    support: dict[str, dict[str, list[float]]] = {}
    shape_support: dict[str, dict[str, list[float]]] = {}
    for rec in records:
        name = rec.get("pass") or "unknown"
        cost = record_cost_s(rec)
        if cost < 0:
            continue
        plan = rec.get("plan") or {}
        feats = rec.get("features") or {}
        rec_cost = rec.get("cost")
        x = featurize(feats, plan,
                      rec_cost if isinstance(rec_cost, dict) else None)
        by_pass.setdefault(name, []).append((x, cost))
        sup = support.setdefault(name, {})
        for k in KNOB_KEYS:
            v = plan.get(k)
            if isinstance(v, (int, float)) and v >= 0:
                lo, hi = sup.get(k, (v, v))
                sup[k] = [min(lo, float(v)), max(hi, float(v))]
        ssup = shape_support.setdefault(name, {})
        for k in SHAPE_KEYS:
            v = feats.get(k)
            if isinstance(v, (int, float)) and v >= 0:
                lo, hi = ssup.get(k, (v, v))
                ssup[k] = [min(lo, float(v)), max(hi, float(v))]

    passes: dict[str, dict] = {}
    for name, rows in by_pass.items():
        if len(rows) < min_samples:
            continue
        names = sorted({k for x, _ in rows for k in x})
        if not names:
            continue
        X = np.array(
            [[1.0] + [x.get(n, 0.0) for n in names] for x, _ in rows]
        )
        y = np.array([math.log1p(c) for _, c in rows])
        # Ridge via augmented rows: tiny L2 keeps collinear knob
        # features (e.g. segment == f(keys) in heuristic-only stores)
        # from blowing up the solve.
        lam = 1e-3
        aug = math.sqrt(lam) * np.eye(X.shape[1])
        aug[0, 0] = 0.0  # never shrink the intercept
        Xa = np.vstack([X, aug])
        ya = np.concatenate([y, np.zeros(X.shape[1])])
        coef, *_ = np.linalg.lstsq(Xa, ya, rcond=None)
        pred = X @ coef
        rmse = float(np.sqrt(np.mean((pred - y) ** 2)))
        passes[name] = {
            "names": names,
            "coef": [float(c) for c in coef],
            "n": len(rows),
            "rmse_log": round(rmse, 6),
            # Observed knob ranges: the choosers never rank a knob
            # value the training data has no support for — a linear
            # fit extrapolates confidently and wrongly.
            "support": support.get(name, {}),
            # Observed SHAPE buckets (keys/ops/ok ranges): the
            # finalize-chunk chooser only ranks chunk sizes whose
            # per-chunk shape the store has actually recorded.
            # Additive field — models without it simply keep every
            # shape-gated chooser on the hand formulas.
            "shape_support": shape_support.get(name, {}),
        }
    return CostModel(passes)


# ---------------------------------------------------------------------------
# The active model (process-wide, lazily loaded)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_model: Optional[CostModel] = None
_model_path: Optional[str] = None
_loaded = False


def set_model_path(path: Optional[str]) -> None:
    """Points the process at a local model file (None reverts to the
    heuristics).  The env var JEPSEN_COSTMODEL is the other spelling."""
    global _model, _model_path, _loaded
    with _lock:
        _model_path = path
        _model = None
        _loaded = False


def active_model() -> Optional[CostModel]:
    """The loaded model, or None (the heuristics): none is set, or
    `JEPSEN_PLAN=0`."""
    global _model, _loaded
    from . import enabled

    if not enabled():
        return None
    with _lock:
        if not _loaded:
            path = _model_path or os.environ.get(MODEL_ENV)
            _model = CostModel.load(path) if path else None
            _loaded = True
        return _model


def model_info() -> dict:
    """Status line: whether a model is loaded, its passes and sample
    counts."""
    m = active_model()
    if m is None:
        return {"loaded": False, "fallback": "heuristic"}
    return {
        "loaded": True,
        "passes": sorted(m.passes),
        "samples": {k: v.get("n") for k, v in m.passes.items()},
    }


# ---------------------------------------------------------------------------
# Knob choice — model when trained, heuristics otherwise.
# ---------------------------------------------------------------------------


def _candidate_segments(n_keys: int) -> list[int]:
    h = heuristic_stream_knobs(n_keys)["segment"]
    cands = {h, max(1, -(-n_keys // 4)), max(1, -(-n_keys // 16)),
             2, max(1, n_keys)}
    return sorted(c for c in cands if 1 <= c <= max(1, n_keys))


def _candidate_restarts(n_keys: int) -> list[int]:
    h = heuristic_stream_knobs(n_keys)["max_restarts"]
    return sorted({h, max(8, n_keys // 4), max(8, n_keys)})


def _in_support(model: CostModel, pass_name: str, knobs: dict,
                heur: dict) -> bool:
    """A candidate is rankable iff every knob sits inside the pass's
    trained range; a knob the training data never recorded is only
    acceptable at its heuristic value (the fit extrapolates confidently
    and wrongly outside its support)."""
    sup = model.passes.get(pass_name, {}).get("support") or {}
    for k, v in knobs.items():
        rng = sup.get(k)
        if rng is None:
            if v != heur.get(k):
                return False
            continue
        try:
            lo, hi = float(rng[0]), float(rng[1])
        except (TypeError, ValueError, IndexError):
            return False
        if not lo <= float(v) <= hi:
            return False
    return True


def choose_stream_knobs(n_keys: int, n_ops: int,
                        model: Optional[CostModel] = None
                        ) -> tuple[dict, str]:
    """(knobs, source): stream segment size + restart cap, model-argmin
    over a bounded candidate grid when a trained predictor covers the
    stream pass, else the hand formulas."""
    if model is None:
        model = active_model()
    heur = heuristic_stream_knobs(n_keys)
    if model is None or not model.has("stream"):
        return heur, "heuristic"
    feats = {"keys": n_keys, "ops": n_ops}
    best, best_cost = None, None
    for seg in _candidate_segments(n_keys):
        for mr in _candidate_restarts(n_keys):
            knobs = {"segment": seg, "max_restarts": mr}
            if not _in_support(model, "stream", knobs, heur):
                continue
            cost = model.predict_s("stream", feats, knobs)
            if cost is None:
                return heur, "heuristic"
            if best_cost is None or cost < best_cost:
                best, best_cost = knobs, cost
    return (best, "model") if best else (heur, "heuristic")


def choose_batched_knobs(n_keys: int, n_ops: int, beam: int,
                         model: Optional[CostModel] = None
                         ) -> tuple[dict, str]:
    if model is None:
        model = active_model()
    heur = heuristic_batched_knobs(beam)
    if model is None or not model.has("batched"):
        return heur, "heuristic"
    feats = {"keys": n_keys, "ops": n_ops}
    best, best_cost = None, None
    for b in sorted({heur["beam"], 32, 64, min(128, beam), beam}):
        if b < 1 or not _in_support(model, "batched", {"beam": b}, heur):
            continue
        cost = model.predict_s("batched", feats, {"beam": b})
        if cost is None:
            return heur, "heuristic"
        if best_cost is None or cost < best_cost:
            best, best_cost = {"beam": b}, cost
    return (best, "model") if best else (heur, "heuristic")


def _shape_in_support(model: CostModel, pass_name: str,
                      feats: dict) -> bool:
    """True iff every shape feature sits inside the pass's recorded
    shape bucket range.  Models fitted before shape_support existed
    have no ranges -> nothing is rankable -> hand formulas hold."""
    sup = model.passes.get(pass_name, {}).get("shape_support") or {}
    if not sup:
        return False
    for k, v in feats.items():
        rng = sup.get(k)
        if rng is None:
            return False
        try:
            lo, hi = float(rng[0]), float(rng[1])
        except (TypeError, ValueError, IndexError):
            return False
        if not lo <= float(v) <= hi:
            return False
    return True


def _candidate_chunk_rows(hwm: int, total_rows: int) -> list[int]:
    """Finalize-chunk candidates: the two hand formulas plus
    power-of-two buckets up to the backlog (capped — a cap beyond the
    backlog is equivalent to one chunk)."""
    cands = {heuristic_finalize_rows(hwm),
             max(FINALIZE_MIN_ROWS, int(hwm) // 4)}
    b = 256
    while b <= max(total_rows, FINALIZE_MIN_ROWS) and b <= (1 << 16):
        cands.add(b)
        b *= 2
    return sorted(c for c in cands if c >= FINALIZE_MIN_ROWS)


def choose_finalize_chunk_rows(n_keys: int, total_rows: int, hwm: int,
                               model: Optional[CostModel] = None
                               ) -> tuple[int, str]:
    """(chunk_rows, source) for the streaming pipeline's finalize
    backlog: the generalization of the high-water-mark halving.  When
    the trained stream predictor has records whose
    shape buckets cover a candidate chunk size, the model ranks the
    candidates by predicted total finalize cost (per-chunk pass cost x
    number of chunks); out of support — or with no model at all — the
    hand `max(192, hwm // 2)` formula holds verbatim."""
    heur = heuristic_finalize_rows(hwm)
    if total_rows <= 0:
        return heur, "heuristic"
    if model is None:
        model = active_model()
    if model is None or not model.has("stream"):
        return heur, "heuristic"
    sknobs = heuristic_stream_knobs(n_keys)
    best, best_cost = None, None
    for cap in _candidate_chunk_rows(hwm, total_rows):
        n_chunks = max(1, -(-total_rows // cap))
        keys_per_chunk = max(1, -(-n_keys // n_chunks))
        feats = {"keys": keys_per_chunk, "ops": min(cap, total_rows)}
        if not _shape_in_support(model, "stream", feats):
            continue
        per = model.predict_s("stream", feats, sknobs)
        if per is None:
            return heur, "heuristic"
        cost = per * n_chunks
        if best_cost is None or cost < best_cost:
            best, best_cost = cap, cost
    return (best, "model") if best else (heur, "heuristic")


def choose_tier_order(n_keys: int, n_ops: int, stream_knobs: dict,
                      model: Optional[CostModel] = None) -> str:
    """"stream-first" (the default ladder) or "skip-stream" when the
    model predicts the witness stream costs more than twice the batched
    sweep it is supposed to short-circuit.  Sound either way: the
    stream only ever *proves* keys, every key it would have proven is
    still decided downstream by the exact tiers."""
    if model is None:
        model = active_model()
    if model is None or not model.has("stream") or not model.has("batched"):
        return "stream-first"
    feats = {"keys": n_keys, "ops": n_ops}
    s = model.predict_s("stream", feats, stream_knobs)
    b = model.predict_s("batched", feats,
                        heuristic_batched_knobs(32))
    if s is None or b is None:
        return "stream-first"
    return "skip-stream" if s > 2.0 * max(b, 1e-6) else "stream-first"
