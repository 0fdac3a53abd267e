"""The witness, the stream witness and the queue models through the port
on the CPU: the cases of tests/test_wgl_witness.py, tests/test_wgl_stream.py,
tests/test_queue_packed.py and tests/test_wgl_pallas.py through
`jepsen_tpu_torch` (tests/torch_ported.py), with test_wgl_witness.py's
`pm` fixture on the port's model.  test_wgl_witness.py's
`test_ladder_budget_shrinks_per_rung` runs about 60 s in either
package; test_wgl_event.py's long case lives in
tests/test_torch_wgl_cpu.py, so the two land on different test workers.
The slow 10k-op regression runs under `-m slow`.

Left out, each a case that calls a JAX internal (a `jax_step` or
`jax_step_rows`, the `pallas=` mode switch, `_make_chunk_fn`, or the
Pallas interpret or fallback switch), with the port's test that holds
its counterpart:

tests/test_wgl_stream.py
- `test_stream_model_reset_semantics` (`jax_step`):
  tests/test_torch_stream.py::test_stream_model_reset_semantics, RESET
  in `torch_step` and `torch_step_rows` against the reference's steps.
- `test_stream_rows_step_reset_is_mosaic_shaped` (`jax_step_rows`): the
  same test, and tests/test_torch_witness_sweep.py's stream
  instantiations against the plain sweep.

tests/test_queue_packed.py
- `test_py_jax_step_parity`, `test_fifo_py_jax_parity` (`jax_step`):
  tests/test_torch_models_more.py::test_torch_step_matches_vmap_jax_step
  and ::test_py_step_matches_reference, for both queue models.

tests/test_wgl_pallas.py (every case calls one)
- `test_interpret_parity_cas` (4 cases), `test_interpret_parity_plain_register`
  (`pallas=`): tests/test_torch_witness.py::test_witness_parity_pallas_corpus
  (the same four histories, the port's witness against the reference's)
  and ::test_witness_parity_plain_register; the sweep alone,
  tests/test_torch_witness_sweep.py::test_sweep_plain_matches_pallas_interpret.
- `test_interpret_parity_invalid_dies_both_ways` (`pallas=`):
  tests/test_torch_witness.py::test_witness_invalid_dies_at_same_rank.
- `test_multi_register_rows_step_parity`,
  `test_mutex_rows_step_parity_and_witness`,
  `test_unordered_queue_rows_step_parity_and_witness`,
  `test_fifo_queue_rows_step_parity_and_witness` (`jax_step_rows`):
  tests/test_torch_models_more.py::test_torch_step_rows_matches_jax_step_rows
  and tests/test_torch_witness_sweep.py::test_every_model_matches_the_reference_sweep.
- `test_pallas_runtime_failure_falls_back_to_scan`,
  `test_pallas_build_failure_falls_back_to_scan`,
  `test_pallas_build_failure_off_mode_raises` (`_make_chunk_fn`, the
  fallback switch): the port has no fallback path; a kernel that does
  not build or launch raises,
  tests/test_torch_linearizable.py::test_kernel_launch_error_propagates_through_the_checker.
- `test_models_without_rows_step_fall_back` (`jax_step_rows=None`, the
  interpret switch): every port model has `torch_step_rows`,
  tests/test_torch_witness_sweep.py::test_batch_model_every_model_matches_plain.
"""

import pytest
import torch

import torch_ported
from jepsen_tpu_torch.models import cas_register

WITNESS = torch_ported.load("test_wgl_witness")
STREAM = torch_ported.load("test_wgl_stream")
QUEUE = torch_ported.load("test_queue_packed")
PALLAS = torch_ported.load("test_wgl_pallas")

LEFT_OUT = {
    STREAM: ("test_stream_model_reset_semantics",
             "test_stream_rows_step_reset_is_mosaic_shaped"),
    QUEUE: ("test_py_jax_step_parity", "test_fifo_py_jax_parity"),
    PALLAS: tuple(torch_ported.cases(PALLAS)),
}
MODULES = (WITNESS, STREAM, QUEUE, PALLAS)


def _cases(m, slow=False):
    left = LEFT_OUT.get(m, ())
    return [c for c in torch_ported.cases(m, slow=slow)
            if c not in left and c.partition("[")[0] not in left]


@pytest.fixture(autouse=True)
def _one_thread():
    """The ladder cases run the CPU device search under a checker
    budget: one torch thread, as the other such files do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pm():
    """test_wgl_witness.py's fixture, on the port's model."""
    return cas_register().packed()


def _ids(x):
    return x if isinstance(x, str) else x.__name__[len("ported_"):]


@pytest.mark.parametrize(
    "mod, case", [(m, c) for m in MODULES for c in _cases(m)], ids=_ids)
def test_reference_cases_through_the_port(mod, case, request):
    torch_ported.run(mod, case, request)


@pytest.mark.slow
@pytest.mark.parametrize(
    "mod, case", [(m, c) for m in MODULES for c in _cases(m, slow=True)],
    ids=_ids)
def test_slow_reference_cases_through_the_port(mod, case, request):
    torch_ported.run(mod, case, request)


def test_every_case_is_run_or_named():
    """Each file's cases: those run here, and the ones left out by name
    above (all of test_wgl_pallas.py's 14)."""
    assert {m.__name__: (len(_cases(m)), len(_cases(m, slow=True)),
                         len(torch_ported.cases(m)))
            for m in MODULES} == {
        "ported_test_wgl_witness": (16, 1, 16),
        "ported_test_wgl_stream": (12, 0, 14),
        "ported_test_queue_packed": (7, 0, 9),
        "ported_test_wgl_pallas": (0, 0, 14)}
    assert len(LEFT_OUT[PALLAS]) == 14
