"""`device.exact_float32` under threads and under torch's two TF32 APIs.

The search paths hash configurations with float32 products inside
`exact_float32`, and the many-key checker runs searches in worker
threads, so the block must hold full precision in every thread that is
inside it and give the caller's setting back only when the last thread
leaves — whichever API the caller used to set it."""

import threading

import pytest
import torch

from jepsen_tpu_torch import device as D

MATMUL = torch.backends.cuda.matmul


def _tf32_on() -> bool:
    """Whether CUDA float32 products may use TF32 right now."""
    if hasattr(MATMUL, "fp32_precision"):
        return MATMUL.fp32_precision == "tf32"
    return bool(MATMUL.allow_tf32)


@pytest.fixture
def restore_tf32():
    """Leaves the process-wide setting as the test found it."""
    new_api = hasattr(MATMUL, "fp32_precision")
    prev = MATMUL.fp32_precision if new_api else MATMUL.allow_tf32
    yield
    if new_api:
        MATMUL.fp32_precision = prev
    else:
        MATMUL.allow_tf32 = prev


def test_overlapping_threads_keep_tf32_off_and_restore_the_caller(
        restore_tf32):
    MATMUL.allow_tf32 = True
    a_in, b_in, a_out, b_done = (threading.Event() for _ in range(4))
    seen: dict = {}

    def first():
        with D.exact_float32():
            seen["a_entry"] = _tf32_on()
            a_in.set()
            assert b_in.wait(10)
        a_out.set()

    def second():
        assert a_in.wait(10)
        with D.exact_float32():
            seen["b_entry"] = _tf32_on()
            b_in.set()
            # The first thread leaves while this one is still inside.
            assert a_out.wait(10)
            seen["b_after_a_left"] = _tf32_on()
        b_done.set()

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert b_done.is_set()
    assert seen == {"a_entry": False, "b_entry": False,
                    "b_after_a_left": False}
    assert MATMUL.allow_tf32 is True


def test_new_tf32_api_is_pinned_and_restored(restore_tf32):
    if not hasattr(MATMUL, "fp32_precision"):
        pytest.skip("this torch has only the legacy allow_tf32 API")
    MATMUL.fp32_precision = "tf32"
    with D.exact_float32():
        assert MATMUL.fp32_precision == "ieee"
        with D.exact_float32():  # nested entries count too
            assert MATMUL.fp32_precision == "ieee"
        assert MATMUL.fp32_precision == "ieee"
    assert MATMUL.fp32_precision == "tf32"


def test_block_restores_after_an_exception(restore_tf32):
    MATMUL.allow_tf32 = True
    with pytest.raises(KeyError):
        with D.exact_float32():
            assert not _tf32_on()
            raise KeyError("x")
    assert MATMUL.allow_tf32 is True
    assert D._tf32_depth == 0


def test_many_threads_never_see_tf32_inside(restore_tf32):
    """A stress run with more threads than cores: no thread inside the
    block ever sees TF32 on, and the caller's setting comes back."""
    import sys

    MATMUL.allow_tf32 = True
    bad = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with D.exact_float32():
                    if _tf32_on():
                        bad.append(1)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not bad
    assert MATMUL.allow_tf32 is True
