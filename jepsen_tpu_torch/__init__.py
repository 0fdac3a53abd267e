"""jepsen_tpu_torch — the linearizability checker on PyTorch and CUDA.

A port of `jepsen_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
Module paths mirror the JAX package, so each function's counterpart
is found by name.  This package imports torch and numpy only: never
jax and nothing of `jepsen_tpu`; what it needs of the JAX package's
host modules it keeps as its own copy.

Entry points (`checker.linearizable.Linearizable`,
`ops.wgl.check_wgl_device`, `ops.wgl_witness.check_wgl_witness`) run
on the card by default (`device="cuda"`) and raise when CUDA is
missing; the CPU runs only when a caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
