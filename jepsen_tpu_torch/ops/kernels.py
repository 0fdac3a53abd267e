"""The port's hand-written CUDA kernels: build, binding, launch counts.

Each kernel is a `csrc/<name>.cu` file with a plain C interface.  At
first use it is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library under `build/jepsen_tpu_torch/` at the repository root, keyed
by a hash of its source and flags, and loaded with `ctypes`.  Nothing
is built or loaded when this module is imported.

Each wrapper checks its tensors, allocates its outputs with
`torch.empty`, launches on the current stream, raises if the launch
returned a CUDA error, and adds one to `launches[<name>]` — there and
nowhere else — so a run can show that its main path went through the
kernel.  Callers reset the counts with `launches.clear()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jepsen_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: Kernel launches by kernel name.
launches: Counter = Counter()

#: Compiler output of this process's kernel build (with `-Xptxas -v`:
#: registers, shared memory and spills); empty when the library was
#: already built.
build_log = ""

_sweep: ctypes.CDLL | None = None


class KernelLaunchError(RuntimeError):
    """A kernel failed to launch (a CUDA error came back).  Never a
    resource error to the degradation ladder, whatever CUDA's message
    says: a failing kernel fails the run."""


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or CUDA_HOME): the CUDA kernels are "
            "built from csrc/ at first use and need the CUDA toolkit")
    return nvcc


def sweep_lib() -> ctypes.CDLL:
    """The witness sweep library, built from csrc/witness_sweep.cu on
    first use (keyed by a hash of the source and flags) and loaded.
    Raises with the compiler's output if the build fails."""
    global _sweep, build_log
    if _sweep is not None:
        return _sweep
    src = CSRC / "witness_sweep.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"libwitness_sweep-{digest[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA kernel build failed: witness_sweep.cu "
                               f"(nvcc exit {proc.returncode}):\n{build_log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    # Every pointer and the stream as c_void_p: ctypes would pass a bare
    # Python int as a 32-bit int and cut the pointer.
    lib.witness_sweep_launch.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8)
    lib.witness_sweep_launch.restype = ctypes.c_int
    lib.witness_sweep_chain_probe.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.witness_sweep_chain_probe.restype = ctypes.c_int
    lib.witness_sweep_error_string.argtypes = [ctypes.c_int]
    lib.witness_sweep_error_string.restype = ctypes.c_char_p
    _sweep = lib
    return lib


def _check(lib: ctypes.CDLL, what: str, err: int) -> None:
    if err != 0:
        msg = lib.witness_sweep_error_string(err).decode()
        raise KernelLaunchError(f"{what} launch failed: {msg} ({err})")


def witness_sweep(model: int, start_k: int, bars: torch.Tensor,
                  mbits: torch.Tensor, states: torch.Tensor,
                  alive: torch.Tensor):
    """Launches csrc/witness_sweep.cu on CUDA tensors.

    bars (6, K) i32, mbits (W,) i32 (lane b = bit b), states (SW, B)
    i32 lane-major, alive (B,) i32 0/1 -> (states' (SW, B) i32, alive'
    (B,) i32, death (1,) i32), all on the inputs' device.  `model` is a
    `PackedModel.kernel_model` id."""
    dev = bars.device
    if dev.type != "cuda":
        raise ValueError(f"witness_sweep needs CUDA tensors, got {dev}")
    for t, name, ndim in ((bars, "bars", 2), (mbits, "mbits", 1),
                          (states, "states", 2), (alive, "alive", 1)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != ndim:
            raise ValueError(
                f"witness_sweep: {name} must be a {ndim}-d int32 tensor on "
                f"{dev}, got {t.dim()}-d {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"witness_sweep: {name} must be contiguous")
    sw, b = states.shape
    k = bars.shape[1]
    if bars.shape[0] != 6 or alive.shape != (b,) or not 1 <= b <= 32:
        raise ValueError(
            f"witness_sweep: bad shapes bars {tuple(bars.shape)}, states "
            f"{tuple(states.shape)}, alive {tuple(alive.shape)}")
    if not 0 <= start_k <= k:
        raise ValueError(f"witness_sweep: start_k {start_k} outside [0, {k}]")
    lib = sweep_lib()
    states_out = torch.empty_like(states)
    alive_out = torch.empty_like(alive)
    death = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.witness_sweep_launch(
            int(model), sw, b, k, int(start_k), bars.data_ptr(),
            mbits.data_ptr(), states.data_ptr(), alive.data_ptr(),
            states_out.data_ptr(), alive_out.data_ptr(), death.data_ptr(),
            stream)
    _check(lib, "witness_sweep", err)
    launches["witness_sweep"] += 1
    return states_out, alive_out, death


def sweep_chain_probe(steps: int, device: torch.device) -> torch.Tensor:
    """Launches the sweep's serial-chain probe (csrc/witness_sweep.cu
    `chain_probe_kernel`: `steps` register steps, ballots and commits
    with no loads; a multiple of 16) on `device` -> its (33,) int32
    output.  A measuring
    aid, not a kernel of the checking path: it is not counted in
    `launches`."""
    lib = sweep_lib()
    out = torch.empty(33, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib, "witness_sweep_chain_probe",
               lib.witness_sweep_chain_probe(int(steps), out.data_ptr(),
                                             stream))
    return out
