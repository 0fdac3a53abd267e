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
kernel.  The sweep also counts each instantiation it launched, under
`witness_sweep[<model>]` (`witness_sweep[<model>+stream]` for the
stream's).  Counts are taken under a lock: the many-key checker
launches from worker threads.  Callers reset them with
`launches.clear()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
_launches_lock = threading.Lock()

#: The sweep kernel's models (`PackedModel.kernel_model` ids, as
#: csrc/witness_sweep.cu numbers them) and the state widths each is
#: compiled for: 1..32 for the multi-register (bucketed), the queues'
#: 32 slots.
SWEEP_MODELS = {
    1: ("register", (1,)),
    2: ("mutex", (1,)),
    3: ("multi-register", tuple(range(1, 33))),
    4: ("fifo-queue", (32,)),
    5: ("unordered-queue", (32,)),
}

#: Compiler output of this process's kernel build (with `-Xptxas -v`:
#: registers, shared memory and spills); empty when the library was
#: already built.
build_log = ""

_sweep: ctypes.CDLL | None = None
_build_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """A kernel's source could not be built (no nvcc, or nvcc failed)."""


class KernelLaunchError(RuntimeError):
    """A kernel failed to launch (a CUDA error came back) or reported a
    fault in its output.  Never a resource error to the degradation
    ladder, whatever CUDA's message says: a failing kernel fails the
    run."""


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise KernelBuildError(
            "nvcc not found (PATH or CUDA_HOME): the CUDA kernels are "
            "built from csrc/ at first use and need the CUDA toolkit")
    return nvcc


def sweep_lib() -> ctypes.CDLL:
    """The witness sweep library, built from csrc/witness_sweep.cu on
    first use (keyed by a hash of the source and flags) and loaded.
    Raises with the compiler's output if the build fails."""
    with _build_lock:
        return _sweep_lib_locked()


def _sweep_lib_locked() -> ctypes.CDLL:
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
            raise KernelBuildError(f"CUDA kernel build failed: witness_sweep.cu "
                               f"(nvcc exit {proc.returncode}):\n{build_log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    # Every pointer and the stream as c_void_p: ctypes would pass a bare
    # Python int as a 32-bit int and cut the pointer.
    lib.witness_sweep_launch.argtypes = (
        [ctypes.c_int] * 7 + [ctypes.c_void_p] * 9)
    lib.witness_sweep_launch.restype = ctypes.c_int
    lib.witness_sweep_chain_probe.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3)
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
                  member: torch.Tensor, states: torch.Tensor,
                  alive: torch.Tensor, init: torch.Tensor | None = None):
    """Launches csrc/witness_sweep.cu on CUDA tensors, as the port holds
    them.

    bars (6, K) i32, member (W, B) bool, states (B, SW) i32, alive (B,)
    bool, all contiguous on one card, 1 <= B <= 32 -> (states' (B, SW)
    i32, alive' (B,) bool, death (1,) i32) on that card; death is -1 if
    the kernel's two warps lost their hand-off (see `sweep`).  `model`
    is a `PackedModel.kernel_model` id (`SWEEP_MODELS`), SW one of its
    widths.  `init`, the (SW,) int32 initial state, selects the stream
    instantiation, which knows the RESET op.  Raises ValueError on
    anything else (checked before the device, so CPU tensors show the
    shape errors first), and KernelLaunchError if the launch fails."""
    for t, name, dtype, ndim in ((bars, "bars", torch.int32, 2),
                                 (member, "member", torch.bool, 2),
                                 (states, "states", torch.int32, 2),
                                 (alive, "alive", torch.bool, 1)):
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(
                f"witness_sweep: {name} must be a {ndim}-d {dtype} tensor, "
                f"got {t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"witness_sweep: {name} must be contiguous")
    w, b = member.shape
    k = bars.shape[1]
    sw = states.shape[1]
    if (bars.shape[0] != 6 or states.shape[0] != b or alive.shape != (b,)
            or not 1 <= b <= 32):
        raise ValueError(
            f"witness_sweep: bad shapes bars {tuple(bars.shape)}, member "
            f"{tuple(member.shape)}, states {tuple(states.shape)}, alive "
            f"{tuple(alive.shape)} (B must be 1..32)")
    if model not in SWEEP_MODELS:
        raise ValueError(f"witness_sweep: no device step for model {model}")
    model_name, widths = SWEEP_MODELS[model]
    if sw not in widths:
        raise ValueError(f"witness_sweep: {model_name} takes state widths "
                         f"{widths[0]}..{widths[-1]}, got {sw}")
    if init is not None and (init.dtype != torch.int32
                             or tuple(init.shape) != (sw,)
                             or not init.is_contiguous()):
        raise ValueError(f"witness_sweep: init must be a contiguous ({sw},) "
                         f"int32 tensor, got {tuple(init.shape)} {init.dtype}")
    if not 0 <= start_k <= k:
        raise ValueError(f"witness_sweep: start_k {start_k} outside [0, {k}]")
    dev = bars.device
    on_card = [member, states, alive] + ([init] if init is not None else [])
    if dev.type != "cuda" or any(t.device != dev for t in on_card):
        raise ValueError(
            f"witness_sweep needs CUDA tensors on one card, got "
            f"{[str(t.device) for t in [bars] + on_card]}")
    if member.data_ptr() % 4:
        raise ValueError("witness_sweep: member must be 4-byte aligned "
                         "(its rows are fetched in 4-byte words)")
    lib = sweep_lib()
    states_out = torch.empty_like(states)
    alive_out = torch.empty_like(alive)
    death = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.witness_sweep_launch(
            int(model), sw, int(init is not None), b, k, w, int(start_k),
            bars.data_ptr(), member.data_ptr(), states.data_ptr(),
            alive.data_ptr(), None if init is None else init.data_ptr(),
            states_out.data_ptr(), alive_out.data_ptr(), death.data_ptr(),
            stream)
    _check(lib, "witness_sweep", err)
    suffix = "+stream" if init is not None else ""
    with _launches_lock:
        launches["witness_sweep"] += 1
        launches[f"witness_sweep[{model_name}{suffix}]"] += 1
    return states_out, alive_out, death


def sweep_chain_probe(steps: int, device: torch.device) -> torch.Tensor:
    """Launches the sweep's per-lane chain probe (csrc/witness_sweep.cu
    `chain_probe_kernel`: `steps` dependent per-barrier lane steps, a
    multiple of 16, over 16 fixed ops held in registers, with no loads
    and no vote) on `device` -> its (32,) int32 output.  A measuring
    aid, not a kernel of the checking path: it is not counted in
    `launches`."""
    lib = sweep_lib()
    j = torch.arange(16, dtype=torch.int32)
    # {f, a0, a1, member word}: reads, writes and cas over values 0-3.
    ops = torch.stack([j % 3, (j * 7) % 4, (j * 5) % 4, (j * 40503) & 0xFF],
                      dim=1).to(torch.int32).contiguous().to(device)
    out = torch.empty(32, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib, "witness_sweep_chain_probe",
               lib.witness_sweep_chain_probe(int(steps), ops.data_ptr(),
                                             out.data_ptr(), stream))
    return out
