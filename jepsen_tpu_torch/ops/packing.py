"""32-bit lane packing for the WGL member and child bitsets.

The port of `jepsen_tpu/ops/packing.py`.  A member set over a window of
``W`` slots is carried as ``ceil(W / 32)`` words instead of ``W``
bools.  Bit ``w`` of a set lives at word ``w // 32``, lane ``w % 32``
(LSB-first).  Padding lanes (``w >= W``) are always zero, so a full
coverage test ORs them away with the complement of the packed ok-mask.

The reference's words are uint32.  PyTorch's uint32 tensors lack
addition, shifts and sums, so here a word is an int32 tensor holding
the same 32-bit pattern (bit 31 is the sign bit), and the hash
arithmetic runs in int64 on values in [0, 2^32), reduced mod 2^32
after every multiply-add, with every product kept under 2^63 by
splitting the constant into 16-bit halves.  The hashes therefore equal
the reference's wrapping uint32 multiply-adds bit for bit, and sorting
their int64 values sorts them as the reference sorts its uint32 ones;
they decide the dedup sort's order, so they must.

The torch functions take tensors on any device and return tensors on
the same device.  Given numpy arrays instead, they return numpy arrays
with the reference's types (uint32 words and hashes), as the
reference's functions do; the `np_*` functions are host mirrors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

LANES = 32
FULL_WORD = np.uint32(0xFFFFFFFF)
_MASK32 = 0xFFFFFFFF

# Fixed odd multipliers (splitmix-style) for the word and state hash
# lanes: independent hash streams.  Dedup correctness never depends on
# them (an exact word compare backs the hash), only sort clustering.
_HASH_SEEDS = (
    np.uint32(0x9E3779B1), np.uint32(0x85EBCA77),
    np.uint32(0xC2B2AE3D), np.uint32(0x27D4EB2F),
)


def n_words(W: int) -> int:
    """Words needed for a W-slot window."""
    return max(1, -(-int(W) // LANES))


def word_lane_tables(W: int) -> tuple[np.ndarray, np.ndarray]:
    """(word_idx[W] int32, lane_bit[W] uint32) lookup tables."""
    idx = np.arange(W, dtype=np.int32)
    lane = np.arange(W, dtype=np.uint32) % np.uint32(LANES)
    return idx // LANES, np.uint32(1) << lane


def hash_consts(Wp: int, stream: int = 0) -> np.ndarray:
    """Per-word odd uint32 multipliers for hash stream `stream`."""
    seed = _HASH_SEEDS[stream % len(_HASH_SEEDS)]
    k = np.arange(1, Wp + 1, dtype=np.uint32)
    # All-uint32 arithmetic: wraps in-type, no narrowing cast needed.
    return k * seed * np.uint32(2) + np.uint32(1)


def _to_torch(x):
    """A numpy argument as a CPU tensor (uint32 words as their int32
    bit patterns); tensors and Python scalars pass through."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, np.generic):
        return _to_torch(np.asarray(x))
    return x


def _numpy_io(kind: str):
    """Lets a torch function take numpy arrays: with a numpy first
    argument it runs on the CPU and the result comes back as numpy, its
    words ("words") and hashes ("hash") as uint32 like the reference's;
    "plain" results keep their type."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args):
            if not isinstance(args[0], np.ndarray):
                return fn(*args)
            out = fn(*(_to_torch(a) for a in args)).numpy()
            if kind == "words":
                return out.view(np.uint32)
            if kind == "hash":
                return out.astype(np.uint32)
            return out
        return call
    return wrap


def _lane_bits(device) -> torch.Tensor:
    """(32,) int64 single-bit values 1 << lane."""
    return torch.ones(LANES, dtype=torch.int64, device=device) << torch.arange(
        LANES, dtype=torch.int64, device=device)


def _words_from_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit pattern of int32 lanes as int64 values in [0, 2^32):
    the reference's uint32 relabel, in a type that adds and shifts."""
    assert x.dtype in (torch.int32, torch.int64), (
        f"as_u32: expected an int32 lane dtype, got {x.dtype}")
    return x.to(torch.int64) & _MASK32


@_numpy_io("words")
def pack_bits(x: torch.Tensor, Wp: int | None = None) -> torch.Tensor:
    """bool (..., W) -> int32 words (..., ceil(W/32)), LSB-first lanes."""
    W = x.shape[-1]
    wp = Wp if Wp is not None else n_words(W)
    pad = wp * LANES - W
    x = x.to(torch.bool)
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    xr = x.reshape(x.shape[:-1] + (wp, LANES))
    v = torch.where(xr, _lane_bits(x.device), 0).sum(dim=-1)
    return _words_from_u32(v)


@_numpy_io("plain")
def unpack_bits(words: torch.Tensor, W: int) -> torch.Tensor:
    """int32 words (..., Wp) -> bool (..., W)."""
    lanes = torch.arange(LANES, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., :, None] >> lanes) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * LANES,))
    return flat[..., :W].to(torch.bool).contiguous()


@_numpy_io("plain")
def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per row, summed over the last (word) axis -> int32."""
    return unpack_bits(words, words.shape[-1] * LANES).sum(
        dim=-1, dtype=torch.int32)


@_numpy_io("words")
def set_bit(words: torch.Tensor, slot) -> torch.Tensor:
    """ORs bit `slot` into each row of int32 words (..., Wp); `slot`
    broadcasts against the leading axes of `words`."""
    wp = words.shape[-1]
    slot = torch.as_tensor(slot, device=words.device).to(torch.int64)
    widx = slot // LANES
    bit = _words_from_u32(torch.ones_like(slot) << (slot % LANES))
    cols = torch.arange(wp, device=words.device)
    hot = torch.where(cols == widx[..., None], bit[..., None], 0)
    return words | hot.to(torch.int32)


@_numpy_io("plain")
def covers(child_words: torch.Tensor, ok_words: torch.Tensor) -> torch.Tensor:
    """True where a packed child set covers every ok bit.  Padding lanes
    of `ok_words` are zero, so their complement is all ones and they
    never block coverage."""
    return ((child_words | ~ok_words) == -1).all(dim=-1)


@_numpy_io("hash")
def hash_words(words: torch.Tensor, consts) -> torch.Tensor:
    """The wrapping uint32 multiply-add over the last axis: sum of
    words * consts mod 2^32, as int64 values in [0, 2^32).  `words`
    are int32 patterns (or int64 values in [0, 2^32)); `consts` uint32
    multipliers, as numpy or an int64 tensor."""
    w = as_u32(words)
    c = _to_torch(consts)
    c = c.to(device=w.device, dtype=torch.int64) & _MASK32
    # w * c mod 2^32 without a product past 2^48: c = hi * 2^16 + lo.
    lo = w * (c & 0xFFFF)
    hi = ((w * (c >> 16)) & 0xFFFF) << 16
    prod = (lo + hi) & _MASK32
    return prod.sum(dim=-1) & _MASK32


# -- host-side (numpy) mirrors ----------------------------------------------

def np_pack_bits(x: np.ndarray, Wp: int | None = None) -> np.ndarray:
    W = x.shape[-1]
    wp = Wp if Wp is not None else n_words(W)
    pad = wp * LANES - W
    if pad:
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    xr = x.reshape(x.shape[:-1] + (wp, LANES))
    lanebits = np.uint32(1) << np.arange(LANES, dtype=np.uint32)
    return np.where(xr, lanebits, np.uint32(0)).sum(
        axis=-1, dtype=np.uint32)


def np_unpack_bits(words: np.ndarray, W: int) -> np.ndarray:
    lanes = np.arange(LANES, dtype=np.uint32)
    bits = (words.astype(np.uint32)[..., :, None] >> lanes) & np.uint32(1)
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * LANES,))
    return flat[..., :W].astype(bool)
