"""Replay kernel: exact batched QOI chunk replay.

The sequential heart of QOI decode — per-chunk state transitions over
(prev pixel, 64-entry table) — runs as ONE kernel over a batch of
independent lanes.  On a GPU it is native/replay.cu, called through the
JAX FFI: one thread per lane, the lane's table in shared memory, indexed
directly.  It is exact for EVERY stream, including adversarial ones (the
INDEX write-back is modeled literally).

Chunk encoding (built by ops/decode dense passes):
  meta: uint32 = cls | (arg << 3) | (reset << 9)
        cls: 0 NOP, 1 SETA, 2 SETC, 3 ADD, 4 IDX, 5 RUN; reset: the chunk
        begins a new stream in its lane (packed lanes, models/packed.py)
  val:  uint32 = absolute RGBA (SETA), RGB with zero alpha byte (SETC),
                 or per-byte delta (ADD)

Route (`route()`): the compiled CUDA kernel on a GPU; on the CPU, the
test route, the same step as a plain lax.scan (`replay_reference`, also
the oracle the kernel is checked against); any other platform raises.
The kernel library is compiled for sm_90a with nvcc on first use into
<repo>/build/cuda (listed in .gitignore) and rebuilt when the source is
newer.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp

from .bitops import START_PIXEL_PACKED

_START_HASH = (11 * 255) % 64

CLS_NOP, CLS_SETA, CLS_SETC, CLS_ADD, CLS_IDX, CLS_RUN = range(6)

ROWS = 16  # the kernel takes rows in groups of 16 (NOP rows pad)

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "replay.cu"
_LIB = _ROOT / "build" / "cuda" / "libqoi_replay.so"

# FFI targets of the kernel; they name its calls in a compiled program.
GPU_TARGETS = ("qoi_replay", "qoi_replay_summary")

_registered = False


def route() -> str:
    """"cuda" on a GPU (the compiled kernel), "reference" on the CPU (the
    plain lax.scan, the test route); any other platform raises."""
    platform = jax.default_backend()
    if platform == "gpu":
        return "cuda"
    if platform == "cpu":
        return "reference"
    raise NotImplementedError(
        f"the replay kernel has no route for platform {platform!r}"
    )


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the replay kernel needs the CUDA "
                       "toolkit to build native/replay.cu")


def build() -> Path:
    """Compile native/replay.cu into build/cuda when missing or stale."""
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-I", jax.ffi.include_dir(), "-o", str(tmp), str(_SRC)],
        check=True, capture_output=True,
    )
    os.replace(tmp, _LIB)
    return _LIB


def _register() -> None:
    global _registered
    if _registered:
        return
    lib = ctypes.cdll.LoadLibrary(str(build()))
    for name, sym in zip(GPU_TARGETS, (lib.QoiReplay, lib.QoiReplaySummary)):
        jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(sym),
                                    platform="CUDA")
    _registered = True


@partial(jax.jit, static_argnames=("summary",))
def _replay(meta, val, prev_in, seen_in, summary: bool):
    if route() == "reference":
        outs = replay_reference(meta, val, prev_in, seen_in)
        return outs if summary else outs[:3]
    _register()
    c, b = meta.shape
    cpad = (-c) % ROWS  # NOP rows leave the state untouched
    if cpad:
        meta = jnp.pad(meta, ((0, cpad), (0, 0)))
        val = jnp.pad(val, ((0, cpad), (0, 0)))
    u32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.uint32)
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
    outs = jax.ffi.ffi_call(
        GPU_TARGETS[1] if summary else GPU_TARGETS[0],
        (u32(c + cpad, b), u32(1, b), u32(64, b), i32(1, b), i32(64, b)),
    )(meta, val, prev_in, seen_in)
    outs = (outs[0][:c],) + tuple(outs[1:])
    return outs if summary else outs[:3]


def initial_state(b: int):
    """The decoder's initial carry: prev = start pixel; table zero except
    the seeded slot (reference quirk: simple.cpp:108, stream.cpp:306)."""
    prev0 = jnp.full((1, b), START_PIXEL_PACKED, jnp.uint32)
    slots0 = jax.lax.broadcasted_iota(jnp.int32, (64, b), 0)
    seen0 = jnp.where(slots0 == _START_HASH, jnp.uint32(START_PIXEL_PACKED),
                      jnp.uint32(0))
    return prev0, seen0


def replay_batch_carry(meta, val, prev_in, seen_in):
    """Carried-state replay: decode a window of chunk rows starting from an
    explicit (prev, seen) state — the ~260-byte codec carry of SURVEY.md §5
    — and return the state after the window (the device streaming-decode
    primitive).

    meta/val: (C, B) uint32 (chunk-major); prev_in: (1, B); seen_in: (64, B).
    Returns (emits (C, B), prev_out (1, B), seen_out (64, B)).
    """
    return _replay(meta, val, prev_in, seen_in, summary=False)


def replay_batch_summary(meta, val, prev_in, seen_in):
    """Carried-state replay that ALSO returns per-lane transfer summaries:
    pupd (1, B) int32 — prev overwritten anywhere in the lane; swr (64, B)
    int32 — table slot overwritten (a stream reset overwrites everything).
    A lane's out-state component equals its in-state component exactly
    where the summary bit is 0 — the seam algebra the split-replay
    fixpoint (models/split.py) propagates.

    Returns (emits, prev_out, seen_out, pupd, swr)."""
    return _replay(meta, val, prev_in, seen_in, summary=True)


def replay_batch(meta, val):
    """meta/val: (C, B) uint32 chunk fields (chunk-major).  Returns
    emits (C, B) uint32 — the value each chunk produces (RUN repeats it).
    """
    prev0, seen0 = initial_state(meta.shape[1])
    return replay_batch_carry(meta, val, prev0, seen0)[0]


def _swar_add(x, y):
    lo = ((x & 0x00FF00FF) + (y & 0x00FF00FF)) & 0x00FF00FF
    hi = (((x >> 8) & 0x00FF00FF) + ((y >> 8) & 0x00FF00FF)) & 0x00FF00FF
    return lo | (hi << 8)


def _hash6(v):
    r = v & 0xFF
    g = (v >> 8) & 0xFF
    b = (v >> 16) & 0xFF
    a = v >> 24
    return ((r * 3 + g * 5 + b * 7 + a * 11) & 63).astype(jnp.int32)


@jax.jit
def replay_reference(meta, val, prev_in, seen_in):
    """The replay as a plain lax.scan over chunk rows with a directly
    indexed table: the CPU route and the kernel's oracle.  Same arguments
    as replay_batch_summary; returns (emits, prev_out, seen_out, pupd,
    swr)."""
    b = meta.shape[1]
    slots = jax.lax.broadcasted_iota(jnp.int32, (64, b), 0)
    _, seed = initial_state(b)

    def step(carry, row):
        prev, seen, pupd, swr = carry
        m, x = row
        cls = (m & 7).astype(jnp.int32)
        arg = ((m >> 3) & 63).astype(jnp.int32)
        rst = ((m >> 9) & 1) == 1
        prev = jnp.where(rst, jnp.uint32(START_PIXEL_PACKED), prev)
        seen = jnp.where(rst[None, :], seed, seen)
        idx_val = jnp.take_along_axis(seen, arg[None, :], axis=0)[0]
        v = jnp.select(
            [cls == CLS_SETA, cls == CLS_SETC, cls == CLS_ADD,
             cls == CLS_IDX],
            [x, (prev & jnp.uint32(0xFF000000)) | x, _swar_add(prev, x),
             idx_val],
            prev,
        )
        upd = (cls >= CLS_SETA) & (cls <= CLS_IDX)
        hot = (slots == _hash6(v)[None, :]) & upd[None, :]
        seen = jnp.where(hot, v[None, :], seen)
        carry = (jnp.where(upd, v, prev), seen, pupd | rst | upd,
                 swr | rst[None, :] | hot)
        return carry, v

    init = (prev_in[0], seen_in, jnp.zeros((b,), bool),
            jnp.zeros((64, b), bool))
    (prev, seen, pupd, swr), emits = jax.lax.scan(step, init, (meta, val))
    return (emits, prev[None], seen, pupd[None].astype(jnp.int32),
            swr.astype(jnp.int32))
