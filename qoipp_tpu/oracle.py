"""ctypes bindings to the native C++ CPU oracle codec (native/qoi_ref.cpp).

The oracle is the bit-exact parity reference for the device codec (mirroring
how the reference library tests against upstream qoi.h — SURVEY.md §4) and
doubles as the fast CPU fallback backend.

Library resolution order:
1. prebuilt qoipp_tpu/_native/libqoiref.so (setup.py build_py, mirroring
   the reference's build-time library, CMakeLists.txt:9-16);
2. repo layout: native/libqoiref.so, (re)compiled with g++ when stale;
3. wheel without a prebuilt lib: the packaged source compiles on first
   use into ~/.cache/qoipp_tpu/.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .common import Channels, Colorspace, Desc

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SRC = _NATIVE_DIR / "qoi_ref.cpp"
_LIB = _NATIVE_DIR / "libqoiref.so"
_PKG_NATIVE = Path(__file__).resolve().parent / "_native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _build(src: Path, out: Path) -> None:
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-std=c++17",
        "-shared",
        "-fPIC",
        str(src),
        "-o",
        str(out),
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def _resolve_lib() -> Path:
    # 1. prebuilt at install time (wheel / pip install)
    pkg_lib = _PKG_NATIVE / "libqoiref.so"
    if pkg_lib.exists():
        return pkg_lib
    # 2. repo layout: compile next to the source, rebuild when stale
    if _SRC.exists():
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _build(_SRC, _LIB)
        return _LIB
    # 3. wheel without a prebuilt lib: packaged source -> user cache
    pkg_src = _PKG_NATIVE / "qoi_ref.cpp"
    if pkg_src.exists():
        cache = Path(
            os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache")
        ) / "qoipp_tpu"
        cache.mkdir(parents=True, exist_ok=True)
        out = cache / "libqoiref.so"
        if not out.exists() or out.stat().st_mtime < pkg_src.stat().st_mtime:
            _build(pkg_src, out)
        return out
    raise RuntimeError(
        "qoipp_tpu native oracle unavailable: no prebuilt libqoiref.so and "
        "no qoi_ref.cpp source found (package built without the native "
        "component and repo layout absent)"
    )


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_resolve_lib()))

        lib.qoiref_read_header.restype = ctypes.c_int
        lib.qoiref_read_header.argtypes = [
            _u8p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.qoiref_encode.restype = ctypes.c_uint64
        lib.qoiref_encode.argtypes = [
            _u8p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint8,
            ctypes.c_uint8, _u8p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.qoiref_decode.restype = None
        lib.qoiref_decode.argtypes = [
            _u8p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint8, ctypes.c_uint8, _u8p,
        ]
        lib.qoiref_flip_vertical.restype = None
        lib.qoiref_flip_vertical.argtypes = [
            _u8p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint8,
        ]
        lib.qoiref_stream_state_size.restype = ctypes.c_uint64
        lib.qoiref_stream_state_size.argtypes = []
        lib.qoiref_stream_reset.restype = None
        lib.qoiref_stream_reset.argtypes = [ctypes.c_void_p]
        lib.qoiref_enc_initialize.restype = ctypes.c_int64
        lib.qoiref_enc_initialize.argtypes = [
            ctypes.c_void_p, _u8p, ctypes.c_uint64,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint8, ctypes.c_uint8,
        ]
        lib.qoiref_enc_encode.restype = ctypes.c_int
        lib.qoiref_enc_encode.argtypes = [
            ctypes.c_void_p, _u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.qoiref_enc_finalize.restype = ctypes.c_int64
        lib.qoiref_enc_finalize.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_uint64]
        lib.qoiref_dec_initialize.restype = ctypes.c_int
        lib.qoiref_dec_initialize.argtypes = [
            ctypes.c_void_p, _u8p, ctypes.c_uint64, ctypes.c_uint8,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.qoiref_dec_decode.restype = ctypes.c_int
        lib.qoiref_dec_decode.argtypes = [
            ctypes.c_void_p, _u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.qoiref_dec_drain_run.restype = ctypes.c_int64
        lib.qoiref_dec_drain_run.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_uint64]
        lib.qoiref_dec_run_count.restype = ctypes.c_uint32
        lib.qoiref_dec_run_count.argtypes = [ctypes.c_void_p]
        lib.qoiref_stream_channels.restype = ctypes.c_uint8
        lib.qoiref_stream_channels.argtypes = [ctypes.c_void_p]
        lib.qoiref_dec_target.restype = ctypes.c_uint8
        lib.qoiref_dec_target.argtypes = [ctypes.c_void_p]
        lib.qoiref_stream_is_initialized.restype = ctypes.c_int
        lib.qoiref_stream_is_initialized.argtypes = [ctypes.c_void_p]
        lib.qoiref_pack_files.restype = ctypes.c_uint64
        lib.qoiref_pack_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64,
            _u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.qoiref_split_points.restype = ctypes.c_uint64
        lib.qoiref_split_points.argtypes = [
            _u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_double,
        ]

        _lib = lib
        return lib


def _np_u8(data) -> np.ndarray:
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray
    ) else np.ascontiguousarray(data, dtype=np.uint8)
    return arr


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


# --------------------------------------------------------------------------
# One-shot API
# --------------------------------------------------------------------------


def encode(pixels, desc: Desc, out_cap: Optional[int] = None) -> Tuple[np.ndarray, bool]:
    """Encode raw pixels -> (qoi bytes, complete). out_cap bounds the output
    buffer (default: worst case)."""
    lib = _load()
    arr = _np_u8(pixels)
    need = desc.width * desc.height * int(desc.channels)
    if arr.size < need:
        raise ValueError(
            f"pixel buffer too small: {arr.size} < {need} "
            f"({desc.width}x{desc.height}x{int(desc.channels)})"
        )
    if out_cap is None:
        out_cap = (int(desc.channels) + 1) * desc.width * desc.height + 22
    out = np.empty(out_cap, dtype=np.uint8)
    complete = ctypes.c_int(0)
    n = lib.qoiref_encode(
        _ptr(arr), desc.width, desc.height, int(desc.channels),
        int(desc.colorspace), _ptr(out), out_cap, ctypes.byref(complete),
    )
    return out[: int(n)], bool(complete.value)


def decode(data, desc: Desc, dst_channels: Channels) -> np.ndarray:
    """Tolerant decode of a full qoi byte stream into raw pixels."""
    lib = _load()
    arr = _np_u8(data)
    n_out = desc.width * desc.height * int(dst_channels)
    out = np.zeros(n_out, dtype=np.uint8)
    lib.qoiref_decode(
        _ptr(arr), arr.size, desc.width, desc.height,
        int(desc.channels), int(dst_channels), _ptr(out),
    )
    return out


def read_header(data) -> Optional[Desc]:
    lib = _load()
    arr = _np_u8(data)
    w = ctypes.c_uint32(0)
    h = ctypes.c_uint32(0)
    ch = ctypes.c_uint8(0)
    cs = ctypes.c_uint8(0)
    rc = lib.qoiref_read_header(
        _ptr(arr), arr.size, ctypes.byref(w), ctypes.byref(h),
        ctypes.byref(ch), ctypes.byref(cs),
    )
    if rc != 0:
        return None
    return Desc(w.value, h.value, Channels(ch.value), Colorspace(cs.value))


def flip_vertical(data: np.ndarray, desc: Desc) -> np.ndarray:
    lib = _load()
    arr = np.ascontiguousarray(data, dtype=np.uint8).copy()
    lib.qoiref_flip_vertical(_ptr(arr), desc.width, desc.height, int(desc.channels))
    return arr


# --------------------------------------------------------------------------
# Streaming state handle
# --------------------------------------------------------------------------


class NativeStreamState:
    """Owns one native StreamState blob; wrapped by qoipp_tpu.stream."""

    def __init__(self):
        lib = _load()
        self._lib = lib
        size = lib.qoiref_stream_state_size()
        self._blob = ctypes.create_string_buffer(int(size))
        lib.qoiref_stream_reset(self._blob)

    @property
    def lib(self):
        return self._lib

    @property
    def handle(self):
        return self._blob

    def reset(self):
        self._lib.qoiref_stream_reset(self._blob)

    def is_initialized(self) -> bool:
        return bool(self._lib.qoiref_stream_is_initialized(self._blob))

    def run_count(self) -> int:
        return int(self._lib.qoiref_dec_run_count(self._blob))

    def channels(self) -> int:
        return int(self._lib.qoiref_stream_channels(self._blob))

    def target(self) -> int:
        return int(self._lib.qoiref_dec_target(self._blob))


def split_points(body, n_px: int, n_segments: int,
                 byte_w: float = 1.0, px_w: float = 0.0,
                 lookahead: int = 0, prefer_rgba: bool = False,
                 chunk_w: float = 0.0):
    """Walk a QOI body's chunk sequence (bytes after the header, length
    stream_size - 22) and return (byte_offsets, px_offsets, chunk_ordinals):
    n+1-entry arrays of cost-balanced segment boundaries, every one ON a
    chunk boundary.  Cost per chunk = byte_w * bytes + chunk_w + px_w *
    pixels (chunk_w balances the compacted chunk-domain replay depth).  With
    lookahead > 0, each cut slides (up to that many bytes) to the next
    OP_RGB/OP_RGBA chunk, so segments open with an absolute-color write —
    the anchor that makes the split-replay seam fixpoint (models/split.py)
    converge in O(1) rounds; prefer_rgba targets OP_RGBA (alpha-varying
    streams).  chunk_ordinals[k] is segment k's first chunk's index in the
    stream's chunk sequence (diff = per-segment chunk counts — the static
    cap of the device-side chunk-domain compaction).  The host-side planner
    of the device split-replay engine."""
    lib = _load()
    arr = _np_u8(body)
    offs = np.zeros(n_segments + 1, dtype=np.uint64)
    pxs = np.zeros(n_segments + 1, dtype=np.uint64)
    cis = np.zeros(n_segments + 1, dtype=np.uint64)
    n = lib.qoiref_split_points(
        _ptr(arr), arr.size, n_px, n_segments,
        ctypes.c_double(byte_w), ctypes.c_double(px_w),
        lookahead, 1 if prefer_rgba else 0,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        pxs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        cis.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_double(chunk_w),
    )
    n = int(n)
    return (offs[: n + 1].astype(np.int64), pxs[: n + 1].astype(np.int64),
            cis[: n + 1].astype(np.int64))


def pack_files(paths, row: int):
    """Native batch loader: read QOI files into a zero-padded (B, row) u8
    array + per-file sizes in one native pass (the data-loader feeding
    BatchPipeline).  Raises on unreadable/oversized files."""
    lib = _load()
    n = len(paths)
    out = np.zeros((n, row), dtype=np.uint8)
    sizes = np.zeros(n, dtype=np.uint64)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.qoiref_pack_files(
        arr, n, _ptr(out.reshape(-1)), row,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        raise OSError(f"failed to load {paths[int(rc) - 1]}")
    return out, sizes.astype(np.int32)
