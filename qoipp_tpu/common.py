"""Core QOI types, constants, validation and header I/O.

Re-implementation of the reference library's format layer
(reference: include/qoipp/common.hpp:17-23 constants, :54-132 enums/structs,
:78-94 Error taxonomy, :346-412 validation/size math; source/common.cpp:13-72
header parsing).  Pure Python/numpy — no JAX dependency so it can be imported
in any context (host tools, tests, device pipelines).
"""

from __future__ import annotations

import enum
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Generic, Iterator, Optional, TypeVar, Union

import numpy as np

# --------------------------------------------------------------------------
# Constants (reference: include/qoipp/common.hpp:17-23, source/util.hpp:27-43)
# --------------------------------------------------------------------------

MAGIC = b"qoif"
HEADER_SIZE = 14
END_MARKER = bytes([0, 0, 0, 0, 0, 0, 0, 1])
END_MARKER_SIZE = 8
RUNNING_ARRAY_SIZE = 64
RUN_LIMIT = 62

# Op tags (reference: source/util.hpp:47-55)
OP_RGB = 0xFE
OP_RGBA = 0xFF
OP_INDEX = 0x00
OP_DIFF = 0x40
OP_LUMA = 0x80
OP_RUN = 0xC0

# Biases (reference: source/util.hpp:29-39)
BIAS_OP_RUN = -1
BIAS_OP_DIFF = 2
BIAS_OP_LUMA_G = 32
BIAS_OP_LUMA_RB = 8
MIN_DIFF, MAX_DIFF = -2, 1
MIN_LUMA_G, MAX_LUMA_G = -32, 31
MIN_LUMA_RB, MAX_LUMA_RB = -8, 7

# Codec start state (reference: source/util.hpp:42)
START_PIXEL = (0x00, 0x00, 0x00, 0xFF)

# Largest byte count representable by the reference (std::size_t).
_SIZE_T_MAX = 2**64 - 1


# --------------------------------------------------------------------------
# Enums (reference: common.hpp:54-70, :78-94)
# --------------------------------------------------------------------------


class Colorspace(enum.IntEnum):
    """Image colorspace. Informational only — does not affect encoding
    (reference: common.hpp:48-58)."""

    SRGB = 0
    LINEAR = 1

    # aliases matching the reference's spelling
    sRGB = 0
    Linear = 1


class Channels(enum.IntEnum):
    """Number of channels / bytes per pixel (reference: common.hpp:60-70)."""

    RGB = 3
    RGBA = 4


class Error(enum.IntEnum):
    """Error taxonomy — mirrors the reference's 14 codes 1:1
    (reference: common.hpp:78-94)."""

    EMPTY = 1
    TOO_SHORT = 2
    TOO_BIG = 3
    NOT_QOI = 4
    INVALID_DESC = 5
    MISMATCHED_DESC = 6
    NOT_ENOUGH_SPACE = 7
    NOT_INITIALIZED = 8
    ALREADY_INITIALIZED = 9
    NOT_REGULAR_FILE = 10
    FILE_EXISTS = 11
    FILE_NOT_EXISTS = 12
    IO_ERROR = 13
    BAD_ALLOC = 14


_ERROR_STRINGS = {
    Error.EMPTY: "Data is empty",
    Error.TOO_SHORT: "Data is too short",
    Error.TOO_BIG: "Image is too big to process",
    Error.NOT_QOI: "Not a QOI file",
    Error.INVALID_DESC: "Image description is invalid",
    Error.MISMATCHED_DESC: "Image description does not match the data",
    Error.NOT_ENOUGH_SPACE: "Buffer does not have enough space",
    Error.NOT_REGULAR_FILE: "Not a regular file",
    Error.FILE_EXISTS: "File already exists",
    Error.FILE_NOT_EXISTS: "File does not exist",
    Error.IO_ERROR: "Unable to do read or write operation",
    Error.BAD_ALLOC: "Failed to allocate memory",
    Error.NOT_INITIALIZED: "Stream encoder/decoder is not initialized yet",
    Error.ALREADY_INITIALIZED: "Stream encoder/decoder already initialized",
}


def to_string(error: Error) -> str:
    """Human-readable error description (reference: common.hpp:260-280)."""
    return _ERROR_STRINGS.get(error, "Unknown")


def to_channels(channels: int) -> Optional[Channels]:
    """3/4 -> Channels, else None (reference: common.hpp:290-300)."""
    if channels == 3:
        return Channels.RGB
    if channels == 4:
        return Channels.RGBA
    return None


def to_colorspace(colorspace: int) -> Optional[Colorspace]:
    """0/1 -> Colorspace, else None (reference: common.hpp:306-316)."""
    if colorspace == 0:
        return Colorspace.SRGB
    if colorspace == 1:
        return Colorspace.LINEAR
    return None


# --------------------------------------------------------------------------
# Value types (reference: common.hpp:100-132)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Pixel:
    """One RGBA pixel (reference: common.hpp:100-108)."""

    r: int
    g: int
    b: int
    a: int = 0xFF

    def __iter__(self) -> Iterator[int]:
        return iter((self.r, self.g, self.b, self.a))


@dataclass(frozen=True)
class Desc:
    """QOI image description (reference: common.hpp:114-122)."""

    width: int
    height: int
    channels: Channels
    colorspace: Colorspace = Colorspace.SRGB

    def replace(self, **kw) -> "Desc":
        d = dict(
            width=self.width,
            height=self.height,
            channels=self.channels,
            colorspace=self.colorspace,
        )
        d.update(kw)
        return Desc(**d)


@dataclass
class Image:
    """Raw decoded image bytes + its description (reference: common.hpp:128-132).

    ``data`` is a 1-D uint8 numpy array of length width*height*channels.
    """

    data: np.ndarray
    desc: Desc


@dataclass(frozen=True)
class EncodeStatus:
    """Result of a (possibly partial) encode_into (reference: common.hpp:138-147)."""

    written: int
    complete: bool


@dataclass(frozen=True)
class StreamResult:
    """Bytes processed / written by one streaming call (reference: common.hpp:149-159)."""

    processed: int
    written: int


# --------------------------------------------------------------------------
# Result — std::expected-style return (reference: common.hpp:161-253)
# --------------------------------------------------------------------------

T = TypeVar("T")


class Result(Generic[T]):
    """Success-or-Error wrapper mirroring the reference's ``Result<T>``.

    Truthy iff it holds a value.  ``.value()`` raises if it holds an error,
    ``.error()`` raises if it holds a value — same contract as std::expected.
    """

    __slots__ = ("_value", "_error")

    def __init__(self, value: Optional[T] = None, error: Optional[Error] = None):
        if (value is None) == (error is None):
            raise ValueError("Result holds exactly one of value/error")
        self._value = value
        self._error = error

    # -- constructors -------------------------------------------------------
    @staticmethod
    def ok(value: T) -> "Result[T]":
        return Result(value=value)

    @staticmethod
    def err(error: Error) -> "Result[T]":
        return Result(error=error)

    # -- accessors ----------------------------------------------------------
    def has_value(self) -> bool:
        return self._error is None

    def __bool__(self) -> bool:
        return self.has_value()

    def value(self) -> T:
        if self._error is not None:
            raise ValueError(f"Result holds error: {to_string(self._error)}")
        return self._value  # type: ignore[return-value]

    def error(self) -> Error:
        if self._error is None:
            raise ValueError("Result holds a value, not an error")
        return self._error

    def value_or(self, default: T) -> T:
        return self._value if self._error is None else default  # type: ignore

    def __repr__(self) -> str:
        if self._error is None:
            return f"Result.ok({self._value!r})"
        return f"Result.err({self._error!r})"


def make_result(value: T) -> Result[T]:
    return Result.ok(value)


def make_error(error: Error) -> Result:
    return Result.err(error)


# --------------------------------------------------------------------------
# Validation & size math (reference: common.hpp:346-412)
# --------------------------------------------------------------------------


def is_valid(desc: Desc) -> bool:
    """Validate a Desc (reference: common.hpp:346-352)."""
    return (
        desc.width > 0
        and desc.height > 0
        and desc.channels in (Channels.RGB, Channels.RGBA)
        and desc.colorspace in (Colorspace.SRGB, Colorspace.LINEAR)
    )


def count_bytes(desc: Desc) -> Result[int]:
    """Raw byte count of the image described by desc, with the reference's
    size_t overflow checks (reference: common.hpp:364-388)."""
    if not is_valid(desc):
        return Result.err(Error.INVALID_DESC)
    pixel_count = desc.width * desc.height
    if pixel_count > _SIZE_T_MAX:
        return Result.err(Error.TOO_BIG)
    total = pixel_count * int(desc.channels)
    if total > _SIZE_T_MAX:
        return Result.err(Error.TOO_BIG)
    return Result.ok(total)


def worst_size(desc: Desc) -> Result[int]:
    """Worst-case encoded size: every pixel uncompressed + tag byte, plus
    header and end marker (reference: common.hpp:402-412)."""
    bytes_count = count_bytes(desc)
    if not bytes_count:
        return Result.err(bytes_count.error())
    return Result.ok(
        (int(desc.channels) + 1) * desc.width * desc.height
        + HEADER_SIZE
        + END_MARKER_SIZE
    )


# --------------------------------------------------------------------------
# Header I/O (reference: source/common.cpp:13-72)
# --------------------------------------------------------------------------

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]


def _as_bytes(data: BytesLike) -> bytes:
    if isinstance(data, np.ndarray):
        return data.tobytes()
    return bytes(data)


def write_header(desc: Desc) -> bytes:
    """Serialize a 14-byte QOI header: magic + BE width/height + channels +
    colorspace (reference: source/util.hpp:125-149)."""
    return (
        MAGIC
        + struct.pack(">II", desc.width, desc.height)
        + bytes([int(desc.channels), int(desc.colorspace)])
    )


def read_header(source: Union[BytesLike, str, os.PathLike]) -> Result[Desc]:
    """Parse and validate a QOI header from memory or a file path
    (reference: source/common.cpp:13-50 for spans, :52-72 for paths)."""
    if isinstance(source, (str, os.PathLike)):
        path = Path(source)
        if not path.exists():
            return Result.err(Error.FILE_NOT_EXISTS)
        if not path.is_file():
            return Result.err(Error.NOT_REGULAR_FILE)
        try:
            with open(path, "rb") as f:
                data = f.read(HEADER_SIZE)
        except OSError:
            return Result.err(Error.IO_ERROR)
        if len(data) < HEADER_SIZE:
            return Result.err(Error.IO_ERROR)
        return read_header(data)

    data = _as_bytes(source)
    if len(data) == 0:
        return Result.err(Error.EMPTY)
    if len(data) < HEADER_SIZE:
        return Result.err(Error.TOO_SHORT)
    if data[:4] != MAGIC:
        return Result.err(Error.NOT_QOI)
    width, height = struct.unpack(">II", data[4:12])
    channels = to_channels(data[12])
    colorspace = to_colorspace(data[13])
    if channels is None or colorspace is None or width == 0 or height == 0:
        return Result.err(Error.INVALID_DESC)
    return Result.ok(Desc(width, height, channels, colorspace))


# Callback types mirroring the reference's functional adapters
# (reference: common.hpp:44-46).
PixelGenFun = Callable[[int], Pixel]
PixelSinkFun = Callable[[Pixel], None]
ByteSinkFun = Callable[[int], None]
