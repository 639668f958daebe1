"""qoipp_tpu — QOI codec framework on JAX / XLA with a CUDA replay kernel.

A from-scratch re-design of the capabilities of the reference C++ library
(mrizaln/qoipp): one-shot and streaming QOI encode/decode with Result-style
error returns, reformulated as parallel scans and batched device
pipelines, with a native C++ CPU oracle for bit-exact parity.
"""

from .common import (
    BIAS_OP_DIFF,
    BIAS_OP_LUMA_G,
    BIAS_OP_LUMA_RB,
    BIAS_OP_RUN,
    END_MARKER,
    END_MARKER_SIZE,
    HEADER_SIZE,
    MAGIC,
    RUN_LIMIT,
    RUNNING_ARRAY_SIZE,
    Channels,
    Colorspace,
    Desc,
    EncodeStatus,
    Error,
    Image,
    Pixel,
    Result,
    StreamResult,
    count_bytes,
    is_valid,
    make_error,
    make_result,
    read_header,
    to_channels,
    to_colorspace,
    to_string,
    worst_size,
    write_header,
)

__version__ = "0.1.0"

# One-shot codec API (imported lazily-safe: api pulls in JAX only on use of
# the jax backend).
from .api import (  # noqa: E402
    decode,
    decode_into,
    encode,
    encode_into,
)
from .stream import StreamDecoder, StreamEncoder  # noqa: E402


def __getattr__(name):
    # Heavier device components load lazily (they pull in JAX).
    if name == "BatchPipeline":
        from .models.pipeline import BatchPipeline

        return BatchPipeline
    if name == "DeviceStreamEncoder":
        from .ops.device_stream import DeviceStreamEncoder

        return DeviceStreamEncoder
    if name == "DeviceStreamDecoder":
        from .ops.device_stream import DeviceStreamDecoder

        return DeviceStreamDecoder
    if name == "ServingCodec":
        from .models.serving import ServingCodec

        return ServingCodec
    if name == "ResidentCorpus":
        from .models.serving import ResidentCorpus

        return ResidentCorpus
    raise AttributeError(name)

__all__ = [
    "BatchPipeline",
    "DeviceStreamDecoder",
    "DeviceStreamEncoder",
    "ResidentCorpus",
    "ServingCodec",
    "Channels",
    "Colorspace",
    "Desc",
    "EncodeStatus",
    "Error",
    "Image",
    "Pixel",
    "Result",
    "StreamResult",
    "StreamEncoder",
    "StreamDecoder",
    "count_bytes",
    "decode",
    "decode_into",
    "encode",
    "encode_into",
    "is_valid",
    "make_error",
    "make_result",
    "read_header",
    "to_channels",
    "to_colorspace",
    "to_string",
    "worst_size",
    "write_header",
]
