"""Host-facing wrappers around the JAX codec cores.

Handles packing, compile-size bucketing (pad pixel/byte counts to a small
set of static shapes so jit caches stay warm), device placement, and result
slicing.  The batched, fully device-resident pipelines live in
qoipp_tpu.models.pipeline; these wrappers serve the one-shot qoipp-style API.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..common import Channels, Desc, write_header
from ..utils.timing import enable_compile_cache
from . import encode as enc_ops
from .bitops import pixels_to_packed

def _ensure_cache() -> None:
    # Share per-shape codec compiles across processes unless the user
    # already configured a cache location.  Deliberately lazy: importing the library must not
    # mutate global JAX config (applications embedding qoipp_tpu may manage
    # their own cache), so this runs at the first codec entry call instead.
    if jax.config.jax_compilation_cache_dir is None:
        enable_compile_cache()


def encode_single(raw: np.ndarray, desc: Desc) -> np.ndarray:
    """Encode one image's raw bytes -> QOI byte stream (numpy), bit-exact
    with the reference encoder."""
    _ensure_cache()
    channels = int(desc.channels)
    n_px = desc.width * desc.height
    nb = enc_ops.bucket_size(n_px)

    raw = np.asarray(raw, dtype=np.uint8).reshape(-1)
    px = np.zeros((nb, channels), dtype=np.uint8)
    px[:n_px] = raw.reshape(n_px, channels)

    packed = pixels_to_packed(jnp.asarray(px.reshape(-1)), channels)
    header = jnp.asarray(
        np.frombuffer(write_header(desc), dtype=np.uint8)
    )
    out, total_len = enc_ops.encode_core(
        packed, jnp.int32(n_px), header, channels=channels
    )
    total = int(total_len)
    return np.asarray(out[:total])


def decode_single(data: np.ndarray, desc: Desc, dst_channels: Channels) -> np.ndarray:
    """Decode one QOI byte stream -> raw bytes (numpy), bit-exact with the
    reference decoder for all inputs, including truncated/tolerant streams
    (ops/decode.py handles tolerance directly — no oracle fallback)."""
    _ensure_cache()
    from . import decode as dec_ops

    return dec_ops.decode_single(data, desc, dst_channels)
