"""Batched device-resident codec pipelines — the framework's flagship path.

The reference processes one image per call on one CPU thread (its bench
iterates a directory serially — 04_bench.cpp:849-871).  Here many images
batch into fixed-shape device arrays and run the parallel codec (ops/)
with all lanes fused: decoded RGB/RGBA planes land directly in device
memory as JAX arrays for vision-pipeline ingest, and encode streams come
back as (B, worst_size) byte rows plus lengths.

All shapes are static per (desc, caps) so jit caches stay warm across
batches; per-image variability travels in `sizes` scalars.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import Channels, Desc, write_header
from ..ops import boundary
from ..ops import decode as dec_ops
from ..ops import encode as enc_ops
from ..ops import sparse
from ..ops.bitops import pixels_to_packed


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class BatchPipeline:
    """Fixed-geometry batched QOI codec for a uniform image shape.

    Parameters
    ----------
    desc: image geometry (width/height/channels shared by the batch).
    max_stream_len: longest QOI stream (bytes) the decode path must accept;
        defaults to worst_size(desc).  Tighter bounds shorten the replay.
    max_encode_len: longest QOI stream the encode path may produce;
        defaults to worst_size(desc).  Tighter bounds shrink the encode
        emission's output buffer and the chunk-compaction buffers
        (chunk count <= stream bytes); images that overflow the bound are
        flagged by encode_checked, and encode() raises on them.
    """

    def __init__(
        self,
        desc: Desc,
        max_stream_len: Optional[int] = None,
        max_encode_len: Optional[int] = None,
    ):
        self.desc = desc
        self.channels = int(desc.channels)
        self.n_px = desc.width * desc.height

        worst = (self.channels + 1) * self.n_px + 22
        max_stream_len = max_stream_len or worst
        self.max_encode_len = max_encode_len or worst
        self.qb = _round_up(max(max_stream_len - 14, boundary.BLOCK), boundary.BLOCK)
        self.l_cap = 14 + self.qb + 8  # stream rows carry 8 bytes of slack

        self.n_cap = _round_up(self.n_px, sparse.WIN)

        self.nb = enc_ops.pad_to_tile(self.n_px)
        self._header = jnp.asarray(
            np.frombuffer(write_header(desc), dtype=np.uint8)
        )

        self._decode = jax.jit(self._decode_impl)
        self._encode = jax.jit(self._encode_impl)
        self._enc_raw = None
        self._enc_chunked = {}

    # -- decode ------------------------------------------------------------

    def _decode_impl(self, streams, sizes):
        from ..ops import replay_kernel as rk

        regions = streams[:, 14:]
        q = jnp.arange(regions.shape[1], dtype=jnp.int32)[None, :]
        regions = jnp.where(q < (sizes - 14)[:, None], regions, 0)
        info = boundary.analyze_region_batch(
            regions[:, : self.qb], sizes - 22, jnp.int32(self.n_px)
        )
        real, pix_before = info["real"], info["pix_before"]
        meta, val = dec_ops.fields_dense_batch(regions, real)  # (B, qb)
        emits = rk.replay_batch(meta.T, val.T).T  # (B, qb)
        # exact for all input, incl. crafted streams
        return sparse.place_pixels(pix_before, emits, self.n_cap)

    def decode_packed(self, streams, sizes):
        """(B, l_cap) u8 streams + (B,) sizes -> (B, n_cap) packed uint32
        pixels (device-resident; [:, :n_px] are valid)."""
        return self._decode(streams, sizes)

    def decode(self, streams, sizes, target: Optional[Channels] = None):
        """-> (B, H, W, C) uint8 device array."""
        ch = int(target) if target is not None else self.channels
        packed = self.decode_packed(streams, sizes)[:, : self.n_px]
        return _unpack_images(packed, self.desc.height, self.desc.width, ch)

    # -- encode ------------------------------------------------------------

    def _encode_impl(self, packed):
        # chunk count is bounded both by emitting pixels and stream bytes
        chunk_cap = min(self.nb, self.max_encode_len)
        return enc_ops.encode_batch_checked(
            packed, jnp.int32(self.n_px), self._header,
            channels=self.channels,
            chunk_cap=chunk_cap + 2048 + 256,
            out_cap=self.max_encode_len,
        )

    def encode_packed(self, packed):
        """(B, nb) packed uint32 pixels -> ((B, out_cap) u8 streams, (B,)
        lengths).  Raises if any image overflows max_encode_len."""
        out, lengths, ok = self._encode(packed)
        if not bool(jnp.all(ok)):
            raise ValueError(
                "encode overflow: an image exceeded max_encode_len="
                f"{self.max_encode_len}; re-create the pipeline with a "
                "larger bound (default: worst size) for these images"
            )
        return out, lengths

    def encode_packed_checked(self, packed):
        """Like encode_packed but returns (streams, lengths, ok) without
        raising; streams flagged not-ok must be re-encoded with a larger
        bound."""
        return self._encode(packed)

    def encode_packed_chunked(self, packed, sub: int = 32):
        """Whole-batch encode in ONE device dispatch, iterating sub-batches
        of `sub` images inside the compiled program (lax.map reuses the
        dense per-pixel field planes — ~10x the input — across iterations,
        bounding memory like a host-side sub-batch loop but in one
        dispatch).  Returns (streams, lengths, ok) like
        encode_packed_checked.  B must be a multiple of `sub`."""
        b = packed.shape[0]
        if b % sub:
            raise ValueError(f"batch {b} not a multiple of sub={sub}")
        key = (b, sub)
        fn = self._enc_chunked.get(key)
        if fn is None:
            nsub = b // sub

            @jax.jit
            def fn(p):
                out, lengths, ok = jax.lax.map(
                    self._encode_impl, p.reshape(nsub, sub, -1)
                )
                return (out.reshape(b, -1), lengths.reshape(b),
                        ok.reshape(b))

            self._enc_chunked[key] = fn
        return fn(packed)

    def _encode_raw_impl(self, raws):
        packed = jax.vmap(lambda r: pixels_to_packed(r, self.channels))(raws)
        pad = self.nb - self.n_px
        if pad:
            packed = jnp.pad(packed, ((0, 0), (0, pad)))
        return self._encode_impl(packed)

    def encode_raw_checked(self, raws):
        """(B, n_px*C) uint8 device/host array -> (streams, lengths, ok)
        in ONE dispatch: pixel packing + padding + encode fused into one
        program (eager packing would add two dispatches per batch)."""
        if self._enc_raw is None:
            self._enc_raw = jax.jit(self._encode_raw_impl)
        return self._enc_raw(raws)

    def encode(self, raws):
        """(B, H, W, C) or (B, n_px*C) uint8 -> (streams, lengths)."""
        raws = jnp.asarray(raws, dtype=jnp.uint8).reshape(raws.shape[0], -1)
        out, lengths, ok = self.encode_raw_checked(raws)
        if not bool(jnp.all(ok)):
            raise ValueError(
                "encode overflow: an image exceeded max_encode_len="
                f"{self.max_encode_len}; re-create the pipeline with a "
                "larger bound (default: worst size) for these images"
            )
        return out, lengths

    # -- host conveniences -------------------------------------------------

    def load_files(self, paths) -> Tuple[np.ndarray, np.ndarray]:
        """Native batch loader: QOI files -> ((B, l_cap) u8, (B,) i32)
        via one C pass (native/qoi_ref.cpp qoiref_pack_files)."""
        from .. import oracle

        return oracle.pack_files(list(paths), self.l_cap)

    def pack_streams(self, blobs) -> Tuple[np.ndarray, np.ndarray]:
        """List of qoi byte strings/arrays -> ((B, l_cap) u8, (B,) i32)."""
        b = len(blobs)
        out = np.zeros((b, self.l_cap), dtype=np.uint8)
        sizes = np.zeros(b, dtype=np.int32)
        for i, blob in enumerate(blobs):
            arr = np.frombuffer(bytes(blob), np.uint8) if not isinstance(
                blob, np.ndarray
            ) else blob
            if arr.size > self.l_cap:
                raise ValueError(
                    f"stream {i}: {arr.size} bytes exceeds pipeline l_cap "
                    f"{self.l_cap}"
                )
            out[i, : arr.size] = arr
            sizes[i] = arr.size
        return out, sizes


@partial(jax.jit, static_argnames=("height", "width", "channels"))
def _unpack_images(packed, height: int, width: int, channels: int):
    chans = [
        ((packed >> (8 * c)) & 0xFF).astype(jnp.uint8) for c in range(channels)
    ]
    img = jnp.stack(chans, axis=-1)
    return img.reshape(packed.shape[0], height, width, channels)
