"""Length-bucketed batch scheduler for mixed-density corpora.

The batched pipeline is shape-static: every lane pays the batch's WORST
stream length (replay steps = qb = max stream bytes) and worst encode
caps.  On uniform synthetic corpora that costs little, but on real mixed
corpora (icons next to noise-heavy screenshots) one dense image can tax
every lane 10-50x — measured on the real-image corpus: un-bucketed
batched decode barely matched the single-thread oracle.

The remedy is the same one used for sequence batching in NLP serving:
bucket by length.  Streams are grouped into geometric length
buckets, each bucket runs the batched pipeline at its own tight qb, and
results are reassembled in submission order.  Shapes stay bounded (one
compile per (bucket_qb, padded_B) pair, both drawn from geometric grids)
so jit caches converge quickly in steady-state serving.

The reference has no analog (it decodes files one by one,
example/source/04_bench.cpp:849-871); this component exists because the
device's shape-static batched execution demands it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import Channels, Desc
from .pipeline import BatchPipeline

# Batch-count pad grid: <= 1.5-ratio steps from 1.  Pipelines are cached
# per (geometry, length-bucket) already, so a smaller floor does not
# multiply compile shapes across geometries — it only bounds
# per-geometry count variation at ~2 log2(n) entries.  The old floor of
# 8 made every singleton-geometry image (common in serving corpora: each
# big photo is its own geometry) pay 8x padded upload + encode/decode
# work; this grid bounds residual zero-pad work at <= 50% (<= 33% below
# n=17, where small corpora actually land).  Measured round 4: the
# serving ENCODE bucket tier spent seconds uploading + encoding zero
# padding under the old floor.
_B_GRID = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _pad_b(n: int) -> int:
    for g in _B_GRID:
        if n <= g:
            return g
    return -(-n // 256) * 256


class BucketedCodec:
    """Batched QOI codec with geometric length bucketing.

    Parameters
    ----------
    desc: shared image geometry.
    growth: bucket boundary ratio (2.0 -> qb buckets 16K, 32K, 64K, ...).
    min_len: smallest bucket's stream capacity in bytes.
    """

    def __init__(self, desc: Desc, growth: float = 2.0,
                 min_len: int = 1 << 14):
        assert growth > 1.2
        self.desc = desc
        self.growth = growth
        self.min_len = min_len
        self._pipes: Dict[int, BatchPipeline] = {}

    def _bucket_len(self, max_len: int) -> int:
        cap = self.min_len
        while cap < max_len:
            cap = int(cap * self.growth)
        return cap

    def _pipe(self, bucket_len: int) -> BatchPipeline:
        pipe = self._pipes.get(bucket_len)
        if pipe is None:
            pipe = BatchPipeline(
                self.desc,
                max_stream_len=bucket_len,
                max_encode_len=bucket_len,
            )
            self._pipes[bucket_len] = pipe
        return pipe

    def _group(self, sizes: Sequence[int]) -> Dict[int, List[int]]:
        groups: Dict[int, List[int]] = {}
        for i, s in enumerate(sizes):
            groups.setdefault(self._bucket_len(int(s)), []).append(i)
        return groups

    # -- decode -----------------------------------------------------------

    def prepare(self, blobs: Sequence) -> List[Tuple[List[int], BatchPipeline,
                                                     object, object]]:
        """Host-side staging: group streams into buckets, pack each group
        and put it on device.  Returns [(indices, pipe, streams, sizes)].
        In a serving loop this overlaps with the previous batch's device
        work; time only decode_prepared for steady-state throughput."""
        import jax.numpy as jnp

        arrs = [
            np.frombuffer(bytes(x), np.uint8)
            if not isinstance(x, np.ndarray) else x
            for x in blobs
        ]
        out = []
        for bucket_len, idxs in self._group([a.size for a in arrs]).items():
            pipe = self._pipe(bucket_len)
            bp = _pad_b(len(idxs))
            group = [arrs[i] for i in idxs]
            # pad lanes with header-only streams (decode to start pixels)
            group += [group[0][:14]] * (bp - len(idxs))
            streams, sizes = pipe.pack_streams(group)
            out.append(
                (idxs, pipe, jnp.asarray(streams), jnp.asarray(sizes))
            )
        return out

    def decode_prepared(self, plan) -> List[Tuple[List[int], object]]:
        """Dispatch every bucket's batched decode (async); returns
        [(indices, (Bp, n_cap) device packed pixels)] — device-resident,
        submission indices attached."""
        return [
            (idxs, pipe.decode_packed(streams, sizes))
            for idxs, pipe, streams, sizes in plan
        ]

    def decode(self, blobs: Sequence, target: Optional[Channels] = None
               ) -> np.ndarray:
        """QOI byte streams (shared geometry, any lengths) ->
        (B, H, W, C) uint8 in submission order (host convenience over
        prepare + decode_prepared)."""
        from .pipeline import _unpack_images

        ch = int(target) if target is not None else int(self.desc.channels)
        b = len(blobs)
        out = np.empty(
            (b, self.desc.height, self.desc.width, ch), np.uint8
        )
        for idxs, pipe, streams, sizes in self.prepare(blobs):
            packed = pipe.decode_packed(streams, sizes)[:, : pipe.n_px]
            imgs = np.asarray(_unpack_images(
                packed, self.desc.height, self.desc.width, ch
            ))
            out[idxs] = imgs[: len(idxs)]
        return out

    # -- encode -----------------------------------------------------------

    def encode(self, raws, size_hints: Optional[Sequence[int]] = None
               ) -> List[np.ndarray]:
        """(B, ...) uint8 raw images -> list of QOI streams in submission
        order.

        size_hints: optional per-image expected stream sizes (e.g. from a
        previous epoch or the source file sizes); images bucket by hint so
        compressible ones avoid worst-case caps.  Without hints all images
        share the worst-size bucket (still correct; encode() re-runs any
        image whose stream overflows its bucket in the next bucket up).
        """
        import jax
        import jax.numpy as jnp

        from ..ops.bitops import pixels_to_packed

        raws = np.asarray(raws, np.uint8).reshape(len(raws), -1)
        b = raws.shape[0]
        ch = int(self.desc.channels)
        worst = (ch + 1) * self.desc.width * self.desc.height + 22
        hints = (
            [int(h) for h in size_hints] if size_hints is not None
            else [worst] * b
        )
        out: List[Optional[np.ndarray]] = [None] * b
        pending = list(range(b))
        while pending:
            groups = self._group([min(hints[i], worst) for i in pending])
            next_pending: List[int] = []
            for bucket_len, gi in groups.items():
                idxs = [pending[i] for i in gi]
                pipe = self._pipe(bucket_len)
                bp = _pad_b(len(idxs))
                batch = np.zeros((bp, raws.shape[1]), np.uint8)
                batch[: len(idxs)] = raws[idxs]
                packed = jax.vmap(
                    lambda r: pixels_to_packed(r, ch)
                )(jnp.asarray(batch))
                pad = pipe.nb - pipe.n_px
                if pad:
                    packed = jnp.pad(packed, ((0, 0), (0, pad)))
                streams, lengths, ok = pipe.encode_packed_checked(packed)
                # fetch lengths first (tiny), then only the real byte
                # span, so dead capacity is never copied to the host
                lengths = np.asarray(lengths)
                okh = np.asarray(ok)
                used = int(lengths[: len(idxs)].max(initial=1))
                streams = np.asarray(streams[:, : -(-used // 128) * 128])
                for j, i in enumerate(idxs):
                    if okh[j]:
                        out[i] = streams[j, : lengths[j]].copy()
                    else:  # overflowed the bucket: retry one bucket up
                        hints[i] = int(bucket_len * self.growth)
                        next_pending.append(i)
            pending = next_pending
        return out  # type: ignore[return-value]
