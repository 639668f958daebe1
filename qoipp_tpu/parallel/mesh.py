"""Device mesh helpers.

The reference has no parallelism (SURVEY.md §2d) — here batches of images
shard over a `data` mesh axis (DP) and a single image's chunk stream can
shard over a `seq` axis (the codec's sequence-parallel analog), with seam
state exchanged via collectives (parallel/sharded.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "seq"),
) -> Mesh:
    """Build a device mesh.  Default: all devices on `data`, 1 on `seq`."""
    devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    assert int(np.prod(shape)) == n, f"mesh {shape} != {n} devices"
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))


def data_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) dimension over `axis`, replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def make_hybrid_mesh(
    axis_names: Sequence[str] = ("host", "data", "seq"),
    hosts: Optional[int] = None,
) -> Mesh:
    """Multi-host mesh layout: host x data x seq.

    The layout follows the algorithm, not a link topology: the cards of
    one host reach each other all to all at one rate (NVLink), so only the
    process boundary is a real hierarchy level.

    * `host` strides across processes and carries only the
      embarrassingly-parallel batch dimension (no communication in the
      codec body; only optional psum'd stats).
    * `data` carries the batch inside a host.
    * `seq` carries the sequence-parallel seam exchange (ppermute /
      all_gather of the ~260-byte carry state, parallel/sharded.py); it
      stays inside a host, so no seam crosses a process boundary.

    Under jax.distributed each process contributes jax.local_device_count()
    devices; `hosts` defaults to jax.process_count().  On a single host
    (or the CPU-simulated mesh) the host axis is 1 and the layout reduces
    to make_mesh semantics — which is how the hermetic tests and the
    dryrun exercise it.
    """
    devices = jax.devices()
    n = len(devices)
    if hosts is None:
        hosts = jax.process_count()
    assert n % hosts == 0
    per_host = n // hosts
    # seq gets the largest power-of-two <= per_host that the sp paths can
    # use; the remainder goes to data.
    seq = 1
    while seq * 2 <= per_host and per_host % (seq * 2) == 0 and seq < 4:
        seq *= 2
    data = per_host // seq
    arr = np.array(devices).reshape(hosts, data, seq)
    return Mesh(arr, axis_names=tuple(axis_names))
