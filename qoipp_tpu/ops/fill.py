"""Fill-forward ("last participating value at or before q") as a handful of
native cummax primitives.

Instead of an associative_scan or gathers, we pack (position-tag,
payload-piece) into uint32 words and take cummax: every piece's maximum is
attained at the same (latest participating) position, so the pieces can be
re-assembled afterwards.  k = ceil(payload_bits / (32 - pos_bits)) cummax
calls total — all primitive, fast to compile, HBM-bandwidth bound.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp


def _plan(n: int, payload_bits: int) -> Tuple[int, int]:
    """(piece_width, num_pieces) for arrays of length n along the scan axis."""
    pos_bits = max((n + 1).bit_length(), 1)
    w = 32 - pos_bits
    assert w >= 2, f"axis too long for u32 piece-cummax: {n}"
    k = -(-payload_bits // w)
    return w, k


def fill_forward(
    payloads: Sequence[Tuple[jnp.ndarray, int]],
    participate,
    valid,
    axis: int = -1,
):
    """Inclusive fill-forward along `axis`.

    payloads: [(uint32 array, bit_width), ...] — defined at participating
        positions (garbage elsewhere).
    participate: bool array — positions that enter the forward chain.
    valid: bool array — participating positions that carry a USABLE value;
        a participating-but-invalid position ("poison") blocks the chain.

    Returns (values, got, ok):
      values: list of filled payload arrays (garbage where not got)
      got:    a participating position exists at or before q
      ok:     that latest participating position was valid
    """
    arrs = [a.astype(jnp.uint32) for a, _ in payloads]
    widths = [b for _, b in payloads]
    n = arrs[0].shape[axis]
    total_bits = sum(widths) + 1  # +1 for the valid bit
    w, k = _plan(n, total_bits)

    # Assemble payload pieces (valid bit first, then payloads LSB-first).
    comps = [(valid.astype(jnp.uint32), 1)] + [
        (a & ((1 << b) - 1) if b < 32 else a, b) for a, b in zip(arrs, widths)
    ]
    pieces: List[jnp.ndarray] = []
    acc = jnp.zeros_like(arrs[0])
    acc_bits = 0
    for comp, bits in comps:
        comp = comp.astype(jnp.uint32)
        while bits > 0:
            take = min(bits, w - acc_bits)
            acc = acc | ((comp & ((1 << take) - 1)) << acc_bits)
            comp = comp >> take
            bits -= take
            acc_bits += take
            if acc_bits == w:
                pieces.append(acc)
                acc = jnp.zeros_like(arrs[0])
                acc_bits = 0
    if acc_bits > 0:
        pieces.append(acc)
    assert len(pieces) == k, (len(pieces), k)

    # Position tag in the high bits; 0 = "nothing yet".
    shape = [1] * arrs[0].ndim
    shape[axis] = n
    tag = (jnp.arange(1, n + 1, dtype=jnp.uint32)).reshape(shape)
    part = participate

    filled_pieces = []
    for piece in pieces:
        word = jnp.where(part, (tag << w) | piece, 0)
        cm = jax.lax.cummax(word, axis=axis if axis >= 0 else arrs[0].ndim + axis)
        filled_pieces.append(cm)

    got = (filled_pieces[0] >> w) > 0

    # Re-extract components field-wise (a field spans at most
    # ceil(bits/w)+1 pieces; shift-or them together).
    piece_vals = [cm & ((1 << w) - 1) for cm in filled_pieces]

    def extract(offset: int, bits: int):
        v = jnp.zeros_like(arrs[0])
        taken = 0
        while taken < bits:
            pi, po = divmod(offset + taken, w)
            take = min(bits - taken, w - po)
            v = v | (((piece_vals[pi] >> po) & ((1 << take) - 1)) << taken)
            taken += take
        return v

    ok = got & (extract(0, 1) > 0)
    values = []
    cursor = 1
    for _, bits in payloads:
        values.append(extract(cursor, bits))
        cursor += bits
    return values, got, ok
