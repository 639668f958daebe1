"""Sharded codec pipelines: data-parallel batches and sequence-parallel
single-image decode over a jax.sharding.Mesh.

DP: images shard over the `data` axis; each device runs the batched codec
(replay kernel included) on its own shard under shard_map — embarrassingly
parallel, collectives only for summary stats.

SP (the codec's ring-attention-shaped problem, SURVEY.md §5 "long
context"): one image's chunk tiles shard over the `seq` axis.  Each device
replays its local tiles speculatively (ops/decode replay scan); the device-
boundary carry (prev pixel + 64-entry table — the ~260-byte state vector of
SURVEY.md §5) travels to the right neighbor via lax.ppermute, and a
device-count-bounded fixpoint loop (the multi-device extension of the
single-device reconciliation) converges to the exact sequential semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import decode as dec_ops
from ..ops import encode as enc_ops
from ..ops.bitops import START_PIXEL_PACKED, hash6


# --------------------------------------------------------------------------
# Data-parallel batch codec
# --------------------------------------------------------------------------


def make_dp_decode(pipeline, mesh: Mesh, axis: str = "data"):
    """The pipeline's batched decode with the batch sharded over `axis`.

    shard_map runs the per-device body on each device's own images: XLA
    cannot partition the replay kernel's custom call, so each device
    replays its own lanes.  A psum'd checksum exercises the cross-device
    reduction for observability.  The batch must divide by the axis size.
    """

    def body(streams, sizes):
        packed = pipeline._decode_impl(streams, sizes)
        checksum = jax.lax.psum(jnp.sum(packed.astype(jnp.uint32)), axis)
        return packed, checksum

    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P()),
        check_vma=False,
    ))


def make_dp_encode(pipeline, mesh: Mesh, axis: str = "data"):
    """The pipeline's batched encode with the batch sharded over `axis`
    (per-device body under shard_map, as make_dp_decode)."""
    dp_encode_checked = jax.jit(shard_map(
        pipeline._encode_impl, mesh=mesh,
        in_specs=(P(axis, None),),
        out_specs=(P(axis, None), P(axis), P(axis)),
        check_vma=False,
    ))

    def dp_encode(packed):
        streams, lengths, ok = dp_encode_checked(packed)
        # Same contract as pipeline.encode_packed: overflow of the per-image
        # byte cap is an error, never a silently truncated stream.
        if not bool(jnp.all(ok)):
            bad = [i for i, o in enumerate(jax.device_get(ok)) if not o]
            raise ValueError(
                f"dp_encode: images {bad} exceed max_encode_len; rebuild the "
                "pipeline with a larger cap (worst_size) for these images"
            )
        return streams, lengths

    return dp_encode


# --------------------------------------------------------------------------
# Sequence-parallel single-image decode
# --------------------------------------------------------------------------


def make_sp_decode(mesh: Mesh, qb: int, tiles_per_device: int,
                   axis: str = "seq", with_rounds: bool = False):
    """Build a sequence-parallel byte-domain chunk replay: the dense chunk
    field arrays of length qb (from ops.decode.classify_dense) are sharded
    over `axis`; returns per-byte-position emitted pixel values (sharded the
    same way), bit-exact with the sequential decode.

    Each fixpoint round: local tile replay, then within-device transfer-
    summary propagation seeded by the left neighbor's last-tile out-state
    (exchanged via lax.ppermute).  Convergence crosses one device
    per round worst-case, all tiles per round within a device.

    Worst-case bound (proved by induction, pinned by
    tests/test_parallel.py::test_sp_decode_adversarial_rounds): after
    round r the first r tiles' entering states are exact — tile 0 starts
    exact (START pixel + seeded table, reference stream.cpp:306), and
    each round propagates the true carry at least one tile further even
    when EVERY chunk is an INDEX hit on an unresolved slot.  Hence
    n_tiles + 1 rounds always suffice and the loop cap n_tiles + 2 never
    truncates: the output is exact for adversarial streams too, they
    just pay O(n_tiles) rounds instead of the typical O(1).  (A
    closed-form carry like SP encode's is impossible here: the decoder's
    table entries are functions of decoded pixels, which in turn read
    the table — the INDEX data dependence is inherently sequential.)

    qb must divide evenly: qb = n_devices * tiles_per_device * t_len.
    with_rounds: additionally return a (qb,)-sharded int32 array holding
    the fixpoint round count (replicated per position) for bound tests.
    """
    n_dev = mesh.shape[axis]
    assert qb % (n_dev * tiles_per_device) == 0
    t_len = qb // (n_dev * tiles_per_device)
    s_local = tiles_per_device

    spec = P(axis)
    _step = dec_ops._replay_step

    def local_replay(in_p, in_s, xs):
        zero_pu = jnp.zeros((s_local,), bool)
        zero_sw = jnp.zeros((s_local, 64), bool)
        (p, s, pu, sw), ys = jax.lax.scan(
            _step, (in_p, in_s, zero_pu, zero_sw), xs
        )
        return p, s, pu, sw, ys

    def sp_body(cls, val, nmask, arg):
        # local shapes: (q_local,) with q_local = s_local * t_len
        my = jax.lax.axis_index(axis)
        to_tiles = lambda x: x.reshape(s_local, t_len).T
        xs = (to_tiles(cls), to_tiles(val), to_tiles(nmask), to_tiles(arg))

        prev0, seen0 = dec_ops._true_init_row()

        def round_fn(state):
            in_p, in_s, _, it = state
            out_p, out_s, out_pu, out_sw, _ = local_replay(in_p, in_s, xs)
            # my last tile's out-state -> right neighbor's base state
            perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
            nbr_p = jax.lax.ppermute(out_p[-1:], axis, perm)
            nbr_s = jax.lax.ppermute(out_s[-1:], axis, perm)
            base_p = jnp.where(my == 0, prev0, nbr_p[0])
            base_s = jnp.where(my == 0, seen0[None, :], nbr_s)
            want_p, want_s = dec_ops._propagate(
                out_p, out_s, out_pu, out_sw, base_p, base_s
            )
            local_match = jnp.all(want_p == in_p) & jnp.all(want_s == in_s)
            all_match = jax.lax.pmin(local_match.astype(jnp.int32), axis)
            return want_p, want_s, all_match > 0, it + 1

        def cond(state):
            _, _, done, it = state
            return (~done) & (it < n_dev * s_local + 2)

        # Speculative init: START everywhere (== the true prev for tile 0);
        # only the globally-first tile gets the seeded table.
        is_first = (jnp.arange(s_local) + my * s_local) == 0
        init_p = jnp.full((s_local,), START_PIXEL_PACKED, jnp.uint32)
        init_s = jnp.where(
            is_first[:, None], seen0[None, :], jnp.zeros((s_local, 64), jnp.uint32)
        )

        fin_p, fin_s, _, it = jax.lax.while_loop(
            cond, round_fn, (init_p, init_s, jnp.array(False), jnp.int32(0))
        )
        _, _, _, _, (emits, prevs) = local_replay(fin_p, fin_s, xs)
        emits_f = emits.T.reshape(-1)
        if with_rounds:
            rounds = jnp.full_like(emits_f, it).astype(jnp.int32)
            return emits_f, prevs.T.reshape(-1), rounds
        return emits_f, prevs.T.reshape(-1)

    sharded = shard_map(
        sp_body,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec, spec, spec) if with_rounds else (spec, spec),
        check_vma=False,
    )
    return jax.jit(sharded)


# --------------------------------------------------------------------------
# Sequence-parallel single-image encode
# --------------------------------------------------------------------------


def make_sp_encode(mesh: Mesh, n_local: int, channels: int, axis: str = "seq"):
    """Sequence-parallel windowed encode: ONE image's pixels shard over
    `axis` (contiguous windows of n_local packed pixels per device), each
    device encodes its window bit-exactly after a closed-form carry
    exchange — no sequential device chain and no fixpoint.

    Unlike decode, the encoder's carried state is a *pure function of the
    pixel prefix* (the table-is-pure-function theorem, ops/encode.py): the
    entering prev pixel is the left neighbor's last pixel (lax.ppermute),
    the entering run counter follows from per-shard (trailing-streak,
    whole-shard-equal) summaries under mod-62 flush arithmetic, and the
    entering table is an exclusive overwrite-combine of per-shard 64-slot
    summaries (all_gather of 64 words/shard).  Every shard then
    runs the dense field pass + emission independently.

    Returns fn: (n_dev*n_local,) u32 packed pixels (sharded P(axis)),
    n_px_last (traced: valid pixels in the LAST shard; earlier shards must
    be full) -> ((n_dev, w_cap) u8 bodies sharded P(axis), (n_dev,) i32
    lengths).  The caller assembles header + concat(bodies[s][:len[s]]);
    the last shard's body ends with the trailing run + end marker
    (reference: source/simple.cpp:91-95).
    """
    n_dev = mesh.shape[axis]
    assert n_local % enc_ops.TILE == 0
    w_cap = (channels + 1) * n_local + 16

    def sp_body(packed_col, n_px_last):
        packed = packed_col[:, 0]
        my = jax.lax.axis_index(axis)
        is_last = my == n_dev - 1
        n_px = jnp.where(is_last, n_px_last, n_local)

        # ---- carry 1: prev pixel from the left neighbor ------------------
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        nbr_last = jax.lax.ppermute(packed[-1:], axis, perm)
        prev_in = jnp.where(
            my == 0, jnp.uint32(START_PIXEL_PACKED), nbr_last[0]
        )

        # ---- local summaries (given prev_in) -----------------------------
        idx = jnp.arange(n_local, dtype=jnp.int32)
        valid = idx < n_px
        prev_arr = jnp.concatenate([prev_in[None], packed[:-1]])
        eq = (packed == prev_arr) & valid
        # trailing streak length ending at the last valid pixel
        brk = jnp.max(jnp.where(valid & ~eq, idx + 1, 0))
        t_tail = jnp.maximum(n_px - brk, 0)
        full = brk == 0  # whole shard extends the incoming streak

        # 64-slot table summary: last differing pixel per slot
        h = hash6(packed)
        noneq = valid & ~eq
        slot_ids = jnp.arange(64, dtype=jnp.int32)
        m = (h[None, :] == slot_ids[:, None]) & noneq[None, :]
        jbest = jnp.max(jnp.where(m, idx[None, :] + 1, 0), axis=1)
        sel = (idx[None, :] + 1) == jbest[:, None]
        vals = jnp.sum(jnp.where(sel, packed[None, :], jnp.uint32(0)), axis=1)
        written = jbest > 0  # (64,)

        # ---- cross-shard exclusive combines (tiny all_gathers) -----------
        g_full = jax.lax.all_gather(full, axis)            # (n_dev,)
        g_tail = jax.lax.all_gather(t_tail, axis)          # (n_dev,)
        g_vals = jax.lax.all_gather(vals, axis)            # (n_dev, 64)
        g_writ = jax.lax.all_gather(written, axis)         # (n_dev, 64)
        g_npx = jax.lax.all_gather(n_px, axis)             # (n_dev,)

        run_ins = [jnp.int32(0)]
        for s in range(n_dev - 1):
            run_ins.append(
                jnp.where(
                    g_full[s],
                    (run_ins[s] + g_npx[s]) % 62,
                    g_tail[s] % 62,
                )
            )
        run_in = jnp.sum(
            jnp.where(jnp.arange(n_dev) == my, jnp.stack(run_ins), 0)
        ).astype(jnp.uint32)

        seen = jnp.zeros(64, jnp.uint32)
        seen_ins = [seen]
        for s in range(n_dev - 1):
            seen_ins.append(jnp.where(g_writ[s], g_vals[s], seen_ins[s]))
        hot = (jnp.arange(n_dev) == my)[:, None]
        seen_in = jnp.sum(
            jnp.where(hot, jnp.stack(seen_ins), jnp.uint32(0)), axis=0
        )

        # ---- independent window encode + emission ------------------------
        template, nbytes, tail, has_trail = enc_ops._encode_fields(
            packed, n_px, channels,
            carry_prev=prev_in, carry_run=run_in, carry_seen=seen_in,
        )
        offsets = jnp.cumsum(nbytes) - nbytes
        chunks_end = jnp.sum(nbytes)
        out = jnp.zeros(w_cap + 1, jnp.uint8)
        for k in range(6):
            contrib = jnp.where(k < nbytes, template[:, k], 0)
            idx_k = jnp.minimum(offsets + k, w_cap)
            out = out.at[idx_k].add(contrib, indices_are_sorted=True)
        # last shard appends trailing run + end marker
        tail_len = jnp.where(
            is_last, jnp.where(has_trail, 9, 8), 0
        ).astype(jnp.int32)
        tail_pad = jnp.zeros(w_cap + 1 - 9, jnp.uint8)
        tail_full = jnp.concatenate([tail, tail_pad])
        out = jnp.where(
            (jnp.arange(w_cap + 1) - chunks_end < tail_len)
            & (jnp.arange(w_cap + 1) >= chunks_end),
            jnp.roll(tail_full, chunks_end),
            out,
        )
        length = chunks_end + tail_len
        return out[None, :w_cap], length[None]

    spec = P(axis)
    fn = shard_map(
        sp_body,
        mesh=mesh,
        in_specs=(P(axis, None), P()),
        out_specs=(spec, spec),
        check_vma=False,
    )

    @jax.jit
    def sp_encode(packed_flat, n_px_last):
        return fn(packed_flat[:, None], n_px_last)

    return sp_encode
