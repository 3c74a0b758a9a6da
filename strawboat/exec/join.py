"""Equi-join — sort build side + binary-search probe.

The radix-partitioned hash join of classic engines maps to a vectorized
device as: sort the build side by key (one-time), then probe with vectorized
``searchsorted`` (log-time gather chains, no pointer chasing).  Duplicate build keys are handled by expanding match runs up to a
static ``max_matches_per_key`` fan-out.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("max_fanout",))
def _join_indices(
    build_keys: jax.Array,
    probe_keys: jax.Array,
    max_fanout: int,
    build_valid: jax.Array | None = None,
):
    """Inner-join row indices.

    Returns (probe_idx, build_idx, valid, max_run) each index array of shape
    (n_probe * max_fanout,): for every probe row, up to ``max_fanout``
    matching build rows.  ``max_run`` is the true largest match count per
    probe key — when it exceeds ``max_fanout``, matches were truncated and
    the caller must retry with a larger fan-out (``hash_join`` does).

    ``build_valid`` masks null build rows out of the match set directly (no
    in-band sentinel value: a legitimate key equal to any sentinel would
    otherwise spuriously match nulls).  Null rows sort after every valid row
    and every match range is clipped to the valid prefix, so they neither
    match nor count toward ``max_run`` (padding rows of an exchange all
    carry one key, and counting them would blow up the fan-out).
    """
    if build_valid is None:
        order = jnp.argsort(build_keys)
        sk = build_keys[order]
        n_valid = sk.shape[0]
    else:
        order = jnp.lexsort((build_keys, ~build_valid))
        n_valid = jnp.sum(build_valid, dtype=jnp.int32)
        dt = build_keys.dtype
        top = jnp.iinfo(dt).max if jnp.issubdtype(dt, jnp.integer) else jnp.inf
        pos = jnp.arange(build_keys.shape[0])
        # the null suffix reads as the dtype's top value, so the whole array
        # stays sorted; clipping lo/hi at n_valid drops it from every range
        sk = jnp.where(pos < n_valid, build_keys[order], top)
    lo = jnp.minimum(jnp.searchsorted(sk, probe_keys, side="left"), n_valid)
    hi = jnp.minimum(jnp.searchsorted(sk, probe_keys, side="right"), n_valid)
    n_probe = probe_keys.shape[0]
    k = jnp.arange(max_fanout, dtype=lo.dtype)
    idx = lo[:, None] + k[None, :]  # (n_probe, max_fanout)
    valid = idx < hi[:, None]
    idx = jnp.clip(idx, 0, sk.shape[0] - 1)
    build_idx = order[idx]
    probe_idx = jnp.broadcast_to(
        jnp.arange(n_probe, dtype=lo.dtype)[:, None], idx.shape
    )
    max_run = jnp.max(hi - lo) if n_probe else jnp.zeros((), lo.dtype)
    return (
        probe_idx.reshape(-1),
        build_idx.reshape(-1),
        valid.reshape(-1),
        max_run.astype(jnp.int32),
    )


def hash_join(
    probe_table,
    build_table,
    on: Tuple[str, str],
    max_fanout: int = 1,
    probe_mask: Optional[jax.Array] = None,
    on_overflow: str = "grow",
):
    """Inner equi-join; returns (probe_idx, build_idx, valid) selection.

    ``max_fanout`` bounds duplicate build keys per probe row (1 = unique
    build keys, the dimension-join case).  Null keys never match.
    Truncated matches never pass silently: when a build key repeats more
    than ``max_fanout`` times, ``on_overflow="grow"`` (default) re-runs with
    the true fan-out; ``"raise"`` raises :class:`CapacityError`.
    """
    from ..errors import CapacityError

    pk = probe_table[on[0]]
    bk = build_table[on[1]]
    probe_keys = pk.values
    build_keys = bk.values
    fanout = max_fanout
    while True:
        pi, bi, valid, max_run = _join_indices(
            build_keys, probe_keys, fanout, bk.validity
        )
        need = int(jax.device_get(max_run))
        if need <= fanout:
            break
        if on_overflow == "raise":
            raise CapacityError("join fan-out", fanout, need)
        fanout = 1 << (need - 1).bit_length()
    pv = pk.validity
    if probe_mask is not None:
        pv = probe_mask if pv is None else jnp.logical_and(pv, probe_mask)
    if pv is not None:
        valid = jnp.logical_and(valid, jnp.repeat(pv, fanout))
    return pi, bi, valid
