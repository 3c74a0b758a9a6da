"""Device decode kernels (jit-compiled XLA).

Each kernel is the device-side equivalent of a host codec decoder
(strawboat.codecs.*), operating on *re-layouted* page bodies: the host
planner strips per-block byte headers once and uploads dense u32 word
tensors, so the device path is branch-free with static shapes.

Layout contract for bitpacked blocks (BitPacker4x, see util/bits.py):
128 values/block as 4 interleaved lanes; lane ``l`` of block word ``k`` is
``words[k*4 + l]``; value ``t`` of a lane occupies bits [t*b, (t+1)*b) of the
lane's 32-value bitstream.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

BLOCK_LEN = 128


@functools.partial(jax.jit, static_argnums=(1,))
def bitunpack_device(words: jax.Array, num_bits: int) -> jax.Array:
    """Unpack uniform-width bitpacked blocks.

    words: (n_blocks, num_bits * 4) uint32 — header-stripped block bodies.
    returns: (n_blocks, 128) uint32.
    """
    n_blocks = words.shape[0]
    b = num_bits
    if b == 0:
        return jnp.zeros((n_blocks, BLOCK_LEN), dtype=jnp.uint32)
    # lanes: (n_blocks, b words, 4 lanes)
    lanes = words.reshape(n_blocks, b, 4)
    mask = jnp.uint32((1 << b) - 1) if b < 32 else jnp.uint32(0xFFFFFFFF)
    outs = []
    for t in range(BLOCK_LEN // 4):  # 32 values per lane
        s = t * b
        w0, sh = s // 32, s % 32
        lo = lanes[:, w0, :] >> np.uint32(sh)
        if sh + b > 32:
            hi = lanes[:, w0 + 1, :] << np.uint32(32 - sh)
            v = (lo | hi) & mask
        else:
            v = lo & mask
        outs.append(v)
    # out[t][block, lane] → (n_blocks, 32, 4) → values[4t + l]
    out = jnp.stack(outs, axis=1)
    return out.reshape(n_blocks, BLOCK_LEN)


@functools.partial(jax.jit, static_argnums=(2,))
def bitunpack_varwidth_device(
    words: jax.Array, widths: jax.Array, bmax: int
) -> jax.Array:
    """Unpack blocks whose bit width varies PER BLOCK (width is data).

    words: (n_blocks, bmax * 4) uint32 — each block's body zero-padded to the
    group's max width; widths: (n_blocks,) int32.  Returns (n_blocks, 128)
    uint32.  The 32-step value loop unrolls statically; the per-block word
    index becomes a tiny take_along_axis gather — no per-width host loop, no
    recompiles per width mix.
    """
    n_blocks = words.shape[0]
    if bmax == 0:
        return jnp.zeros((n_blocks, BLOCK_LEN), dtype=jnp.uint32)
    lanes = words.reshape(n_blocks, bmax, 4)
    b = widths.astype(jnp.uint32)
    mask = jnp.where(
        b >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << b) - jnp.uint32(1)
    )[:, None]
    outs = []
    for t in range(BLOCK_LEN // 4):  # 32 values per lane
        s = jnp.uint32(t) * b
        w0 = (s >> 5).astype(jnp.int32)
        sh = s & jnp.uint32(31)
        lo = jnp.take_along_axis(lanes, w0[:, None, None], axis=1)[:, 0, :]
        w1 = jnp.minimum(w0 + 1, bmax - 1)
        hi = jnp.take_along_axis(lanes, w1[:, None, None], axis=1)[:, 0, :]
        lo = lo >> sh[:, None]
        # (32 - sh) == 32 only when sh == 0, where hi is unused; clamp to
        # keep the shift defined
        hi = hi << jnp.minimum(jnp.uint32(32) - sh, jnp.uint32(31))[:, None]
        spans = (sh + b > 32)[:, None]
        v = jnp.where(spans, lo | hi, lo) & mask
        outs.append(v)
    out = jnp.stack(outs, axis=1)  # (n, 32, 4): value t*4 + lane
    return out.reshape(n_blocks, BLOCK_LEN)


def delta_bitunpack_device(words, num_bits: int) -> jax.Array:
    """Delta-bitpacked blocks → values via global prefix sum (mod 2^32)."""
    deltas = bitunpack_device(jnp.asarray(words), num_bits).reshape(-1)
    return jnp.cumsum(deltas.astype(jnp.uint32), dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnums=(2,))
def rle_expand_device(counts: jax.Array, values: jax.Array, total: int) -> jax.Array:
    """Expand RLE runs: out[i] = values[j] where run j covers position i.

    counts: (n_runs,) int32 (padded runs have count 0); values: (n_runs,) T.
    """
    starts = jnp.cumsum(counts) - counts  # exclusive prefix
    # scatter each non-empty run's index at its start, then running max —
    # robust to zero-count (padding) runs anywhere in the stream
    starts = jnp.where(counts > 0, starts, total)
    marks = jnp.zeros(total + 1, dtype=jnp.int32).at[starts].max(
        jnp.arange(counts.shape[0], dtype=jnp.int32)
    )
    ids = jax.lax.cummax(marks[:total])
    from .gather import MAX_MXU_TABLE, mxu_gather

    if values.shape[0] <= MAX_MXU_TABLE and values.dtype.itemsize in (4, 8):
        return mxu_gather(values, ids)
    return values[ids]


@jax.jit
def dict_gather_device(indices: jax.Array, dictionary: jax.Array) -> jax.Array:
    from .gather import MAX_MXU_TABLE, mxu_gather

    if dictionary.shape[0] <= MAX_MXU_TABLE and dictionary.dtype.itemsize in (4, 8):
        return mxu_gather(dictionary, indices)
    return dictionary[indices]


@functools.partial(jax.jit, static_argnums=(1,))
def one_value_device(value: jax.Array, total: int) -> jax.Array:
    return jnp.broadcast_to(value, (total,))


@functools.partial(jax.jit, static_argnums=(3,))
def freq_scatter_device(
    top: jax.Array, positions: jax.Array, exceptions: jax.Array, total: int
) -> jax.Array:
    """Fill with the top value then scatter exceptions at their positions.

    Out-of-range positions are dropped — callers pad position arrays to
    bucketed sizes (with ``total`` as the pad index) to bound compile variants.
    """
    out = jnp.full((total,), top, dtype=exceptions.dtype)
    return out.at[positions].set(exceptions, mode="drop")


@functools.partial(jax.jit, static_argnums=(1,))
def unpack_validity_device(packed: jax.Array, total: int) -> jax.Array:
    """LSB-first bitmap bytes → bool array of ``total``."""
    bits = jnp.arange(8, dtype=jnp.uint8)
    expanded = (packed[:, None] >> bits[None, :]) & jnp.uint8(1)
    return expanded.reshape(-1)[:total].astype(jnp.bool_)
