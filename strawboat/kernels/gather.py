"""Table lookups as one-hot matmuls.

For the small tables the codecs produce (dict pages cap at tuple_count/3
uniques, RLE runs are few), ``out[i] = table[ids[i]]`` is exactly
``one_hot(ids) @ table`` — 8-bit planes recombined with wrapping u64
arithmetic keep it exact for any 64-bit payload (ints bitcast; floats
bitcast through their bit patterns), and 0/1 and 8-bit operands stay exact
if XLA computes the product in TF32.  This stands in for an XLA gather,
which the first accelerator this engine ran on serialized.  On the H100 the
plain gather is native; which of the two to keep is ROADMAP D4
(``chip_smoke.py`` times both).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# beyond this table size the matmul FLOPs outgrow the gather's memory cost
MAX_MXU_TABLE = 8192


@functools.partial(jax.jit, static_argnames=("chunk",))
def mxu_gather(table: jax.Array, ids: jax.Array, chunk: int = 0) -> jax.Array:
    """out[i] = table[ids[i]] via plane-split one-hot matmuls (exact).

    ``chunk`` 0 picks a size so the scan step's one-hot tile stays ~8 MB:
    tiny tables (dict pages are usually < 100 entries) take far larger
    chunks — fewer sequential scan steps, larger matmuls."""
    out_dtype = table.dtype
    width = table.dtype.itemsize
    assert width in (4, 8)
    if chunk == 0:
        R0 = max(int(table.shape[0]), 1)
        chunk = max(1 << 13, min(1 << 18, (8 << 20) // (4 * R0)))
    udt = jnp.uint64 if width == 8 else jnp.uint32
    tbits = jax.lax.bitcast_convert_type(table, udt)
    n = ids.shape[0]
    pad = (-n) % chunk
    ids_p = jnp.concatenate([ids, jnp.zeros(pad, ids.dtype)]) if pad else ids
    n_chunks = (n + pad) // chunk
    ids_c = ids_p.reshape(n_chunks, chunk)
    R = table.shape[0]
    iota = jnp.arange(R, dtype=ids.dtype)
    n_planes = width  # 8-bit planes
    planes = jnp.stack(
        [
            ((tbits >> udt(8 * p)) & udt(0xFF)).astype(jnp.float32)
            for p in range(n_planes)
        ],
        axis=0,
    )  # (planes, R)

    def body(_, c):
        onehot = (c[:, None] == iota[None, :]).astype(jnp.float32)  # (chunk, R)
        # (chunk, R) @ (R, planes) → (chunk, planes)
        part = jax.lax.dot_general(
            onehot,
            planes.T,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return None, part.astype(udt)

    _, parts = jax.lax.scan(body, None, ids_c)  # (n_chunks, chunk, planes)
    shifts = udt(8) * jnp.arange(n_planes, dtype=udt)
    bits = jnp.sum(
        parts.reshape(-1, n_planes) << shifts[None, :], axis=1, dtype=udt
    )[:n]
    return jax.lax.bitcast_convert_type(bits, out_dtype)
