"""Time-loop scaffolding: chunked, rematerialized `lax.scan`.

Backprop-through-time over nt≈4000 steps cannot store every wavefield
(the reference relies on deepwave's internal wavefield storage,
SURVEY.md §5 "long-context").  We scan over chunks with
`jax.checkpoint` on the inner scan: memory O(nt/chunk + chunk)
states, compute 2x forward — sequence-chunked remat.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def chunked_checkpoint_scan(step, carry, xs, *, chunk: int = 32,
                            unroll: int = 1):
    """`lax.scan(step, carry, xs)` with sqrt-style rematerialization.

    Args:
        step: (carry, x) -> (carry, y).
        xs: pytree of arrays with equal leading dim nt.
        chunk: inner-scan length (checkpointed unit).

    Returns:
        (carry, ys) with ys leading dim == nt.
    """
    nt = jax.tree_util.tree_leaves(xs)[0].shape[0]
    n_chunks = -(-nt // chunk)
    pad = n_chunks * chunk - nt

    def _pad(x):
        cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, cfg)

    def _reshape(x):
        return x.reshape((n_chunks, chunk) + x.shape[1:])

    xs_c = jax.tree_util.tree_map(lambda x: _reshape(_pad(x)), xs)

    @jax.checkpoint
    def inner(c, xc):
        return lax.scan(step, c, xc, unroll=unroll)

    carry, ys = lax.scan(inner, carry, xs_c)
    ys = jax.tree_util.tree_map(
        lambda y: y.reshape((n_chunks * chunk,) + y.shape[2:])[:nt], ys)
    return carry, ys
