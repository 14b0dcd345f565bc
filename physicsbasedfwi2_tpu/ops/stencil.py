"""Staggered-grid finite-difference derivative operators.

Pure-XLA implementations (static slicing + pad, fully fusible).

Conventions: fields are [nz, nx]; axis 0 = z (depth), axis 1 = x.
``d{x,z}_fwd`` evaluates the derivative at the staggered (i+1/2)
position; ``d{x,z}_bwd`` at (i-1/2).
"""

from __future__ import annotations

import jax.numpy as jnp

# Taylor staggered-grid coefficients.
_COEFFS = {
    2: (1.0,),
    4: (9.0 / 8.0, -1.0 / 24.0),
    8: (1225.0 / 1024.0, -245.0 / 3072.0, 49.0 / 5120.0, -5.0 / 7168.0),
}


def _shift(f: jnp.ndarray, k: int, axis: int) -> jnp.ndarray:
    """f shifted by +k cells along axis, zero-filled (static shapes)."""
    if k == 0:
        return f
    n = f.shape[axis]
    pad = [(0, 0)] * f.ndim
    if k > 0:
        pad[axis] = (0, k)
        fp = jnp.pad(f, pad)
        idx = [slice(None)] * f.ndim
        idx[axis] = slice(k, k + n)
    else:
        pad[axis] = (-k, 0)
        fp = jnp.pad(f, pad)
        idx = [slice(None)] * f.ndim
        idx[axis] = slice(0, n)
    return fp[tuple(idx)]


def _d_fwd(f: jnp.ndarray, axis: int, inv_dx: float, order: int) -> jnp.ndarray:
    """Forward staggered derivative: sum_m c_m (f[i+m+1] - f[i-m])."""
    out = None
    for m, c in enumerate(_COEFFS[order]):
        term = c * (_shift(f, m + 1, axis) - _shift(f, -m, axis))
        out = term if out is None else out + term
    return out * inv_dx


def _d_bwd(f: jnp.ndarray, axis: int, inv_dx: float, order: int) -> jnp.ndarray:
    """Backward staggered derivative: sum_m c_m (f[i+m] - f[i-m-1])."""
    out = None
    for m, c in enumerate(_COEFFS[order]):
        term = c * (_shift(f, m, axis) - _shift(f, -m - 1, axis))
        out = term if out is None else out + term
    return out * inv_dx


def dx_fwd(f, inv_dx, order=4):
    return _d_fwd(f, 1, inv_dx, order)


def dx_bwd(f, inv_dx, order=4):
    return _d_bwd(f, 1, inv_dx, order)


def dz_fwd(f, inv_dx, order=4):
    return _d_fwd(f, 0, inv_dx, order)


def dz_bwd(f, inv_dx, order=4):
    return _d_bwd(f, 0, inv_dx, order)
