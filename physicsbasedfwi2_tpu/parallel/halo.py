"""Domain-decomposed acoustic propagation with halo exchange.

The reference's only domain decomposition lives inside DENISE
(NPROCX x NPROCY MPI ranks exchanging halos, networks.py:7709-7710).
The Marmousi/SEAM grids fit on one chip, so the framework's default
is shot-parallelism — but for grids exceeding per-chip HBM this
module shards the *grid* laterally across the mesh and exchanges
2-cell halos per time step with `lax.ppermute`.

Layout: each device owns a slab [nzp, nxp/ndev] (no stored halo);
before each derivative stage the needed 2-cell edge strips are
exchanged.  Non-periodic: edge devices receive zeros, which matches
the zero-padded stencils of the single-chip path, so results are
bitwise-comparable up to f32 reassociation.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from physicsbasedfwi2_tpu.ops.acoustic import AcousticConfig, _damping, _pad_model
from physicsbasedfwi2_tpu.ops import stencil
from physicsbasedfwi2_tpu.ops.scan_utils import chunked_checkpoint_scan

HALO = 2  # 4th-order staggered stencils reach 2 cells


def _exchange(f, axis: str):
    """Return (left_halo, right_halo) strips received from the
    neighbors (zeros at the outer edges)."""
    n = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    # send my right edge to the right neighbor (it becomes their left
    # halo), and my left edge to the left neighbor
    right_edge = f[:, -HALO:]
    left_edge = f[:, :HALO]
    from_left = lax.ppermute(right_edge, axis,
                             [(i, i + 1) for i in range(n - 1)])
    from_right = lax.ppermute(left_edge, axis,
                              [(i + 1, i) for i in range(n - 1)])
    zero = jnp.zeros_like(left_edge)
    from_left = jnp.where(idx == 0, zero, from_left)
    from_right = jnp.where(idx == n - 1, zero, from_right)
    return from_left, from_right


def _dx_fwd_dd(f, inv_dx, axis):
    lh, rh = _exchange(f, axis)
    fw = jnp.concatenate([lh, f, rh], axis=1)
    return stencil.dx_fwd(fw, inv_dx)[:, HALO:-HALO]


def _dx_bwd_dd(f, inv_dx, axis):
    lh, rh = _exchange(f, axis)
    fw = jnp.concatenate([lh, f, rh], axis=1)
    return stencil.dx_bwd(fw, inv_dx)[:, HALO:-HALO]


def simulate_acoustic_dd(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                         cfg: AcousticConfig, mesh: Mesh, *,
                         axis: str = "shot"):
    """Single-shot-at-a-time domain-decomposed simulation.

    Contract matches :func:`simulate_acoustic` (src/rcv index arrays,
    [ns, nt, nr] output) with ONE restriction: all receivers of a
    shot must sit on a single depth row (rcv_z[s, :] constant) — the
    kernel records one row history per shot.  The padded grid's
    x-axis is sharded over ``mesh`` (lateral width must be divisible
    by the mesh size).
    """
    import numpy as _np
    rz = _np.asarray(rcv_z)
    if not (rz == rz[:, :1]).all():
        raise ValueError(
            "simulate_acoustic_dd records a single receiver-depth row "
            "per shot; rcv_z must be constant within each shot "
            "(varying-depth geometries would silently return traces "
            "from the wrong cells)")
    g = cfg.grid
    vp_pad = _pad_model(vp.astype(jnp.float32), g)
    kappa_dt = vp_pad * vp_pad * g.dt
    ax_v, az_v, ax_p, az_p = _damping(cfg)
    nzp, nxp = vp_pad.shape
    ndev = mesh.shape[axis]
    if nxp % ndev:
        pad = ndev - nxp % ndev
        vp_pad = jnp.pad(vp_pad, ((0, 0), (0, pad)), mode="edge")
        kappa_dt = jnp.pad(kappa_dt, ((0, 0), (0, pad)), mode="edge")
        ax_v = jnp.pad(ax_v, ((0, 0), (0, pad)), mode="edge")
        ax_p = jnp.pad(ax_p, ((0, 0), (0, pad)), mode="edge")
        nxp += pad
    ax_v2 = jnp.broadcast_to(ax_v, (nzp, nxp))
    ax_p2 = jnp.broadcast_to(ax_p, (nzp, nxp))
    az_v2 = jnp.broadcast_to(az_v, (nzp, nxp))
    az_p2 = jnp.broadcast_to(az_p, (nzp, nxp))
    top, w = g.top_pad, g.pml_width
    inv_dx = 1.0 / g.dx
    dt = g.dt
    loc_w = nxp // ndev

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(None, axis),
                  P(None, axis), P(None, axis), P(), P(), P()),
        out_specs=P(),
        check_vma=False)
    def one_shot(kap, axv, axp, azv, azp, wav, src_zx, rcv_zx):
        didx = lax.axis_index(axis)
        sz, sx = src_zx[0], src_zx[1]
        # local column of the source (or out of range)
        sx_loc = sx - didx * loc_w
        has_src = jnp.logical_and(sx_loc >= 0, sx_loc < loc_w)
        sx_safe = jnp.clip(sx_loc, 0, loc_w - 1)
        src_gain = kap[sz, sx_safe] * (inv_dx * inv_dx)
        zero = jnp.zeros_like(kap)

        def step(carry, amp_t):
            vx, vz, px, pz = carry
            p = px + pz
            vx = axv * (vx + dt * _dx_fwd_dd(p, inv_dx, axis))
            vz = azv * (vz + dt * stencil.dz_fwd(p, inv_dx))
            px = axp * (px + kap * _dx_bwd_dd(vx, inv_dx, axis))
            pz = azp * (pz + kap * stencil.dz_bwd(vz, inv_dx))
            inj = jnp.where(has_src, amp_t * src_gain, 0.0)
            pz = pz.at[sz, sx_safe].add(inj)
            # record my slab's receiver row; psum-merge across devices
            row = (px + pz)[rcv_zx[0]]
            full_row = jnp.zeros((nxp,), jnp.float32)
            full_row = lax.dynamic_update_slice(full_row, row,
                                                (didx * loc_w,))
            full_row = lax.psum(full_row, axis)
            return (vx, vz, px, pz), full_row

        carry = (zero, zero, zero, zero)
        _, rows = chunked_checkpoint_scan(step, carry, wav,
                                          chunk=cfg.chunk)
        return rows  # [nt, nxp] replicated

    ns = int(src_z.shape[0])
    outs = []
    for s in range(ns):
        src_zx = jnp.asarray([src_z[s] + top, src_x[s] + w], jnp.int32)
        rcv_zx = jnp.asarray([rcv_z[s, 0] + top, 0], jnp.int32)
        rows = one_shot(kappa_dt, ax_v2, ax_p2, az_v2, az_p2,
                        wavelet.astype(jnp.float32), src_zx, rcv_zx)
        cols = (rcv_x[s] + w).astype(jnp.int32)
        outs.append(rows[:, cols])
    return jnp.stack(outs)
