"""Differentiable 2D P-SV elastic propagator.

Replacement for DENISE-Black-Edition (reference
/root/reference/models/networks.py:7554-7878: external Fortran/MPI
binary coupled by .su files).  Standard Virieux velocity–stress
staggered grid (4th-order space, leapfrog time) with split-field PML
and an optional stress-free top surface, time-stepped by a
chunk-rematerialized `lax.scan`, `vmap`-ed over shots.

Where DENISE fans out over 30 MPI ranks with halo exchange
(NPROCX=6, NPROCY=5, networks.py:7709-7710), here a single XLA
program holds the whole (tiny) grid per chip and parallelism goes
over *shots* via `vmap`/`shard_map` — the natural FWI data axis.

Staggering (Virieux 1986):
    sxx, szz at (i, j);  sxz at (i+1/2, j+1/2)
    vx at (i, j+1/2);    vz at (i+1/2, j)
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from physicsbasedfwi2_tpu.geo.grid import Grid2D
from physicsbasedfwi2_tpu.ops import pml
from physicsbasedfwi2_tpu.ops.stencil import dx_fwd, dx_bwd, dz_fwd, dz_bwd
from physicsbasedfwi2_tpu.ops.scan_utils import chunked_checkpoint_scan


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    grid: Grid2D
    order: int = 4
    chunk: int = 32
    vmax_pml: float = 5000.0


def _pad(m: jnp.ndarray, grid: Grid2D) -> jnp.ndarray:
    w = grid.pml_width
    return jnp.pad(m, ((grid.top_pad, w), (w, w)), mode="edge")


def _damping(cfg: ElasticConfig):
    g = cfg.grid
    nz, nx = g.padded_shape
    top = 0 if g.free_surface else g.pml_width
    w = g.pml_width
    dt, dx, v = g.dt, g.dx, cfg.vmax_pml
    ax_f = pml.damping_factors(pml.sigma_profile(nx, w, w, dx, v), dt)[None, :]
    ax_h = pml.damping_factors(
        pml.sigma_profile(nx, w, w, dx, v, half_cell=True), dt)[None, :]
    az_f = pml.damping_factors(pml.sigma_profile(nz, top, w, dx, v), dt)[:, None]
    az_h = pml.damping_factors(
        pml.sigma_profile(nz, top, w, dx, v, half_cell=True), dt)[:, None]
    return ax_f, ax_h, az_f, az_h


def _staggered_medium(vp, vs, rho):
    """Lamé parameters and buoyancies at their staggered positions."""
    mu = rho * vs * vs
    lam = rho * (vp * vp - 2.0 * vs * vs)
    # buoyancy at vx (i, j+1/2): average along x; at vz (i+1/2, j): along z
    b = 1.0 / rho
    bx = 0.5 * (b + jnp.roll(b, -1, axis=1))
    bz = 0.5 * (b + jnp.roll(b, -1, axis=0))
    # mu at sxz (i+1/2, j+1/2): harmonic mean of 4 neighbors.
    # Fluid cells (mu = 0, e.g. the water layer) make the plain
    # 1/(mu+eps) form overflow in the *gradient* (d(1/mu)/dmu ~ 1/mu^2)
    # — use the double-where pattern so both value and grad are 0
    # whenever any neighbor is fluid (physically: free slip).
    def roll2(m):
        return jnp.roll(jnp.roll(m, -1, 0), -1, 1)
    m1, m2, m3 = mu, jnp.roll(mu, -1, 0), jnp.roll(mu, -1, 1)
    m4 = roll2(mu)
    mn = jnp.minimum(jnp.minimum(m1, m2), jnp.minimum(m3, m4))
    solid = mn > 1e-3
    safe = [jnp.where(solid, m, 1.0) for m in (m1, m2, m3, m4)]
    mu_h = 4.0 / (1.0 / safe[0] + 1.0 / safe[1]
                  + 1.0 / safe[2] + 1.0 / safe[3])
    mu_xz = jnp.where(solid, mu_h, 0.0)
    return lam, mu, mu_xz, bx, bz


def _single_shot(med, damps, free_surface, wavelet, src_z, src_x,
                 rcv_z, rcv_x, cfg: ElasticConfig):
    g = cfg.grid
    dt, inv_dx, order = g.dt, 1.0 / g.dx, cfg.order
    lam, mu, mu_xz, bx, bz = med
    ax_f, ax_h, az_f, az_h = damps
    nz, nx = lam.shape
    zeros = jnp.zeros((nz, nx), jnp.float32)
    lam2mu = lam + 2.0 * mu
    # moment-source scaling by the P-modulus at the source (keeps
    # amplitudes O(1), mirroring the acoustic kappa scaling)
    src_gain = dt * inv_dx * inv_dx * lam2mu[src_z, src_x]

    def step(carry, amp_t):
        (vxx, vxz, vzx, vzz, sxxx, sxxz, szzx, szzz, sxzx, sxzz) = carry
        sxx = sxxx + sxxz
        szz = szzx + szzz
        sxz = sxzx + sxzz

        # velocity updates
        vxx = ax_h * (vxx + dt * bx * dx_fwd(sxx, inv_dx, order))
        vxz = az_f * (vxz + dt * bx * dz_bwd(sxz, inv_dx, order))
        vzx = ax_f * (vzx + dt * bz * dx_bwd(sxz, inv_dx, order))
        vzz = az_h * (vzz + dt * bz * dz_fwd(szz, inv_dx, order))
        vx = vxx + vxz
        vz = vzx + vzz

        # stress updates
        dvxdx = dx_bwd(vx, inv_dx, order)
        dvzdz = dz_bwd(vz, inv_dx, order)
        sxxx = ax_f * (sxxx + dt * lam2mu * dvxdx)
        sxxz = az_f * (sxxz + dt * lam * dvzdz)
        szzx = ax_f * (szzx + dt * lam * dvxdx)
        szzz = az_f * (szzz + dt * lam2mu * dvzdz)
        sxzx = ax_h * (sxzx + dt * mu_xz * dx_fwd(vz, inv_dx, order))
        sxzz = az_h * (sxzz + dt * mu_xz * dz_fwd(vx, inv_dx, order))

        # explosive source into normal stresses
        amp = amp_t * src_gain
        sxxx = sxxx.at[src_z, src_x].add(amp)
        szzz = szzz.at[src_z, src_x].add(amp)

        if free_surface:
            # stress-free surface: szz = 0 on row 0, sxz = 0 above
            szzx = szzx.at[0, :].set(0.0)
            szzz = szzz.at[0, :].set(0.0)

        rec_vx = vx[rcv_z, rcv_x]
        rec_vz = vz[rcv_z, rcv_x]
        carry = (vxx, vxz, vzx, vzz, sxxx, sxxz, szzx, szzz, sxzx, sxzz)
        return carry, (rec_vx, rec_vz)

    carry = tuple(zeros for _ in range(10))
    _, (rvx, rvz) = chunked_checkpoint_scan(step, carry, wavelet,
                                            chunk=cfg.chunk)
    return rvx, rvz


def simulate_elastic(vp, vs, rho, wavelet, src_z, src_x, rcv_z, rcv_x,
                     cfg: ElasticConfig):
    """Simulate an elastic shot gather.

    Args:
        vp, vs, rho: [nz, nx] SI medium (row 0 = surface).
        wavelet: [nt] or [num_shots, nt] source time function.
        src/rcv indices as in :func:`simulate_acoustic`.

    Returns:
        (vx, vz) receiver traces, each [num_shots, nt, nr] — the two
        data components the reference feeds as inputs A and D
        (data/unalignedVelABCDEl_dataset.py:73).
    """
    g = cfg.grid
    vp = _pad(vp.astype(jnp.float32), g)
    vs = _pad(vs.astype(jnp.float32), g)
    rho = _pad(rho.astype(jnp.float32), g)
    med = _staggered_medium(vp, vs, rho)
    damps = _damping(cfg)
    top, w = g.top_pad, g.pml_width
    src_z = src_z + top
    src_x = src_x + w
    rcv_z = rcv_z + top
    rcv_x = rcv_x + w
    if wavelet.ndim == 1:
        wavelet = jnp.broadcast_to(wavelet[None, :],
                                   (src_z.shape[0],) + wavelet.shape)
    shot_fn = functools.partial(_single_shot, med, damps, g.free_surface,
                                cfg=cfg)
    return jax.vmap(shot_fn)(wavelet, src_z, src_x, rcv_z, rcv_x)


def elastic_gradient(vp, vs, rho, loss_fn, wavelet, src_z, src_x,
                     rcv_z, rcv_x, cfg: ElasticConfig,
                     wrt=("vp", "vs", "rho")):
    """(loss, grads dict) — one reverse-mode pass; replaces the
    DENISE one-iteration gradient call ``d.grad(...)`` +
    ``get_fwi_gradients`` file plumbing (networks.py:7787-7802)."""

    names = ("vp", "vs", "rho")
    argnums = tuple(i for i, n in enumerate(names) if n in wrt)

    def objective(vp_, vs_, rho_):
        pred = simulate_elastic(vp_, vs_, rho_, wavelet, src_z, src_x,
                                rcv_z, rcv_x, cfg)
        return loss_fn(pred)

    loss, grads = jax.value_and_grad(objective, argnums=argnums)(vp, vs, rho)
    return loss, dict(zip([names[i] for i in argnums], grads))
