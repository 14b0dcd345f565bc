"""Differentiable 2D scalar acoustic propagator.

Replacement for deepwave's ``scalar.Propagator`` (reference
/root/reference/models/networks.py:10, call sites e.g. 5408-5464):
first-order velocity–pressure staggered-grid finite differences
(4th-order space, leapfrog time) with split-field PML, time-stepped by
a chunk-rematerialized `lax.scan`, `vmap`-ed over shots.  The adjoint
(dJ/d vp) is plain JAX autodiff through the scan — equivalent to the
reference's backprop-through-time, but with explicit sqrt-remat
instead of full wavefield storage.

All shapes are static; the whole simulation jits to a single XLA
program in which the stencil updates fuse into a handful of
elementwise kernels over the padded grid.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from physicsbasedfwi2_tpu.geo.grid import Grid2D
from physicsbasedfwi2_tpu.ops import pml, stencil
from physicsbasedfwi2_tpu.ops.scan_utils import chunked_checkpoint_scan


@dataclasses.dataclass(frozen=True)
class AcousticConfig:
    """Static propagator configuration (hashable: safe as a jit
    static argument)."""

    grid: Grid2D
    order: int = 4
    chunk: int = 32
    vmax_pml: float = 5000.0  # velocity used to scale PML profiles


def _pad_model(vp: jnp.ndarray, grid: Grid2D) -> jnp.ndarray:
    w = grid.pml_width
    return jnp.pad(vp, ((grid.top_pad, w), (w, w)), mode="edge")


def _damping(cfg: AcousticConfig):
    """Split-PML decay factors on full- and half-cell positions."""
    g = cfg.grid
    nz, nx = g.padded_shape
    top = 0 if g.free_surface else g.pml_width
    w = g.pml_width
    dt, dx, v = g.dt, g.dx, cfg.vmax_pml
    sx_f = pml.sigma_profile(nx, w, w, dx, v)
    sx_h = pml.sigma_profile(nx, w, w, dx, v, half_cell=True)
    sz_f = pml.sigma_profile(nz, top, w, dx, v)
    sz_h = pml.sigma_profile(nz, top, w, dx, v, half_cell=True)
    return (
        pml.damping_factors(sx_h, dt)[None, :],  # vx  (i, j+1/2)
        pml.damping_factors(sz_h, dt)[:, None],  # vz  (i+1/2, j)
        pml.damping_factors(sx_f, dt)[None, :],  # px  (i, j)
        pml.damping_factors(sz_f, dt)[:, None],  # pz  (i, j)
    )


def _single_shot(vp_pad, kappa_dt, damps, wavelet, src_z, src_x,
                 rcv_z, rcv_x, cfg: AcousticConfig):
    """Propagate one shot; returns receiver traces [nt, nr]."""
    g = cfg.grid
    inv_dx = 1.0 / g.dx
    dt = g.dt
    ax_v, az_v, ax_p, az_p = damps
    nz, nx = vp_pad.shape
    zero = jnp.zeros((nz, nx), jnp.float32)
    # Moment-source injection: amp * dt * kappa / cell-area.
    src_gain = kappa_dt[src_z, src_x] * (inv_dx * inv_dx)

    def step(carry, amp_t):
        vx, vz, px, pz = carry
        p = px + pz
        vx = ax_v * (vx + dt * stencil.dx_fwd(p, inv_dx, cfg.order))
        vz = az_v * (vz + dt * stencil.dz_fwd(p, inv_dx, cfg.order))
        px = ax_p * (px + kappa_dt * stencil.dx_bwd(vx, inv_dx, cfg.order))
        pz = az_p * (pz + kappa_dt * stencil.dz_bwd(vz, inv_dx, cfg.order))
        pz = pz.at[src_z, src_x].add(amp_t * src_gain)
        rec = (px + pz)[rcv_z, rcv_x]
        return (vx, vz, px, pz), rec

    carry = (zero, zero, zero, zero)
    _, recs = chunked_checkpoint_scan(step, carry, wavelet, chunk=cfg.chunk)
    return recs  # [nt, nr]


def simulate_acoustic(vp, wavelet, src_z, src_x, rcv_z, rcv_x,
                      cfg: AcousticConfig):
    """Simulate a shot gather.

    Args:
        vp: [nz, nx] velocity in m/s (interior grid, row 0 = surface).
        wavelet: [nt] source time function shared by all shots, or
            [num_shots, nt] per-shot wavelets (AutoWav workload,
            reference networks.py:13163-13165).
        src_z, src_x: [num_shots] int32 source cell indices.
        rcv_z, rcv_x: [num_shots, nr] int32 receiver cell indices.
        cfg: static AcousticConfig.

    Returns:
        receivers [num_shots, nt, nr], float32.
    """
    g = cfg.grid
    vp = vp.astype(jnp.float32)
    vp_pad = _pad_model(vp, g)
    kappa_dt = (vp_pad * vp_pad) * g.dt  # rho == 1 (scalar medium)
    damps = _damping(cfg)
    top, w = g.top_pad, g.pml_width
    src_z = src_z + top
    src_x = src_x + w
    rcv_z = rcv_z + top
    rcv_x = rcv_x + w

    if wavelet.ndim == 1:
        wavelet = jnp.broadcast_to(wavelet[None, :], (src_z.shape[0],) + wavelet.shape)

    shot_fn = functools.partial(_single_shot, vp_pad, kappa_dt, damps, cfg=cfg)
    return jax.vmap(shot_fn)(wavelet, src_z, src_x, rcv_z, rcv_x)


def acoustic_gradient(vp, loss_fn, wavelet, src_z, src_x, rcv_z, rcv_x,
                      cfg: AcousticConfig):
    """(loss, dJ/dvp) for an arbitrary data-misfit ``loss_fn(pred)``.

    This is the equivalent of the reference's
    ``lossinner.backward(); net1out1.grad`` adjoint extraction
    (networks.py:5491): one reverse-mode pass through the scan.
    """

    def objective(v):
        pred = simulate_acoustic(v, wavelet, src_z, src_x, rcv_z, rcv_x, cfg)
        return loss_fn(pred)

    return jax.value_and_grad(objective)(vp)
