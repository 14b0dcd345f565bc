"""Simultaneous-source (super-shot) encoding.

A capability beyond the reference: combine many physical shots into a
few random-polarity super-shots (Krebs et al. 2009 style), cutting
the per-iteration simulation count by the encoding factor.  The
estimator is unbiased over encodings when the misfit is quadratic and
receivers are common to all shots (true for the reference's fixed
surface spread).

Cost: the multi-point source injection is one scatter-add per
step; super-shots ride the same vmap/shard_map axes as regular shots.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from physicsbasedfwi2_tpu.ops.acoustic import AcousticConfig, _pad_model, _damping
from physicsbasedfwi2_tpu.ops import stencil
from physicsbasedfwi2_tpu.ops.scan_utils import chunked_checkpoint_scan


def encode_shots(ns: int, key, n_super: int):
    """Randomly partition ``ns`` shots into ``n_super`` groups with
    Rademacher polarities.

    Returns (groups, pol): [n_super, k] shot-index / polarity arrays
    (k = ceil(ns / n_super); padded duplicates get zero polarity)."""
    k = -(-ns // n_super)
    perm = jax.random.permutation(key, ns)
    pad = n_super * k - ns
    perm_p = jnp.concatenate([perm, perm[:pad]])
    groups = perm_p.reshape(n_super, k)
    pol = jax.random.rademacher(
        jax.random.fold_in(key, 1), (n_super, k), dtype=jnp.float32)
    if pad:
        valid = jnp.arange(n_super * k).reshape(n_super, k) < ns
        pol = pol * valid.astype(jnp.float32)
    return groups, pol


def _super_shot(vp_pad, kappa_dt, damps, wavelet, src_z, src_x, pol,
                rcv_z, rcv_x, cfg: AcousticConfig):
    """One super-shot: multi-point polarized source injection."""
    g = cfg.grid
    inv_dx = 1.0 / g.dx
    dt = g.dt
    ax_v, az_v, ax_p, az_p = damps
    nz, nx = vp_pad.shape
    zero = jnp.zeros((nz, nx), jnp.float32)
    gains = kappa_dt[src_z, src_x] * (inv_dx * inv_dx) * pol  # [k]

    def step(carry, amp_t):
        vx, vz, px, pz = carry
        p = px + pz
        vx = ax_v * (vx + dt * stencil.dx_fwd(p, inv_dx, cfg.order))
        vz = az_v * (vz + dt * stencil.dz_fwd(p, inv_dx, cfg.order))
        px = ax_p * (px + kappa_dt * stencil.dx_bwd(vx, inv_dx, cfg.order))
        pz = az_p * (pz + kappa_dt * stencil.dz_bwd(vz, inv_dx, cfg.order))
        pz = pz.at[src_z, src_x].add(amp_t * gains)
        rec = (px + pz)[rcv_z, rcv_x]
        return (vx, vz, px, pz), rec

    carry = (zero, zero, zero, zero)
    _, recs = chunked_checkpoint_scan(step, carry, wavelet,
                                      chunk=cfg.chunk)
    return recs


def simulate_acoustic_encoded(vp, wavelet, enc_z, enc_x, pol, rcv_z,
                              rcv_x, cfg: AcousticConfig):
    """Simulate encoded super-shots.

    Args:
        enc_z, enc_x: [n_super, k] source cell indices per super-shot.
        pol: [n_super, k] polarities (0 disables a source).
        rcv_z, rcv_x: [n_super, nr] receiver indices (typically the
            common spread repeated).

    Returns [n_super, nt, nr] traces.
    """
    g = cfg.grid
    vp = vp.astype(jnp.float32)
    vp_pad = _pad_model(vp, g)
    kappa_dt = (vp_pad * vp_pad) * g.dt
    damps = _damping(cfg)
    top, w = g.top_pad, g.pml_width
    enc_z = enc_z + top
    enc_x = enc_x + w
    rcv_z = rcv_z + top
    rcv_x = rcv_x + w
    if wavelet.ndim == 1:
        wavelet = jnp.broadcast_to(wavelet[None, :],
                                   (enc_z.shape[0],) + wavelet.shape)
    shot_fn = functools.partial(_super_shot, vp_pad, kappa_dt, damps,
                                cfg=cfg)
    return jax.vmap(shot_fn)(wavelet, enc_z, enc_x, pol, rcv_z, rcv_x)


def encoded_fwi_gradient(vp, obs, wavelet, src_z, src_x, rcv_z, rcv_x,
                         cfg: AcousticConfig, key, n_super: int,
                         *, misfit: str = "l2"):
    """(loss, grad) on encoded super-shots.

    The observed super-gathers are the same polarity combination of
    the per-shot observations (valid because the wave equation is
    linear in the source).  Receivers must be a common spread
    (identical rcv_z/rcv_x across shots).
    """
    ns = int(src_z.shape[0])
    groups, pol = encode_shots(ns, key, n_super)
    enc_z = src_z[groups]
    enc_x = src_x[groups]
    obs_enc = jnp.einsum("gk,gktr->gtr", pol, obs[groups])
    rcv_z_g = jnp.broadcast_to(rcv_z[:1], (n_super,) + rcv_z.shape[1:])
    rcv_x_g = jnp.broadcast_to(rcv_x[:1], (n_super,) + rcv_x.shape[1:])

    def loss_fn(v):
        pred = simulate_acoustic_encoded(v, wavelet, enc_z, enc_x, pol,
                                         rcv_z_g, rcv_x_g, cfg)
        if misfit == "l1":
            return jnp.mean(jnp.abs(pred - obs_enc))
        return jnp.mean((pred - obs_enc) ** 2)

    return jax.value_and_grad(loss_fn)(vp)
