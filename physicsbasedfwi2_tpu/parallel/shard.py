"""Shot-sharded FWI gradients via `shard_map` + `psum`.

Replaces the reference's three distribution mechanisms with one
pattern (SURVEY.md §2.2): the model is replicated, acquisition
arrays and observed data shard along the mesh's "shot" axis, every
device runs the propagator + local misfit on its shard, and a single
`psum` (NCCL all-reduce on GPUs) reduces loss and dJ/dm.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from physicsbasedfwi2_tpu.ops.acoustic import AcousticConfig, simulate_acoustic
from physicsbasedfwi2_tpu.ops.elastic import ElasticConfig, simulate_elastic


def pad_shots_to_multiple(arrays, n: int, pad_value=0):
    """Pad the leading (shot) axis of each array to a multiple of n.

    Returns (padded_arrays, mask) where mask [padded_ns] is 1 for real
    shots.  shard_map needs the sharded axis divisible by the mesh.
    """
    ns = arrays[0].shape[0]
    target = -(-ns // n) * n
    pad = target - ns
    out = []
    for a in arrays:
        cfg = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        out.append(jnp.pad(a, cfg, constant_values=pad_value))
    mask = jnp.arange(target) < ns
    return out, mask.astype(jnp.float32)


def shot_sharded_acoustic_gradient(mesh: Mesh, vp, obs_norm, wavelet,
                                   src_z, src_x, rcv_z, rcv_x,
                                   cfg: AcousticConfig, *,
                                   misfit: str = "l2",
                                   shot_mask=None,
                                   axis: str = "shot",
                                   direct=None):
    """(loss, dJ/dvp) with shots sharded across the mesh.

    obs_norm: [ns, nt, nr] trace-normalized observed data.
    shot_mask: optional [ns] 0/1 weights (for padded shots).
    direct: optional [ns, nt, nr] constant-model direct-wave traces
        subtracted from pred BEFORE normalization (networks.py:5467).
    The predicted data is trace-normalized per shot locally (each
    shot's normalization is independent, so sharding is exact).
    """
    ns = obs_norm.shape[0]
    if shot_mask is None:
        shot_mask = jnp.ones((ns,), jnp.float32)
    denom = jnp.sum(shot_mask) * obs_norm.shape[1] * obs_norm.shape[2]
    if direct is None:
        direct = jnp.zeros_like(obs_norm)

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis), P(),
                  P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False)
    def _grad(vp, obs, sz, sx, rz, rx, wav, mask, dirw):
        def local_loss(v):
            pred = simulate_acoustic(v, wav, sz, sx, rz, rx, cfg)
            pred = pred - dirw
            m = jnp.max(jnp.abs(pred), axis=1, keepdims=True)
            pred = pred / (m + 1e-10)
            r = pred - obs
            per = jnp.abs(r) if misfit == "l1" else r * r
            return jnp.sum(per * mask[:, None, None])

        loss, g = jax.value_and_grad(local_loss)(vp)
        return lax.psum(loss, axis), lax.psum(g, axis)

    loss, g = _grad(vp, obs_norm, src_z, src_x, rcv_z, rcv_x, wavelet,
                    shot_mask, direct)
    return loss / denom, g / denom


def sample_shot_sharded_acoustic_gradient(
        mesh: Mesh, vps, obs_norm, wavelet, src_z, src_x, rcv_z, rcv_x,
        cfg: AcousticConfig, *, misfit: str = "l2",
        sample_axis: str = "sample", shot_axis: str = "shot",
        direct=None):
    """(loss, dJ/dvps) over a 2D {sample, shot} mesh — the
    replacement for the reference's Ray per-sample GPU fan-out
    (Auto_model.py:185-199: @ray.remote prop per sample) composed
    with shot parallelism.

    vps: [B, nz, nx] one model per sample (batch axis sharded over
        ``sample_axis``).
    obs_norm: [B, ns, nt, nr] trace-normalized data (sharded over
        both axes).
    direct: optional [ns, nt, nr] constant-model direct-wave traces
        (identical across samples — the constant water model doesn't
        depend on the sample) subtracted from pred before
        normalization (networks.py:5467).
    Geometry arrays are shared across samples and sharded over
    ``shot_axis``.  Returns the mean misfit over all samples/shots
    and per-sample gradients [B, nz, nx] (sharded over samples).
    """
    B, ns, nt, nr = obs_norm.shape
    if direct is None:
        direct = jnp.zeros(obs_norm.shape[1:], obs_norm.dtype)

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(sample_axis), P(sample_axis, shot_axis),
                  P(shot_axis), P(shot_axis), P(shot_axis),
                  P(shot_axis), P(), P(shot_axis)),
        out_specs=(P(), P(sample_axis)),
        check_vma=False)
    def _grad(vp_blk, obs_blk, sz, sx, rz, rx, wav, dirw):
        def local_loss(vpb):
            def per_sample(vp, obs):
                pred = simulate_acoustic(vp, wav, sz, sx, rz, rx, cfg)
                pred = pred - dirw
                m = jnp.max(jnp.abs(pred), axis=1, keepdims=True)
                pred = pred / (m + 1e-10)
                r = pred - obs
                per = jnp.abs(r) if misfit == "l1" else r * r
                return jnp.sum(per)

            return jnp.sum(jax.vmap(per_sample)(vpb, obs_blk))

        loss, g = jax.value_and_grad(local_loss)(vp_blk)
        loss = lax.psum(lax.psum(loss, shot_axis), sample_axis)
        g = lax.psum(g, shot_axis)  # sample-sharded grads stay local
        return loss, g

    loss, g = _grad(vps, obs_norm, src_z, src_x, rcv_z, rcv_x, wavelet,
                    direct)
    denom = B * ns * nt * nr
    return loss / denom, g / denom


def shot_sharded_elastic_gradient(mesh: Mesh, vp, vs, rho, obs_vx, obs_vz,
                                  wavelet, src_z, src_x, rcv_z, rcv_x,
                                  cfg: ElasticConfig, *,
                                  shot_mask=None, axis: str = "shot",
                                  wrt=("vp", "vs")):
    """(loss, grads dict) for the elastic workload, shots sharded."""
    ns = obs_vx.shape[0]
    if shot_mask is None:
        shot_mask = jnp.ones((ns,), jnp.float32)
    denom = jnp.sum(shot_mask) * obs_vx.shape[1] * obs_vx.shape[2] * 2
    names = ("vp", "vs", "rho")
    argnums = tuple(i for i, n in enumerate(names) if n in wrt)

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis), P(axis), P(axis),
                  P(axis), P(axis), P(), P(axis)),
        out_specs=(P(), tuple(P() for _ in argnums)),
        check_vma=False)
    def _grad(vp, vs, rho, ovx, ovz, sz, sx, rz, rx, wav, mask):
        def local_loss(*opt_models):
            fields = [vp, vs, rho]
            for i, m in zip(argnums, opt_models):
                fields[i] = m
            pvx, pvz = simulate_elastic(*fields, wav, sz, sx, rz, rx, cfg)
            r = (pvx - ovx) ** 2 + (pvz - ovz) ** 2
            return jnp.sum(r * mask[:, None, None])

        args = tuple((vp, vs, rho)[i] for i in argnums)
        loss, gs = jax.value_and_grad(
            local_loss, argnums=tuple(range(len(argnums))))(*args)
        return lax.psum(loss, axis), tuple(lax.psum(g, axis) for g in gs)

    loss, gs = _grad(vp, vs, rho, obs_vx, obs_vz, src_z, src_x,
                     rcv_z, rcv_x, wavelet, shot_mask)
    grads = {names[i]: g / denom for i, g in zip(argnums, gs)}
    return loss / denom, grads
