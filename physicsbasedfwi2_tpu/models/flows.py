"""Normalizing flows.

Capability-equivalents of:
- the FrEIA GLOW-coupling decoder in AutoMarmousiNF_Net
  (networks.py:13340-13360: InputNode/GLOWCouplingBlock/
  ReversibleGraphNet over the latent), and
- the planar flows in VaeNormalizing (networks.py:15746-15835:
  Flow/NormalizingFlow/PlanarFlow).
"""

from __future__ import annotations


import jax.numpy as jnp
from physicsbasedfwi2_tpu.models import nn


class AffineCoupling(nn.Module):
    """GLOW-style affine coupling on a flat latent vector.

    Splits z into halves; one half predicts (scale, shift) of the
    other.  log-det is tracked for exact likelihoods."""

    hidden: int = 64
    swap: bool = False
    clamp: float = 2.0

    @nn.compact
    def __call__(self, z, *, reverse: bool = False):
        d = z.shape[-1] // 2
        za, zb = (z[..., d:], z[..., :d]) if self.swap else (
            z[..., :d], z[..., d:])
        net = nn.Sequential([nn.Dense(self.hidden), nn.relu,
                             nn.Dense(self.hidden), nn.relu,
                             nn.Dense(2 * zb.shape[-1])])
        params = net(za)
        s_raw, t = jnp.split(params, 2, axis=-1)
        # soft-clamped log-scale (GLOW coupling convention)
        log_s = self.clamp * jnp.tanh(s_raw / self.clamp)
        if reverse:
            zb = (zb - t) * jnp.exp(-log_s)
            logdet = -jnp.sum(log_s, axis=-1)
        else:
            zb = zb * jnp.exp(log_s) + t
            logdet = jnp.sum(log_s, axis=-1)
        out = jnp.concatenate([zb, za] if self.swap else [za, zb], axis=-1)
        return out, logdet


class LatentFlow(nn.Module):
    """Stack of alternating affine couplings over the latent — the
    invertible decoder-head of the AutoNF workload."""

    n_blocks: int = 4
    hidden: int = 64

    @nn.compact
    def __call__(self, z, *, reverse: bool = False):
        total = jnp.zeros(z.shape[:-1])
        blocks = [AffineCoupling(self.hidden, swap=bool(i % 2))
                  for i in range(self.n_blocks)]
        seq = reversed(blocks) if reverse else blocks
        # submodule names follow construction order; build both orders
        if reverse:
            for blk in list(blocks)[::-1]:
                z, ld = blk(z, reverse=True)
                total = total + ld
        else:
            for blk in blocks:
                z, ld = blk(z)
                total = total + ld
        return z, total


class PlanarFlow(nn.Module):
    """Planar flow z' = z + u * tanh(w.z + b)
    (networks.py:15746 PlanarFlow)."""

    @nn.compact
    def __call__(self, z):
        d = z.shape[-1]
        u = self.param("u", nn.initializers.normal(0.1), (d,))
        w = self.param("w", nn.initializers.normal(0.1), (d,))
        b = self.param("b", nn.initializers.zeros, ())
        # enforce invertibility: u_hat such that w.u_hat >= -1
        wu = jnp.dot(w, u)
        m = -1 + jnp.log1p(jnp.exp(wu))
        u_hat = u + (m - wu) * w / (jnp.dot(w, w) + 1e-12)
        lin = z @ w + b
        f = z + u_hat * jnp.tanh(lin)[..., None]
        psi = (1 - jnp.tanh(lin) ** 2)[..., None] * w
        logdet = jnp.log(jnp.abs(1 + psi @ u_hat) + 1e-12)
        return f, logdet


class PlanarFlowStack(nn.Module):
    """NormalizingFlow (networks.py:15800): K planar flows."""

    n_flows: int = 8

    @nn.compact
    def __call__(self, z):
        total = jnp.zeros(z.shape[:-1])
        for i in range(self.n_flows):
            z, ld = PlanarFlow(name=f"flow{i}")(z)
            total = total + ld
        return z, total
