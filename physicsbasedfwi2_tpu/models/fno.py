"""Fourier Neural Operator blocks.

Capability-equivalents of the reference's SpectralConv1d
(networks.py:2241) and RUnet_FNO.py (SpectralConv2d FNO blocks +
residual U-Net, RUnet_FNO.py:33-243), plus the FNO-style relative
Lp loss (models/custom_losses.py:22).
"""

from __future__ import annotations

import jax.numpy as jnp
from physicsbasedfwi2_tpu.models import nn


class SpectralConv1d(nn.Module):
    """1D spectral convolution: learn complex weights on the lowest
    ``modes`` Fourier modes."""

    features: int
    modes: int

    @nn.compact
    def __call__(self, x):
        # x: [B, L, C]
        b, length, c = x.shape
        wr = self.param("w_real", nn.initializers.normal(1.0 / c),
                        (self.modes, c, self.features))
        wi = self.param("w_imag", nn.initializers.normal(1.0 / c),
                        (self.modes, c, self.features))
        w = wr + 1j * wi
        xf = jnp.fft.rfft(x, axis=1)
        lo = jnp.einsum("bmc,mcf->bmf", xf[:, : self.modes], w)
        out = jnp.zeros((b, xf.shape[1], self.features), jnp.complex64)
        out = out.at[:, : self.modes].set(lo)
        return jnp.fft.irfft(out, n=length, axis=1).real


class SpectralConv2d(nn.Module):
    """2D spectral convolution (RUnet_FNO.py:33)."""

    features: int
    modes1: int
    modes2: int

    @nn.compact
    def __call__(self, x):
        # x: [B, H, W, C]
        b, h, w, c = x.shape
        shape = (self.modes1, self.modes2, c, self.features)
        init = nn.initializers.normal(1.0 / c)
        w1 = self.param("w1_real", init, shape) + 1j * self.param(
            "w1_imag", init, shape)
        w2 = self.param("w2_real", init, shape) + 1j * self.param(
            "w2_imag", init, shape)
        xf = jnp.fft.rfft2(x, axes=(1, 2))
        out = jnp.zeros((b, h, w // 2 + 1, self.features), jnp.complex64)
        top = jnp.einsum("bxyc,xycf->bxyf",
                         xf[:, : self.modes1, : self.modes2], w1)
        bot = jnp.einsum("bxyc,xycf->bxyf",
                         xf[:, -self.modes1 :, : self.modes2], w2)
        out = out.at[:, : self.modes1, : self.modes2].set(top)
        out = out.at[:, -self.modes1 :, : self.modes2].set(bot)
        return jnp.fft.irfft2(out, s=(h, w), axes=(1, 2)).real


class FNOBlock2d(nn.Module):
    features: int
    modes1: int = 12
    modes2: int = 12

    @nn.compact
    def __call__(self, x):
        s = SpectralConv2d(self.features, self.modes1, self.modes2)(x)
        l = nn.Conv(self.features, (1, 1))(x)
        return nn.gelu(s + l)


class FNO2d(nn.Module):
    """Stacked FNO for image->image operator learning (RUnet_FNO
    capability)."""

    out_channels: int = 1
    width: int = 32
    depth: int = 4
    modes: int = 12

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        h = nn.Conv(self.width, (1, 1))(x)
        for _ in range(self.depth):
            h = FNOBlock2d(self.width, self.modes, self.modes)(h)
        h = nn.gelu(nn.Conv(128, (1, 1))(h))
        return nn.Conv(self.out_channels, (1, 1))(h), None


def lp_loss(pred, target, p: int = 2, *, relative: bool = True,
            eps: float = 1e-12):
    """Relative Lp loss (custom_losses.py:22)."""
    flat_p = pred.reshape(pred.shape[0], -1)
    flat_t = target.reshape(target.shape[0], -1)
    diff = jnp.sum(jnp.abs(flat_p - flat_t) ** p, axis=1) ** (1.0 / p)
    if relative:
        norm = jnp.sum(jnp.abs(flat_t) ** p, axis=1) ** (1.0 / p)
        return jnp.mean(diff / (norm + eps))
    return jnp.mean(diff)
