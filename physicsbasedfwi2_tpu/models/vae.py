"""Variational autoencoder generators and latent-inversion support.

Capability-equivalents of the reference's Vae* family:
- VaeMarmousi_Net (networks.py:4336-4499): encoder -> (mu, logvar),
  reparameterized latent, conv decoder, KL at the model layer
  (Vae2_model.py:223-224).
- VaeNoPhy / Vaevel pretraining nets (networks.py:15021, 16507).
- Latent-space inversion (VaeLatent2NoPhy_model.py:395-560): decoder
  frozen, optimize the latent through the propagator.
"""

from __future__ import annotations

from collections.abc import Sequence

import jax
import jax.numpy as jnp
from physicsbasedfwi2_tpu.models import nn

from physicsbasedfwi2_tpu.models.autoencoders import Decoder2D, Encoder2D


class VaeNet(nn.Module):
    """VAE generator. Returns (field01, mu, logvar, z).

    setup()-style so the decoder is shared between ``__call__`` and
    the ``decode`` method (frozen-decoder latent inversion)."""

    out_shape: tuple[int, int]
    out_channels: int = 1
    latent_dim: int = 8
    filters: Sequence[int] = (16, 32, 64, 128)
    time_decimation: int = 4
    norm: str = "group"

    def setup(self):
        self.encoder = Encoder2D(2 * self.latent_dim, self.filters,
                                 self.time_decimation, self.norm)
        self.decoder = Decoder2D(self.out_shape, self.out_channels,
                                 self.filters, norm=self.norm)

    def __call__(self, shots, *, deterministic: bool = True,
                 rng_key=None):
        h = self.encoder(shots, deterministic=deterministic)
        mu, logvar = jnp.split(h, 2, axis=-1)
        if deterministic:
            z = mu
        else:
            if rng_key is None:
                rng_key = self.make_rng("latent")
            std = jnp.exp(0.5 * logvar)
            z = mu + std * jax.random.normal(rng_key, mu.shape)
        out = self.decoder(z, deterministic=deterministic)
        return out, mu, logvar, z

    def decode(self, z, *, deterministic: bool = True):
        """Decoder-only application (for frozen-decoder latent
        inversion)."""
        return self.decoder(z, deterministic=deterministic)


class _ImgEncoder(nn.Module):
    """Image -> 2*latent (mu, logvar) conv encoder."""

    latent_dim: int
    filters: Sequence[int]
    norm: str = "group"

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        from physicsbasedfwi2_tpu.models.blocks import Down
        for f in self.filters:
            x = Down(f, self.norm)(x, deterministic=deterministic)
        x = x.reshape((x.shape[0], -1))
        return nn.Dense(2 * self.latent_dim)(x)


class ModelVae(nn.Module):
    """Velocity-model VAE for generative pretraining (Vaevel /
    VaeNoPhy capability, networks.py:16507, 15021): image -> latent
    -> image.  Returns (recon01, mu, logvar, z).  setup()-style so
    ``decode`` is available for the frozen-decoder latent-inversion
    pipeline (VaeLatent2NoPhy_model.py:395-560)."""

    out_shape: tuple[int, int]
    out_channels: int = 1
    latent_dim: int = 8
    filters: Sequence[int] = (16, 32, 64, 128)
    norm: str = "group"

    def setup(self):
        self.encoder = _ImgEncoder(self.latent_dim, self.filters,
                                   self.norm)
        self.decoder = Decoder2D(self.out_shape, self.out_channels,
                                 self.filters, norm=self.norm)

    def __call__(self, model_img, *, deterministic: bool = True,
                 rng_key=None):
        h = self.encoder(model_img, deterministic=deterministic)
        mu, logvar = jnp.split(h, 2, axis=-1)
        if deterministic:
            z = mu
        else:
            if rng_key is None:
                rng_key = self.make_rng("latent")
            z = mu + jnp.exp(0.5 * logvar) * jax.random.normal(
                rng_key, mu.shape)
        out = self.decoder(z, deterministic=deterministic)
        return out, mu, logvar, z

    def decode(self, z, *, deterministic: bool = True):
        return self.decoder(z, deterministic=deterministic)


class VaeFlowNet(nn.Module):
    """VAE whose posterior is sharpened by planar flows — the
    VaeNormalizing / VaeNormalizingPhy capability (networks.py:
    15746-16190: Flow/NormalizingFlow/PlanarFlow over the latent).

    Returns (field01, mu, logvar, z_k, logdet): z0 is the
    reparameterized sample, z_k = flow(z0), and the ELBO's KL term
    becomes KL(q0 || N(0,1)) - E[logdet]."""

    out_shape: tuple[int, int]
    out_channels: int = 1
    latent_dim: int = 8
    filters: Sequence[int] = (16, 32, 64, 128)
    time_decimation: int = 4
    n_flows: int = 8
    norm: str = "group"

    def setup(self):
        from physicsbasedfwi2_tpu.models.flows import PlanarFlowStack
        self.encoder = Encoder2D(2 * self.latent_dim, self.filters,
                                 self.time_decimation, self.norm)
        self.flows = PlanarFlowStack(self.n_flows)
        self.decoder = Decoder2D(self.out_shape, self.out_channels,
                                 self.filters, norm=self.norm)

    def __call__(self, shots, *, deterministic: bool = True,
                 rng_key=None):
        h = self.encoder(shots, deterministic=deterministic)
        mu, logvar = jnp.split(h, 2, axis=-1)
        if deterministic:
            z0 = mu
        else:
            if rng_key is None:
                rng_key = self.make_rng("latent")
            z0 = mu + jnp.exp(0.5 * logvar) * jax.random.normal(
                rng_key, mu.shape)
        z_k, logdet = self.flows(z0)
        out = self.decoder(z_k, deterministic=deterministic)
        return out, mu, logvar, z_k, logdet

    def decode(self, z, *, deterministic: bool = True):
        return self.decoder(z, deterministic=deterministic)


def kl_divergence(mu: jnp.ndarray, logvar: jnp.ndarray) -> jnp.ndarray:
    """Standard-normal KL (ref Vae2_model.py:223-224)."""
    return jnp.mean(-0.5 * jnp.sum(1 + logvar - mu ** 2 - jnp.exp(logvar),
                                   axis=-1))
