"""GAN infrastructure: generators, discriminators, losses.

Capability-equivalents of the reference's upstream CycleGAN/pix2pix
stack (networks.py: ResnetGenerator 474, NLayerDiscriminator 829,
PixelDiscriminator 877, GANLoss 366, cal_gradient_penalty 437;
util/image_pool.py history buffer).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from physicsbasedfwi2_tpu.models import nn

from physicsbasedfwi2_tpu.models.blocks import num_groups_for


class ResnetBlock(nn.Module):
    features: int
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        h = nn.Conv(self.features, (3, 3), padding="SAME")(x)
        h = nn.GroupNorm(num_groups=num_groups_for(self.features))(h)
        h = nn.relu(h)
        if self.dropout > 0:
            h = nn.Dropout(self.dropout)(h, deterministic=deterministic)
        h = nn.Conv(self.features, (3, 3), padding="SAME")(h)
        h = nn.GroupNorm(num_groups=num_groups_for(self.features))(h)
        return x + h


class ResnetGenerator(nn.Module):
    """resnet_9blocks / resnet_6blocks generator (networks.py:474)."""

    out_channels: int = 1
    base: int = 64
    n_blocks: int = 9
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        h = nn.Conv(self.base, (7, 7), padding="SAME")(x)
        h = nn.relu(nn.GroupNorm(num_groups=8)(h))
        for mult in (2, 4):
            h = nn.Conv(self.base * mult, (3, 3), strides=(2, 2),
                        padding="SAME")(h)
            h = nn.relu(nn.GroupNorm(num_groups=8)(h))
        for _ in range(self.n_blocks):
            h = ResnetBlock(self.base * 4, self.dropout)(
                h, deterministic=deterministic)
        for mult in (2, 1):
            b, hh, ww, c = h.shape
            h = jax.image.resize(h, (b, hh * 2, ww * 2, c), "bilinear")
            h = nn.Conv(self.base * mult, (3, 3), padding="SAME")(h)
            h = nn.relu(nn.GroupNorm(num_groups=8)(h))
        h = h[:, : x.shape[1], : x.shape[2], :]
        h = nn.Conv(self.out_channels, (7, 7), padding="SAME")(h)
        return nn.tanh(h)


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN (networks.py:829)."""

    base: int = 64
    n_layers: int = 3

    @nn.compact
    def __call__(self, x):
        h = nn.Conv(self.base, (4, 4), strides=(2, 2), padding="SAME")(x)
        h = nn.leaky_relu(h, 0.2)
        f = self.base
        for _ in range(1, self.n_layers):
            f = min(f * 2, self.base * 8)
            h = nn.Conv(f, (4, 4), strides=(2, 2), padding="SAME")(h)
            h = nn.leaky_relu(nn.GroupNorm(num_groups=8)(h), 0.2)
        f = min(f * 2, self.base * 8)
        h = nn.Conv(f, (4, 4), padding="SAME")(h)
        h = nn.leaky_relu(nn.GroupNorm(num_groups=8)(h), 0.2)
        return nn.Conv(1, (4, 4), padding="SAME")(h)


class PixelDiscriminator(nn.Module):
    """1x1 pixel-wise discriminator (networks.py:877)."""

    base: int = 64

    @nn.compact
    def __call__(self, x):
        h = nn.leaky_relu(nn.Conv(self.base, (1, 1))(x), 0.2)
        h = nn.Conv(self.base * 2, (1, 1))(h)
        h = nn.leaky_relu(nn.GroupNorm(num_groups=8)(h), 0.2)
        return nn.Conv(1, (1, 1))(h)


def gan_loss(pred, target_is_real: bool, mode: str = "lsgan"):
    """GANLoss (networks.py:366): vanilla (BCE-with-logits), lsgan
    (MSE), wgangp (mean)."""
    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return jnp.mean((pred - target) ** 2)
    if mode == "vanilla":
        target = 1.0 if target_is_real else 0.0
        return jnp.mean(
            jnp.maximum(pred, 0) - pred * target + jnp.log1p(jnp.exp(-jnp.abs(pred))))
    if mode == "wgangp":
        return -jnp.mean(pred) if target_is_real else jnp.mean(pred)
    raise ValueError(f"unknown gan mode {mode!r}")


def gradient_penalty(disc_apply, params, real, fake, key,
                     mode: str = "mixed", constant: float = 1.0):
    """WGAN-GP penalty (cal_gradient_penalty, networks.py:437)."""
    if mode == "real":
        interp = real
    elif mode == "fake":
        interp = fake
    else:
        alpha = jax.random.uniform(key, (real.shape[0], 1, 1, 1))
        interp = alpha * real + (1 - alpha) * fake

    def d_sum(x):
        return jnp.sum(disc_apply(params, x))

    grads = jax.grad(d_sum)(interp)
    norms = jnp.sqrt(jnp.sum(grads ** 2, axis=(1, 2, 3)) + 1e-16)
    return jnp.mean((norms - constant) ** 2)


class ImagePool:
    """History buffer of generated images (util/image_pool.py:5-50) —
    host-side utility for discriminator training."""

    def __init__(self, pool_size: int = 50, seed: int = 0):
        import numpy as np
        self.pool_size = pool_size
        self.images: list = []
        self._rng = np.random.default_rng(seed)

    def query(self, images):
        import numpy as np
        if self.pool_size == 0:
            return images
        out = []
        for img in np.asarray(images):
            if len(self.images) < self.pool_size:
                self.images.append(img)
                out.append(img)
            elif self._rng.random() > 0.5:
                idx = int(self._rng.integers(0, self.pool_size))
                out.append(self.images[idx].copy())
                self.images[idx] = img
            else:
                out.append(img)
        return np.stack(out)
