"""Reusable building blocks for the generator zoo (models.nn modules).

Capability-equivalents of the reference's block library
(models/networks.py:2276-2570 unetConv2/unetDown/autoUp*, models/
cbam.py CBAM, models/resunet_modules.py ASPP/SE) — re-designed for
jit: NHWC layout, GroupNorm instead of BatchNorm (no cross-step
running stats under jit), bilinear resize + conv upsampling.
"""

from __future__ import annotations

from collections.abc import Sequence

import jax
import jax.numpy as jnp
from physicsbasedfwi2_tpu.models import nn


def num_groups_for(channels: int, cap: int = 8) -> int:
    """Largest divisor of `channels` that is <= cap (GroupNorm
    requires num_groups | channels; concat stages produce counts like
    12 that 8 does not divide)."""
    for g in range(min(cap, channels), 0, -1):
        if channels % g == 0:
            return g
    return 1


def _norm(norm: str, features: int):
    if norm == "group":
        return nn.GroupNorm(num_groups=num_groups_for(features))
    if norm == "layer":
        return nn.LayerNorm()
    if norm == "none":
        return lambda x: x
    raise ValueError(f"unknown norm {norm!r}")


class ConvBlock(nn.Module):
    """Two 3x3 convs with norm + LeakyReLU (ref unetConv2,
    networks.py:2276)."""

    features: int
    norm: str = "group"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        for _ in range(2):
            x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
            x = _norm(self.norm, self.features)(x)
            x = nn.leaky_relu(x, 0.1)
        if self.dropout > 0:
            x = nn.Dropout(self.dropout)(x, deterministic=deterministic)
        return x


class Down(nn.Module):
    """ConvBlock then 2x2 average pool (ref unetDown,
    networks.py:2298)."""

    features: int
    norm: str = "group"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        x = ConvBlock(self.features, self.norm, self.dropout)(
            x, deterministic=deterministic)
        return nn.avg_pool(x, (2, 2), strides=(2, 2))


def resize_2x(x: jnp.ndarray) -> jnp.ndarray:
    b, h, w, c = x.shape
    return jax.image.resize(x, (b, 2 * h, 2 * w, c), method="bilinear")


class Up(nn.Module):
    """Bilinear 2x upsample then ConvBlock (ref autoUp5 family,
    networks.py:2393-2570)."""

    features: int
    norm: str = "group"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        x = resize_2x(x)
        return ConvBlock(self.features, self.norm, self.dropout)(
            x, deterministic=deterministic)


def match_spatial(x: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """Center pad-or-crop [B, H, W, C] to (h, w).  Needed wherever a
    2x-upsampled decoder tensor meets an encoder skip: with odd
    spatial dims the pooled-then-doubled size can land on either side
    of the skip's (avg_pool floors, resize_2x doubles)."""
    dh = h - x.shape[1]
    dw = w - x.shape[2]
    if dh > 0 or dw > 0:
        x = jnp.pad(x, ((0, 0),
                        (max(dh, 0) // 2, max(dh, 0) - max(dh, 0) // 2),
                        (max(dw, 0) // 2, max(dw, 0) - max(dw, 0) // 2),
                        (0, 0)))
    if dh < 0 or dw < 0:
        oh = max(-dh, 0) // 2
        ow = max(-dw, 0) // 2
        x = x[:, oh:oh + h, ow:ow + w, :]
    return x


def fit_to_shape(x: jnp.ndarray, out_shape) -> jnp.ndarray:
    """Map a decoder tensor to the model grid: bilinear-upscale any
    dimension that is too small (e.g. few-receiver inputs), then crop.
    The UnetMarmousi22_Net seismic->velocity output stage
    (networks.py:5513-5681)."""
    b, h, w, c = x.shape
    nz, nx = out_shape
    if h < nz or w < nx:
        x = jax.image.resize(x, (b, max(h, nz), max(w, nx), c),
                             method="bilinear")
    return x[:, :nz, :nx, :]


class UpCat(nn.Module):
    """U-Net decoder stage: upsample, pad/crop-match to the skip,
    concat, conv (ref unetUp, networks.py:2315).  The decoder tensor
    is matched to the *skip's* spatial shape so encoder input dims
    propagate back up unchanged — works for odd dims (e.g. nt=4001)
    where the old pad-skip-only scheme produced negative pad widths."""

    features: int
    norm: str = "group"

    @nn.compact
    def __call__(self, x, skip, *, deterministic: bool = True):
        x = resize_2x(x)
        x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
        x = match_spatial(x, skip.shape[1], skip.shape[2])
        x = jnp.concatenate([skip, x], axis=-1)
        return ConvBlock(self.features, self.norm)(
            x, deterministic=deterministic)


class ChannelGate(nn.Module):
    """CBAM channel attention (ref cbam.py:26-60): avg+max pooled
    MLP gates."""

    reduction: int = 16

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        hidden = max(c // self.reduction, 1)
        mlp = nn.Sequential([nn.Dense(hidden), nn.relu, nn.Dense(c)])
        avg = jnp.mean(x, axis=(1, 2))
        mx = jnp.max(x, axis=(1, 2))
        gate = nn.sigmoid(mlp(avg) + mlp(mx))
        return x * gate[:, None, None, :]


class SpatialGate(nn.Module):
    """CBAM spatial attention (ref cbam.py:72-82): 7x7 conv over
    [max,mean] channel pool."""

    @nn.compact
    def __call__(self, x):
        pooled = jnp.concatenate(
            [jnp.max(x, axis=-1, keepdims=True),
             jnp.mean(x, axis=-1, keepdims=True)], axis=-1)
        gate = nn.Conv(1, (7, 7), padding="SAME")(pooled)
        return x * nn.sigmoid(gate)


class CBAM(nn.Module):
    """Convolutional block attention (ref cbam.py:84-95)."""

    reduction: int = 16
    no_spatial: bool = False

    @nn.compact
    def __call__(self, x):
        x = ChannelGate(self.reduction)(x)
        if not self.no_spatial:
            x = SpatialGate()(x)
        return x


class SqueezeExcite(nn.Module):
    """SE block (ref resunet_modules Squeeze_Excite)."""

    reduction: int = 16

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        s = jnp.mean(x, axis=(1, 2))
        s = nn.Dense(max(c // self.reduction, 1))(s)
        s = nn.relu(s)
        s = nn.sigmoid(nn.Dense(c)(s))
        return x * s[:, None, None, :]


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (ref resunet_modules ASPP /
    ASPPU_Net, networks.py:1372)."""

    features: int
    rates: Sequence[int] = (1, 6, 12, 18)

    @nn.compact
    def __call__(self, x):
        branches = []
        for r in self.rates:
            b = nn.Conv(self.features, (3, 3), padding="SAME",
                        kernel_dilation=(r, r))(x)
            b = nn.GroupNorm(num_groups=num_groups_for(self.features))(b)
            branches.append(nn.relu(b))
        x = jnp.concatenate(branches, axis=-1)
        return nn.Conv(self.features, (1, 1))(x)


class ResidualConv(nn.Module):
    """Residual conv block (ref resunet_modules ResidualConv)."""

    features: int
    strides: tuple[int, int] = (1, 1)

    @nn.compact
    def __call__(self, x):
        h = nn.GroupNorm(num_groups=num_groups_for(x.shape[-1]))(x)
        h = nn.relu(h)
        h = nn.Conv(self.features, (3, 3), strides=self.strides,
                    padding="SAME")(h)
        h = nn.GroupNorm(num_groups=num_groups_for(self.features))(h)
        h = nn.relu(h)
        h = nn.Conv(self.features, (3, 3), padding="SAME")(h)
        sc = nn.Conv(self.features, (1, 1), strides=self.strides)(x)
        return h + sc


def scale_to_range(x01: jnp.ndarray, vmin, vmax) -> jnp.ndarray:
    """Map sigmoid output [0,1] to [vmin, vmax]
    (ref ``f1 = mintrue + f1*(maxtrue-mintrue)``, networks.py:5264)."""
    return vmin + x01 * (vmax - vmin)


def pin_water(model: jnp.ndarray, true_model: jnp.ndarray,
              water_vel: float = 1500.0) -> jnp.ndarray:
    """Pin water cells to the known water velocity
    (ref ``f1[(inputs1==1500)] = 1500``, networks.py:5265)."""
    return jnp.where(true_model == water_vel, water_vel, model)
