"""U-Net generator family.

Capability-equivalents of the reference's U-Net zoo
(networks.py: ClassicU_Net 1031, AttU_Net 1114, R2U_Net 1207,
ASPPU_Net 1372, ResUnetPlusPlus_Net 1459, MultiU_Net 1545,
UNet_3Plus 1865, UnetGenerator 602, UnetMarmousi22_Net 5513).
"""

from __future__ import annotations

from collections.abc import Sequence

import jax.numpy as jnp
from physicsbasedfwi2_tpu.models import nn

from physicsbasedfwi2_tpu.models.blocks import (
    ASPP, CBAM, ConvBlock, Down, ResidualConv, SqueezeExcite, Up, UpCat,
    fit_to_shape, match_spatial, num_groups_for, resize_2x,
)


class UNet(nn.Module):
    """Classic encoder-decoder with skip connections.

    With ``out_shape`` set, the output is resized/cropped to the model
    grid — the UnetMarmousi22_Net role (seismic in, velocity out,
    networks.py:5513-5681); without, it is same-shape image->image
    (pix2pix role)."""

    out_channels: int = 1
    filters: Sequence[int] = (16, 32, 64, 128)
    out_shape: tuple[int, int] | None = None
    norm: str = "group"
    dropout: float = 0.0
    final_activation: str = "sigmoid"
    use_attention: bool = False  # AttU_Net-style gate via CBAM

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        skips = []
        for f in self.filters:
            x = ConvBlock(f, self.norm, self.dropout)(
                x, deterministic=deterministic)
            skips.append(x)
            x = nn.avg_pool(x, (2, 2), strides=(2, 2))
        x = ConvBlock(self.filters[-1] * 2, self.norm)(
            x, deterministic=deterministic)
        for f, skip in zip(reversed(self.filters), reversed(skips)):
            if self.use_attention:
                skip = CBAM()(skip)
            x = UpCat(f, self.norm)(x, skip, deterministic=deterministic)
        if self.out_shape is not None:
            x = fit_to_shape(x, self.out_shape)
        x = nn.Conv(self.out_channels, (1, 1))(x)
        if self.final_activation == "sigmoid":
            x = nn.sigmoid(x)
        elif self.final_activation == "tanh":
            x = nn.tanh(x)
        return x, None  # (field, latent) interface parity


class ASPPUNet(nn.Module):
    """U-Net with an atrous-pyramid bottleneck (ASPPU_Net,
    networks.py:1372)."""

    out_channels: int = 1
    filters: Sequence[int] = (16, 32, 64, 128)
    out_shape: tuple[int, int] | None = None
    norm: str = "group"

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        skips = []
        for f in self.filters:
            x = ConvBlock(f, self.norm)(x, deterministic=deterministic)
            skips.append(x)
            x = nn.avg_pool(x, (2, 2), strides=(2, 2))
        x = ASPP(self.filters[-1])(x)
        for f, skip in zip(reversed(self.filters), reversed(skips)):
            x = UpCat(f, self.norm)(x, skip, deterministic=deterministic)
        if self.out_shape is not None:
            x = fit_to_shape(x, self.out_shape)
        x = nn.Conv(self.out_channels, (1, 1))(x)
        return nn.sigmoid(x), None


class ResUNetPlusPlus(nn.Module):
    """Residual U-Net with squeeze-excite skips and ASPP bridge
    (ResUnetPlusPlus_Net, networks.py:1459)."""

    out_channels: int = 1
    filters: Sequence[int] = (16, 32, 64, 128)
    out_shape: tuple[int, int] | None = None

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        skips = []
        for i, f in enumerate(self.filters):
            x = ResidualConv(f, strides=(1, 1) if i == 0 else (2, 2))(x)
            x = SqueezeExcite()(x)
            skips.append(x)
        x = ASPP(self.filters[-1])(x)
        for f, skip in zip(reversed(self.filters[:-1]),
                           reversed(skips[:-1])):
            x = resize_2x(x)
            x = match_spatial(x, skip.shape[1], skip.shape[2])
            x = jnp.concatenate([skip, x], axis=-1)
            x = ResidualConv(f)(x)
        if self.out_shape is not None:
            x = fit_to_shape(x, self.out_shape)
        x = nn.Conv(self.out_channels, (1, 1))(x)
        return nn.sigmoid(x), None


class UNet3Plus(nn.Module):
    """UNet 3+ with full-scale skip connections (ref UNet_3Plus,
    networks.py:1865): every decoder stage aggregates same-resolution
    features pooled/upsampled from ALL encoder depths."""

    out_channels: int = 1
    filters: Sequence[int] = (16, 32, 64, 128)
    out_shape: tuple[int, int] | None = None
    norm: str = "group"
    cat_channels: int = 16

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        import jax
        enc = []
        h = x
        for f in self.filters:
            h = ConvBlock(f, self.norm)(h, deterministic=deterministic)
            enc.append(h)
            h = nn.avg_pool(h, (2, 2), strides=(2, 2))
        bottom = ConvBlock(self.filters[-1] * 2, self.norm)(
            h, deterministic=deterministic)

        def resize_to(t, hw):
            b, _, _, c = t.shape
            return jax.image.resize(t, (b, hw[0], hw[1], c), "bilinear")

        n = len(self.filters)
        dec = bottom
        for level in reversed(range(n)):
            hw = enc[level].shape[1:3]
            feats = []
            # full-scale aggregation: every encoder level + the
            # previous decoder output, all mapped to `hw`
            for src in enc:
                t = resize_to(src, hw)
                feats.append(nn.Conv(self.cat_channels, (3, 3),
                                     padding="SAME")(t))
            feats.append(nn.Conv(self.cat_channels, (3, 3),
                                 padding="SAME")(resize_to(dec, hw)))
            cat = jnp.concatenate(feats, axis=-1)
            dec = ConvBlock(self.cat_channels * (n + 1), self.norm)(
                cat, deterministic=deterministic)
        out = dec
        if self.out_shape is not None:
            out = fit_to_shape(out, self.out_shape)
        out = nn.Conv(self.out_channels, (1, 1))(out)
        return nn.sigmoid(out), None


class MultiScaleUNet(nn.Module):
    """Multi-scale-input U-Net (ref MultiU_Net, networks.py:1545 /
    Multi2U_Net 1694): downsampled copies of the input are injected
    at each encoder depth."""

    out_channels: int = 1
    filters: Sequence[int] = (16, 32, 64, 128)
    out_shape: tuple[int, int] | None = None
    norm: str = "group"

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        import jax
        skips = []
        h = x
        scaled = x
        for i, f in enumerate(self.filters):
            if i > 0:
                b, hh, ww, c = scaled.shape
                scaled = jax.image.resize(
                    scaled, (b, hh // 2, ww // 2, c), "bilinear")
                h = jnp.concatenate(
                    [h, nn.Conv(4, (3, 3), padding="SAME")(scaled)], -1)
            h = ConvBlock(f, self.norm)(h, deterministic=deterministic)
            skips.append(h)
            h = nn.avg_pool(h, (2, 2), strides=(2, 2))
        h = ConvBlock(self.filters[-1] * 2, self.norm)(
            h, deterministic=deterministic)
        for f, skip in zip(reversed(self.filters), reversed(skips)):
            h = UpCat(f, self.norm)(h, skip, deterministic=deterministic)
        if self.out_shape is not None:
            h = fit_to_shape(h, self.out_shape)
        h = nn.Conv(self.out_channels, (1, 1))(h)
        return nn.sigmoid(h), None


class RecurrentConvBlock(nn.Module):
    """Recurrent conv unit (ref R2U_Net's Recurrent_block,
    networks.py:1207): the conv is applied t times with the input
    re-added each pass, weights shared across passes."""

    features: int
    t: int = 2
    norm: str = "group"

    @nn.compact
    def __call__(self, x):
        if x.shape[-1] != self.features:
            x = nn.Conv(self.features, (1, 1))(x)
        conv = nn.Conv(self.features, (3, 3), padding="SAME")
        gn = nn.GroupNorm(num_groups=num_groups_for(self.features))
        h = nn.leaky_relu(gn(conv(x)), 0.1)
        for _ in range(self.t):
            h = nn.leaky_relu(gn(conv(x + h)), 0.1)
        return h


class R2UNet(nn.Module):
    """Recurrent-residual U-Net (ref R2U_Net networks.py:1207;
    with use_attention=True ~ R2AttU_Net 1279)."""

    out_channels: int = 1
    filters: Sequence[int] = (16, 32, 64, 128)
    out_shape: tuple[int, int] | None = None
    t: int = 2
    use_attention: bool = False

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        skips = []
        for f in self.filters:
            sc = nn.Conv(f, (1, 1))(x)
            x = sc + RecurrentConvBlock(f, self.t)(sc)  # residual
            skips.append(x)
            x = nn.avg_pool(x, (2, 2), strides=(2, 2))
        x = RecurrentConvBlock(self.filters[-1] * 2, self.t)(x)
        for f, skip in zip(reversed(self.filters), reversed(skips)):
            if self.use_attention:
                skip = CBAM()(skip)
            x = UpCat(f)(x, skip, deterministic=deterministic)
        if self.out_shape is not None:
            x = fit_to_shape(x, self.out_shape)
        x = nn.Conv(self.out_channels, (1, 1))(x)
        return nn.sigmoid(x), None
