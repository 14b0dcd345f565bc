"""Deep-image-prior autoencoder generators.

Capability-equivalents of the reference's Auto* net family
(AutoMarmousi22_Net, networks.py:5136-5294: encoder over decimated
shot gathers -> 8-dim latent -> conv decoder -> velocity map; elastic
two-branch variant AutoElMarmousiMar22_Net, networks.py:7215-7553).

Redesign: NHWC, shape-agnostic (the reference hard-codes
151x200 Linear sizes), GroupNorm, and the physics-facing output
transforms (range-scaling, water-pinning, low-frequency anchoring)
are *separate pure functions* so the same net serves every workload.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import jax
import jax.numpy as jnp
from physicsbasedfwi2_tpu.models import nn

from physicsbasedfwi2_tpu.models.blocks import (
    CBAM, ConvBlock, Down, Up, scale_to_range, pin_water,
)


def _decode_start(out_hw: tuple[int, int], n_up: int) -> tuple[int, int]:
    """Smallest (h0, w0) with h0*2^n >= nz, w0*2^n >= nx (+1 margin
    for clean center-cropping, mirroring the reference's crop
    ``up1[:, :, 1:1+nz, 0:1+nx]`` at networks.py:5259)."""
    s = 2 ** n_up
    return (math.ceil(out_hw[0] / s) + 1, math.ceil(out_hw[1] / s) + 1)


class Decoder2D(nn.Module):
    """latent -> [B, nz, nx, out_channels] in [0, 1]."""

    out_shape: tuple[int, int]
    out_channels: int = 1
    filters: Sequence[int] = (16, 32, 64, 128)
    use_cbam: bool = False
    dropout: float = 0.0
    norm: str = "group"
    final_activation: str = "sigmoid"  # "sigmoid" | "tanh" | "none"

    @nn.compact
    def __call__(self, z, *, deterministic: bool = True):
        n_up = len(self.filters) - 1
        h0, w0 = _decode_start(self.out_shape, n_up)
        top = self.filters[-1]
        x = nn.Dense(h0 * w0 * top)(z)
        x = x.reshape((-1, h0, w0, top))
        for f in reversed(self.filters[:-1]):
            x = Up(f, self.norm, self.dropout)(x, deterministic=deterministic)
            if self.use_cbam:
                x = CBAM()(x)
        nz, nx = self.out_shape
        x = x[:, : nz, : nx, :]
        x = nn.Conv(self.out_channels, (1, 1))(x)
        if self.final_activation == "sigmoid":
            x = nn.sigmoid(x)
        elif self.final_activation == "tanh":
            x = nn.tanh(x)
        return x


class Encoder2D(nn.Module):
    """Shot-gather encoder -> latent (ref networks.py:5197-5216:
    4x time-decimation, 4 down blocks, flatten, Linear -> 8)."""

    latent_dim: int = 8
    filters: Sequence[int] = (16, 32, 64, 128)
    time_decimation: int = 4
    norm: str = "group"

    @nn.compact
    def __call__(self, shots, *, deterministic: bool = True):
        # shots: [B, nt, nr, num_shot_channels]
        x = shots[:, :: self.time_decimation]
        for f in self.filters:
            x = Down(f, self.norm)(x, deterministic=deterministic)
        x = x.reshape((x.shape[0], -1))
        return nn.Dense(self.latent_dim)(x)


class AutoEncoderNet(nn.Module):
    """The canonical deep-image-prior generator (Auto22 capability):
    data -> 8-dim latent bottleneck -> model map in [0,1].

    Returns (field01, latent)."""

    out_shape: tuple[int, int]
    out_channels: int = 1
    latent_dim: int = 8
    filters: Sequence[int] = (16, 32, 64, 128)
    time_decimation: int = 4
    use_cbam: bool = False
    dropout: float = 0.0
    norm: str = "group"

    @nn.compact
    def __call__(self, shots, *, deterministic: bool = True):
        z = Encoder2D(self.latent_dim, self.filters, self.time_decimation,
                      self.norm)(shots, deterministic=deterministic)
        out = Decoder2D(self.out_shape, self.out_channels, self.filters,
                        self.use_cbam, self.dropout, self.norm)(
            z, deterministic=deterministic)
        return out, z


class ElasticAutoEncoderNet(nn.Module):
    """Two-component elastic generator (AutoElMarmousiMar22
    capability, networks.py:7215-7553): vx/vz gathers are combined by
    1x1 convs, share one encoder -> latent 8, and decode through
    per-field branches (Vp, Vs[, Rho]); outputs are *deltas* added to
    the low-frequency model (networks.py:7455-7456, rho passthrough
    7458).

    head="linear" (reference-faithful): the decoder's raw output is
    the delta, unbounded, exactly networks.py:7455-7456 ``vp1 =
    lowf[:,0] + vp1f`` — only the physical-bound clip constrains the
    model.  head="tanh": deltas in [-1, 1] scaled by a per-field
    bound downstream — bounded, but the tanh KILLS the gradient once
    a region saturates, freezing the inversion wherever the needed
    delta exceeds the bound (observed: the Marmousi-like elastic
    workload needs |dvs| up to ~574 m/s against a 200 m/s bound).

    Returns (deltas [B, nz, nx, n_fields], latent)."""

    out_shape: tuple[int, int]
    n_fields: int = 2  # vp, vs (rho passthrough by default)
    latent_dim: int = 8
    filters: Sequence[int] = (16, 32, 64, 128)
    time_decimation: int = 4
    dropout: float = 0.0
    norm: str = "group"
    head: str = "tanh"

    @nn.compact
    def __call__(self, shots_vx, shots_vz, *, deterministic: bool = True):
        cx = nn.Conv(4, (1, 1), name="combine_vx")(shots_vx)
        cz = nn.Conv(4, (1, 1), name="combine_vz")(shots_vz)
        x = jnp.concatenate([cx, cz], axis=-1)
        z = Encoder2D(self.latent_dim, self.filters, self.time_decimation,
                      self.norm)(x, deterministic=deterministic)
        act = "tanh" if self.head == "tanh" else None
        fields = []
        for k in range(self.n_fields):
            f = Decoder2D(self.out_shape, 1, self.filters,
                          dropout=self.dropout, norm=self.norm,
                          final_activation=act,
                          name=f"decoder_field{k}")(
                z, deterministic=deterministic)
            fields.append(f)
        return jnp.concatenate(fields, axis=-1), z


class ModelParamNet(nn.Module):
    """"Classic FWI" pseudo-net: the parameters ARE the model grids
    (ref AutoEl22N via define_G1, networks.py:6477-6520 — tensors
    loaded from trainC with requires_grad=True).  The same training
    loop then performs plain adjoint FWI with no reparameterization."""

    init_model: jnp.ndarray  # [nz, nx, n_fields]

    @nn.compact
    def __call__(self):
        m = self.param("model", lambda _: jnp.asarray(self.init_model))
        return m[None]  # [1, nz, nx, n_fields]


def apply_velocity_output(field01, true_model, *, vmin=None, vmax=None,
                          water_vel: float = 1500.0):
    """Reference output transform chain (networks.py:5264-5265):
    [0,1] -> [vmin, vmax] with water cells pinned."""
    if vmin is None:
        vmin = jnp.min(true_model)
    if vmax is None:
        vmax = jnp.max(true_model)
    v = scale_to_range(field01, vmin, vmax)
    return pin_water(v, true_model, water_vel)


@jax.custom_vjp
def _clip_ste(x, lo, hi):
    return jnp.clip(x, lo, hi)


def _clip_ste_fwd(x, lo, hi):
    return jnp.clip(x, lo, hi), None


def _clip_ste_bwd(_, g):
    return g, None, None


_clip_ste.defvjp(_clip_ste_fwd, _clip_ste_bwd)


def apply_elastic_output(deltas, lowf, true_model, *, delta_scale,
                         clip_min, clip_max, pin_rows: int = 0,
                         clip_mode: str = "hard"):
    """Elastic output transform (networks.py:7455-7476): per-field
    tanh deltas scaled and added to the low-frequency model, clipped
    to physical bounds, top (water) rows pinned to the true model.

    Args:
        deltas: [B, nz, nx, F] in [-1, 1].
        lowf: [B, nz, nx, F] low-frequency starting model.
        true_model: [B, nz, nx, F] (only its top rows are used).
        delta_scale: [F] max |delta| per field in SI units.
        clip_min, clip_max: [F] physical bounds per field.
        pin_rows: number of top rows pinned (ref: 26).
        clip_mode: "hard" zeroes the gradient of out-of-bounds cells
            (jnp.clip — cells railed at a physical bound can never be
            pulled back, an absorbing state for a drifting inversion);
            "ste" keeps the hard clip in the forward pass but
            backprops straight through it, so the misfit gradient can
            recover railed cells.
    """
    scale = jnp.asarray(delta_scale)[None, None, None, :]
    m = lowf + deltas * scale
    clip = _clip_ste if clip_mode == "ste" else jnp.clip
    m = clip(m, jnp.asarray(clip_min)[None, None, None, :],
             jnp.asarray(clip_max)[None, None, None, :])
    if pin_rows > 0:
        row = jnp.arange(m.shape[1])[None, :, None, None]
        m = jnp.where(row < pin_rows, true_model, m)
    return m


class FlowAutoEncoderNet(nn.Module):
    """Autoencoder with an invertible GLOW-coupling head on the latent
    (the AutoMarmousiNF capability, networks.py:13316-13624: FrEIA
    InputNode/GLOWCouplingBlock/ReversibleGraphNet over the latent).

    Returns (field01, z_flow, logdet)."""

    out_shape: tuple[int, int]
    out_channels: int = 1
    latent_dim: int = 8
    filters: Sequence[int] = (16, 32, 64, 128)
    time_decimation: int = 4
    n_flow_blocks: int = 4
    norm: str = "group"

    @nn.compact
    def __call__(self, shots, *, deterministic: bool = True,
                 reverse: bool = False):
        from physicsbasedfwi2_tpu.models.flows import LatentFlow
        z = Encoder2D(self.latent_dim, self.filters, self.time_decimation,
                      self.norm)(shots, deterministic=deterministic)
        z, logdet = LatentFlow(self.n_flow_blocks)(z, reverse=reverse)
        out = Decoder2D(self.out_shape, self.out_channels, self.filters,
                        norm=self.norm)(z, deterministic=deterministic)
        return out, z, logdet
