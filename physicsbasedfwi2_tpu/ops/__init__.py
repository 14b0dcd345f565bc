"""Differentiable wave-physics compute ops (the replacement for the
reference's deepwave / DENISE / Devito engines), written in plain
``jax.numpy``/``lax`` and compiled by XLA."""

from physicsbasedfwi2_tpu.ops.acoustic import (
    simulate_acoustic,
    acoustic_gradient,
    AcousticConfig,
)
from physicsbasedfwi2_tpu.ops.elastic import (
    simulate_elastic,
    elastic_gradient,
    ElasticConfig,
)
from physicsbasedfwi2_tpu.ops.elastic_fast import simulate_elastic_fast
from physicsbasedfwi2_tpu.ops.misfit import (
    trace_normalize,
    l1_misfit,
    l2_misfit,
    huber_misfit,
    normalized_trace_misfit,
)
from physicsbasedfwi2_tpu.ops.gradproc import (
    depth_weighting,
    water_mask,
    taper_top,
    rescale_to_model,
)
from physicsbasedfwi2_tpu.ops.ssim import ssim

# (physics, scheme) -> (physics_path name, propagator).  "auto" is the
# operator the engines invert with, and so the one `fwi-prep` simulates
# observed data with by default (misfit exactly zero at the true
# model); "reference" is the split-PML scheme, a different
# discretization for crime-free observed data.
_OPERATORS = {
    ("acoustic", "auto"): ("xla", simulate_acoustic),
    ("acoustic", "reference"): ("xla", simulate_acoustic),
    ("elastic", "auto"): ("fast", simulate_elastic_fast),
    ("elastic", "reference"): ("reference", simulate_elastic),
}


def select_operator(physics: str, scheme: str = "auto"):
    """The one propagator selector, shared by data prep, synthetic
    workloads, the engines and the benchmark.

    Args:
        physics: "acoustic" or "elastic".
        scheme: "auto" (the inversion operator: ``simulate_acoustic``;
            the 5-field sponge ``simulate_elastic_fast``) or
            "reference" (``simulate_acoustic``; the split-PML
            ``simulate_elastic``).

    Returns:
        ``(path, simulate)``: the physics-path name the engines log
        ("xla", "fast" or "reference") and the propagator.
    """
    if scheme == "pallas":
        raise ValueError(
            "scheme 'pallas' named the removed Pallas kernels (fused "
            "loss+grad); use 'auto' (the XLA inversion operator) or "
            "'reference'")
    try:
        return _OPERATORS[(physics, scheme)]
    except KeyError:
        raise ValueError(
            f"no operator for physics={physics!r}, scheme={scheme!r}; "
            f"known: {sorted(_OPERATORS)}") from None


__all__ = [
    "simulate_acoustic",
    "acoustic_gradient",
    "AcousticConfig",
    "simulate_elastic",
    "simulate_elastic_fast",
    "elastic_gradient",
    "ElasticConfig",
    "trace_normalize",
    "l1_misfit",
    "l2_misfit",
    "huber_misfit",
    "normalized_trace_misfit",
    "depth_weighting",
    "water_mask",
    "taper_top",
    "rescale_to_model",
    "ssim",
    "select_operator",
]
