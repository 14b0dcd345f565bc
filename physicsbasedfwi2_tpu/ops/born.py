"""Born (linearized) modeling.

Capability-equivalent of Devito's ``BornOperator``
(/root/reference/seisgan/fwi/pde/seismic/acoustic/operators.py:168):
single-scattering data from a model perturbation.  Here this is
exactly the JVP of the nonlinear forward operator — one
forward-over-forward pass, no extra kernel needed.
"""

from __future__ import annotations

import jax

from physicsbasedfwi2_tpu.ops.acoustic import AcousticConfig, simulate_acoustic


def born_acoustic(vp, dvp, wavelet, src_z, src_x, rcv_z, rcv_x,
                  cfg: AcousticConfig):
    """Linearized scattered data d(recs)/d(vp) . dvp.

    Returns (background_recs, scattered_recs), both [ns, nt, nr].
    """

    def fwd(v):
        return simulate_acoustic(v, wavelet, src_z, src_x, rcv_z, rcv_x,
                                 cfg)

    return jax.jvp(fwd, (vp,), (dvp,))


def born_elastic(vp, vs, rho, dvp, dvs, wavelet, src_z, src_x, rcv_z,
                 rcv_x, cfg):
    """Elastic Born modeling w.r.t. (vp, vs) perturbations."""
    from physicsbasedfwi2_tpu.ops.elastic import simulate_elastic

    def fwd(vp_, vs_):
        return simulate_elastic(vp_, vs_, rho, wavelet, src_z, src_x,
                                rcv_z, rcv_x, cfg)

    return jax.jvp(fwd, (vp, vs), (dvp, dvs))
