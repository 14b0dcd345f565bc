"""physicsbasedfwi2_tpu — physics-based full-waveform inversion in JAX.

A ground-up JAX rebuild of the capabilities of
ADharaUTEXAS123007/PhysicsBasedFWI2 (deep-image-prior seismic FWI):

- 2D acoustic and elastic (P-SV) staggered-grid finite-difference
  propagators with PML absorbing boundaries, differentiable end-to-end
  via checkpointed `lax.scan` (replacing the reference's deepwave
  C++/CUDA and DENISE Fortran/MPI engines).
- Generator zoo (autoencoder/U-Net/VAE/normalizing-flow/FNO/GAN) on a
  small Flax-compatible module layer (models/nn.py),
  reparameterizing the velocity/elastic model.
- Shot-parallel sharding over a `jax.sharding.Mesh` with `shard_map`
  + `psum` (replacing Ray / MPI fan-out).
- optax-based optimizers incl. L-BFGS with Wolfe line search, SGLD,
  SGHMC; frequency-continuation training drivers; .npz checkpointing.

Layout:
    geo/        grids, acquisition geometry, wavelets, filters, units
    ops/        propagators, misfit functions, gradient post-processing
    models/     network zoo + registry (define_G equivalent)
    parallel/   mesh construction, shot-sharded gradients
    optim/      optimizers and LR schedules
    data/       dataset registry, .npy loaders, synthetic workloads
    engine/     inversion engines, train/test drivers, checkpointing
    landscape/  loss-surface sweeps and Hessian spectra
    utils/      ssim, HTML galleries, misc
"""

__version__ = "0.1.0"

from physicsbasedfwi2_tpu import geo, ops  # noqa: F401
