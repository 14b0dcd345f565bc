"""Test configuration: run on a virtual 8-device CPU mesh.

The tests run on the CPU; sharding tests emulate an 8-device topology
on the host (the standard JAX pattern for testing `shard_map` layouts
without several GPUs).  `jax.config.update` selects the platform here
because no backend has initialized yet at collection time.  The GPU
path is exercised by ``python chip_smoke.py`` on a machine with one.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Tests measured >20 s on the 1-CPU CI host (pytest --durations, round
# 4).  The fast lane `pytest -m "not slow"` runs the remaining
# analytic/adjoint/FD/golden pyramid in ~10 min; the full suite is the
# merge gate.  Parametrized names mark every param.
SLOW_TESTS = {
    "test_lbfgs_elastic_workload_descends",
    "test_landscape_cli_acoustic_and_elastic",
    "test_landscape_cli_trajectory",
    "test_supervised_batch_epoch_loop",
    "test_engine_with_mesh_trains",
    "test_elastic_engine_with_mesh_matches_single_device",
    "test_multi_sample_engine_direct_wave_and_warmup",
    "test_elastic_illumination_preconditioning",
    "test_elastic_dip_engine_trains",
    "test_encoded_gradient_correlates_with_full",
    "test_multi_sample_engine_sharded",
    "test_acoustic_dip_engine_trains",
    "test_supervised_engine_gan_and_ssim",
    "test_cyclegan_engine",
    "test_prep_acoustic_tree_trains_engine",
    "test_every_registered_generator_trains",
    "test_domain_decomposed_matches_single_device",
    "test_continue_train_and_opt_dump",
    "test_engine_from_dataroot",
    "test_elastic_lstart_warmup_then_physics",
    "test_sharded_elastic_matches_single_device",
    "test_autonf_logdet_in_loss",
    "test_real_data_su_to_train_end_to_end",
    "test_direct_wave_toggle_changes_loss",
    "test_vae_pretrain_then_latent_inversion",
    "test_elastic_field_gating",
    "test_elastic_rho_inversion",
    "test_sharded_acoustic_matches_single_device",
    "test_orbax_full_state_checkpoint",
    "test_elastic_parity_workload_runs",
    "test_elastic_gradient_tether",
    "test_elastic_snl2_misfit_shot_normalized",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.originalname in SLOW_TESTS or item.name in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
