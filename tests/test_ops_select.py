"""The one propagator selector (ops.select_operator) shared by data
prep, synthetic workloads, the engines and the benchmark."""

import pytest

from physicsbasedfwi2_tpu.ops import (
    select_operator, simulate_acoustic, simulate_elastic,
    simulate_elastic_fast,
)


@pytest.mark.parametrize("physics,scheme,path,fn", [
    ("acoustic", "auto", "xla", simulate_acoustic),
    ("acoustic", "reference", "xla", simulate_acoustic),
    ("elastic", "auto", "fast", simulate_elastic_fast),
    ("elastic", "reference", "reference", simulate_elastic),
])
def test_select_operator(physics, scheme, path, fn):
    assert select_operator(physics, scheme) == (path, fn)


@pytest.mark.parametrize("physics", ["acoustic", "elastic"])
def test_select_operator_rejects_removed_and_unknown(physics):
    with pytest.raises(ValueError, match="removed Pallas"):
        select_operator(physics, "pallas")
    with pytest.raises(ValueError, match="no operator"):
        select_operator(physics, "fused")


@pytest.mark.parametrize("workload", ["marmousi_acoustic",
                                      "marmousi_elastic"])
def test_engine_rejects_pallas_backend(workload):
    from physicsbasedfwi2_tpu.engine import create_engine, get_workload
    cfg = get_workload(workload, nz=40, nx=48, nt=40, num_shots=2,
                       num_receivers=8, water_rows=6, pml_width=8,
                       chunk=10, filters=(4, 8)).replace(
                           name="t_pallas", backend="pallas",
                           validate_on_twin=False)
    with pytest.raises(ValueError, match="removed Pallas"):
        create_engine(cfg)
