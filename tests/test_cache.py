"""utils.cache.enable_persistent_cache: JAX_COMPILATION_CACHE_DIR wins
untouched; otherwise <repo root>/.cache/jax whatever the cwd.  Each
case runs in a fresh interpreter because the setting is process-wide."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
         "from physicsbasedfwi2_tpu.utils.cache import "
         "enable_persistent_cache as e; "
         "print(e()); print(jax.config.jax_compilation_cache_dir)")


def _probe(cwd, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


@pytest.mark.parametrize("where", ["repo", "elsewhere"])
def test_cache_defaults_to_repo_root(tmp_path, where):
    cwd = REPO if where == "repo" else str(tmp_path)
    returned, configured = _probe(cwd, None)
    assert returned == configured == os.path.join(REPO, ".cache", "jax")
    assert not (tmp_path / ".cache").exists()


def test_cache_env_var_is_left_alone(tmp_path):
    d = str(tmp_path / "cc")
    returned, configured = _probe(str(tmp_path), d)
    assert returned == configured == d
