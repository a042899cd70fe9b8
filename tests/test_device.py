"""The device helper and the compile-cache location rules."""
import os
import pathlib
import subprocess
import sys

from smallz4_tpu.utils import device, jaxcfg

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_device_info_reports_cpu_backend():
    info = device.info()
    assert info == {"platform": "cpu", "kind": "cpu", "count": 8}


def _cache_dir_in_fresh_process(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    res = subprocess.run(
        [sys.executable, "-c",
         "import jax, smallz4_tpu.ops; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True)
    return res.stdout.strip()


def test_compile_cache_honours_env(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_in_fresh_process(want) == want


def test_compile_cache_defaults_to_repo_dir():
    want = str(REPO / ".jax_cache")
    assert jaxcfg.DEFAULT_CACHE_DIR == pathlib.Path(want)
    assert _cache_dir_in_fresh_process(None) == want
