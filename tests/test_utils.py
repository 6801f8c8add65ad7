"""Compile-cache placement: $JAX_COMPILATION_CACHE_DIR when set, else the
fixed in-checkout directory. Each case runs in a fresh interpreter, since
JAX fixes its cache directory at the first compile of a process."""

import json
import os
import subprocess
import sys

from h264_fer.utils import REPO_CACHE_DIR

_PROBE = """
import json, jax, jax.numpy as jnp
from h264_fer.utils import enable_compilation_cache
used = enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
print(json.dumps([used, jax.config.jax_compilation_cache_dir]))
"""


def _probe(env_cache):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_cache is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_cache)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         cwd=REPO_CACHE_DIR.parent, check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def _listing(path):
    return sorted(os.listdir(path)) if path.exists() else []


def test_cache_honours_env_dir(tmp_path):
    before = _listing(REPO_CACHE_DIR)
    used, configured = _probe(tmp_path)
    assert used == configured == str(tmp_path)
    assert os.listdir(tmp_path), "nothing was written to the cache"
    assert _listing(REPO_CACHE_DIR) == before


def test_cache_defaults_to_repo_dir():
    used, configured = _probe(None)
    assert used == configured == str(REPO_CACHE_DIR)
    assert REPO_CACHE_DIR.is_dir()
