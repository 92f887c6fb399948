"""The compile-cache rule (core/cache.py) and chip_smoke.py's refusal to
run without a GPU."""
import os
import subprocess
import sys

import jax

from drmlt_mitsuba.core import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


BLOCK_OPTIONAL = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {mods}:
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
import drmlt_mitsuba
for m in pkgutil.walk_packages(drmlt_mitsuba.__path__, 'drmlt_mitsuba.'):
    importlib.import_module(m.name)
"""


def test_package_imports_with_jax_numpy_scipy_only():
    """Every module imports when only JAX, numpy and scipy are present
    (PIL, matplotlib and orbax stay lazy on the paths that use them)."""
    mods = {"flax", "PIL", "matplotlib", "orbax", "optax", "chex",
            "einops", "hypothesis", "pytest"}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c",
                        BLOCK_OPTIONAL.format(mods=sorted(mods))],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
