"""The persistent compile cache helper (utils/compile_cache.py): the
environment variable wins and nothing is set in code; on a GPU backend
the cache lives at a fixed path inside the checkout; the CPU backend is
left alone."""
import os

import jax

from bayesiandatafusion_jl_tpu.utils import compile_cache as cc


def test_env_var_wins_and_sets_nothing(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    assert cc.enable_compile_cache(backend="gpu") == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_gpu_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".cache", "jax_compile")
    try:
        assert cc.enable_compile_cache(backend="gpu") == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
        # idempotent: a second call names the same directory
        assert cc.enable_compile_cache(backend="gpu") == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cpu_backend_sets_nothing(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert jax.default_backend() == "cpu"
    assert cc.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
