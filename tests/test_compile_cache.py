"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins when set,
otherwise one fixed directory inside the checkout (lstm_ctc_tpu.cli)."""

import os

import jax
import pytest

from lstm_ctc_tpu import cli


@pytest.fixture
def restore_cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_env_var_wins(monkeypatch, tmp_path, restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cli.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is configured
    assert jax.config.jax_compilation_cache_dir is None


@pytest.mark.parametrize("platforms", ["cpu", "cuda", "cpu,cuda", ""])
def test_fixed_in_repo_path_otherwise(monkeypatch, platforms,
                                      restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    want = os.path.join(cli.REPO_ROOT, ".jax_cache")
    assert cli.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_repo_root_is_the_checkout():
    assert os.path.isfile(os.path.join(cli.REPO_ROOT, "chip_smoke.py"))
    assert os.path.isfile(os.path.join(cli.REPO_ROOT, ".gitignore"))
    assert ".jax_cache/" in open(
        os.path.join(cli.REPO_ROOT, ".gitignore")).read().split()
