"""Compile-cache placement (``slam_tpu/utils/cache.py``)."""

import os
import pathlib

import jax

from slam_tpu.utils import cache

_REPO = pathlib.Path(__file__).resolve().parents[1]


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_leaves_cache_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert cache.enable_persistent_cache() is None
    assert calls == []


def test_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    path = cache.enable_persistent_cache()
    assert calls == [("jax_compilation_cache_dir", path)]
    assert path == cache.DEFAULT_CACHE_DIR
    assert pathlib.Path(path).parent == _REPO
    assert cache.enable_persistent_cache() == path  # fixed, not per call


def test_default_cache_dir_is_gitignored():
    name = os.path.basename(cache.DEFAULT_CACHE_DIR)
    ignored = (_REPO / ".gitignore").read_text().split()
    assert f"{name}/" in ignored or name in ignored
