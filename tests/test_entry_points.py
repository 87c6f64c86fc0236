"""Entry-point contracts that hold on any machine: where the persistent
compile cache lives (utils/cache.py), and chip_smoke.py's refusal to run
anywhere but on a GPU with the repository beside it."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from gltf_renderer.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("subdir", ["", "cpu-tests"])
def test_cache_dir_is_the_env_var_when_set(monkeypatch, tmp_path, subdir):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.cache_dir(subdir) == str(tmp_path)


@pytest.mark.parametrize("subdir", ["", "cpu-tests"])
def test_cache_dir_defaults_inside_the_checkout(monkeypatch, subdir):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    want = os.path.join(ROOT, ".jax_cache", subdir) if subdir else os.path.join(
        ROOT, ".jax_cache")
    assert cache.cache_dir(subdir) == want
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_uses_only_the_env_dir(tmp_path):
    """A fresh process with JAX_COMPILATION_CACHE_DIR set: JAX's cache
    directory is that one, and nothing is created in the checkout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    code = ("import jax; from gltf_renderer.utils.cache import "
            "enable_compilation_cache as e; e('sub'); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)
    assert not os.path.exists(os.path.join(ROOT, ".jax_cache", "sub"))


@pytest.mark.parametrize("argv", [[], ["--cards", "4"], ["--phases", "kernel"]])
def test_chip_smoke_refuses_cpu(capsys, argv):
    """No GPU: a non-zero exit and nothing on stdout (no result line)."""
    assert chip_smoke.main(argv) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no GPU" in captured.err


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory that holds nothing else of the repo
    exits non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
