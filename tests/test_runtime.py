"""Process set-up (nclt_slam_tpu/runtime.py) and chip_smoke.py's refusals."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from nclt_slam_tpu import runtime

REPO = Path(__file__).resolve().parent.parent


def _run(code, env_extra, cwd=REPO, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(JAX_PLATFORMS="cpu", **env_extra)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cache_dir_env_honored():
    assert runtime.compile_cache_dir(
        {runtime.CACHE_ENV: "/data/jax"}) == Path("/data/jax")


def test_cache_dir_default_fixed_in_checkout():
    """Without the variable: one fixed path in the checkout, listed in
    .gitignore, not built from a temporary name, a pid or the time."""
    assert runtime.compile_cache_dir({}) == REPO / ".jax_cache"
    assert runtime.compile_cache_dir({runtime.CACHE_ENV: ""}) == \
        REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_init_runtime_leaves_env_to_jax(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(runtime.CACHE_ENV, "/data/jax")
    assert runtime.init_runtime() == Path("/data/jax")
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_lands_in_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from nclt_slam_tpu.runtime import init_runtime\n"
        "init_runtime()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir)\n")
    out = _run(code, {runtime.CACHE_ENV: str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)
    assert any(tmp_path.iterdir())


def test_cache_default_dir_set_without_env():
    code = ("import jax\nfrom nclt_slam_tpu.runtime import init_runtime\n"
            "print(init_runtime('cpu'))\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = _run(code, {}, drop=(runtime.CACHE_ENV,))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == lines[-1] == str(REPO / ".jax_cache")


# ---------------------------------------------------------------------------
# chip_smoke.py refuses anything but a GPU
# ---------------------------------------------------------------------------


def test_chip_smoke_refuses_cpu():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)
    assert "NVIDIA GPU" in str(exc.value.code)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_exits_nonzero_without_gpu(tmp_path, alone):
    """On the CPU, and in a directory holding only the script, it exits
    nonzero and prints no result line."""
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
