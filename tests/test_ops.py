"""Device kernels and the plain versions they must match: the wavefront
relaxation (CUDA kernel on the GPU, XLA loop elsewhere) and the descriptor
cross-check matcher."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nclt_slam_tpu.config import DEFAULT
from nclt_slam_tpu.ops import wavefront_cuda
from nclt_slam_tpu.planning.wavefront import BIG, plan_window, relax, relax_xla
from nclt_slam_tpu.sensors.features import (
    cross_check_match,
    cross_check_match_reference,
)


def _walled_windows(n, R, C=None, seed=0):
    """Traversal-cost windows with lethal walls and one goal each."""
    C = C or R
    rng = np.random.RandomState(seed)
    tc = rng.uniform(0.1, 1.0, (n, R, C)).astype(np.float32)
    tc[:, R // 3:R // 3 + 4, C // 6:C - C // 6] = BIG   # a wall, gaps at ends
    phi0 = np.full((n, R, C), BIG, np.float32)
    phi0[:, 5, 5] = 0.0
    return jnp.asarray(tc), jnp.asarray(phi0)


def _export_text(fn, *shapes, platform):
    exp = jax.export.export(
        jax.jit(fn), platforms=[platform],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            wavefront_cuda.TARGET)])(
        *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])
    return exp.mlir_module()


# ---------------------------------------------------------------------------
# wavefront relaxation
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 64, 64), (15, 192, 192), (2, 61, 90)])
def test_cuda_wavefront_matches_xla(gpu, shape):
    """On the card the kernel is bit-identical to the XLA loop on every
    reachable cell (same f32 adds and mins, same order)."""
    n, R, C = shape
    tc, p0 = _walled_windows(n, R, C)
    n_iter = 2 * max(R, C)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda t, p: relax_xla(t, p, n_iter)))(tc, p0))
    out = np.asarray(jax.jit(jax.vmap(
        lambda t, p: relax(t, p, n_iter)))(tc, p0))
    live = ref < BIG / 2
    assert live.sum() > live.size * 0.5
    assert np.array_equal(out[live], ref[live])
    assert (out[~live] >= BIG / 2).all()


@pytest.mark.parametrize("n_iter", [0, 1, 96])
def test_relax_equals_reference_on_cpu(n_iter):
    """Off the GPU, relax is the XLA loop: bit-equal, batched or not."""
    tc, p0 = _walled_windows(3, 48)
    ref = np.asarray(jax.vmap(lambda t, p: relax_xla(t, p, n_iter))(tc, p0))
    out = np.asarray(jax.jit(jax.vmap(
        lambda t, p: relax(t, p, n_iter)))(tc, p0))
    assert np.array_equal(out, ref)
    one = np.asarray(jax.jit(lambda t, p: relax(t, p, n_iter))(tc[1], p0[1]))
    assert np.array_equal(one, ref[1])


def test_relax_lowers_kernel_on_cuda_only():
    """The platform picks the implementation: CUDA lowers one custom call
    and no loop, the CPU lowers the while loop and no custom call."""
    f = lambda t, p: relax(t, p, 96)  # noqa: E731
    cuda = _export_text(f, (48, 48), (48, 48), platform="cuda")
    cpu = _export_text(f, (48, 48), (48, 48), platform="cpu")
    assert cuda.count(f"@{wavefront_cuda.TARGET}") == 1
    assert "stablehlo.while" not in cuda
    assert wavefront_cuda.TARGET not in cpu
    assert "stablehlo.while" in cpu


def test_relax_batch_reaches_kernel_whole():
    """Under nested vmap (routes x candidates) the whole batch is ONE
    kernel call with the batch as leading axes, at the window's own shape
    (no padding: the kernel takes any R x C)."""
    f = jax.vmap(jax.vmap(lambda t, p: relax(t, p, 10)))
    txt = _export_text(f, (2, 3, 61, 90), (2, 3, 61, 90), platform="cuda")
    calls = [ln for ln in txt.splitlines()
             if f"@{wavefront_cuda.TARGET}" in ln]
    assert len(calls) == 1
    assert "tensor<2x3x61x90xf32>" in calls[0]
    assert "n_iter = 10" in calls[0]


def test_cuda_build_fails_loudly(tmp_path, monkeypatch):
    """A kernel that cannot be built fails the run (no silent fallback),
    and the library name follows the source, so an edit rebuilds."""
    monkeypatch.setattr(wavefront_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(wavefront_cuda, "_nvcc", lambda: "/bin/false")
    lib = wavefront_cuda.library_path()
    assert lib.parent == tmp_path and lib.suffix == ".so"
    assert lib.name.startswith("libwavefront_")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        wavefront_cuda.build()
    assert not lib.exists()
    # the source and the build directory the README names
    assert wavefront_cuda.SOURCE.exists()
    ignored = (Path(__file__).resolve().parent.parent / ".gitignore")
    assert "nclt_slam_tpu/ops/build/" in ignored.read_text().split()


def test_plan_window_routes_around_wall():
    """plan_window through the platform's relaxation produces a working
    path around a lethal wall."""
    cfg = dataclasses.replace(DEFAULT.planner, window=64, path_len=96)
    W = 64
    cost = jnp.zeros((W, W))
    cost = cost.at[30:34, 8:56].set(99.0)  # lethal wall with gaps at edges
    res = plan_window(cost, (jnp.int32(10), jnp.int32(32)),
                      (jnp.int32(54), jnp.int32(32)), DEFAULT.map, cfg)
    assert bool(res.ok)
    path = np.asarray(res.path_xy[: int(res.n_path)])
    # path must route around the wall, not through it
    for r, c in path:
        assert not (30 <= r < 34 and 8 <= c < 56), (r, c)
    assert int(res.n_path) > 40


# ---------------------------------------------------------------------------
# descriptor cross-check matcher vs a numpy popcount brute force
# ---------------------------------------------------------------------------


def _descs(rng, n, w=8):
    return rng.randint(0, 2 ** 32, (n, w), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("A,B", [(96, 192), (128, 96), (192, 384), (7, 5),
                                 (192, 192)])
def test_cross_check_matches_bruteforce(A, B):
    """Exact agreement across shapes, with shared rows (true matches),
    invalid slots and sizes that fit no tile."""
    rng = np.random.RandomState(7)
    da = _descs(rng, A)
    db = _descs(rng, B)
    nsh = min(A, B) // 2
    db[:nsh] = da[rng.permutation(A)[:nsh]]
    va = rng.rand(A) > 0.2
    vb = rng.rand(B) > 0.2
    got = jax.jit(lambda *a: cross_check_match(*a, max_dist=64,
                                               return_dist=True))(
        da, va, db, vb)
    want = cross_check_match_reference(da, va, db, vb, max_dist=64)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), w), (A, B)
    assert want[1].sum() > 0


def test_cross_check_matches_bruteforce_vmapped():
    """The anchor matcher vmaps the cross-check over candidate views."""
    rng = np.random.RandomState(3)
    C, A, B = 5, 96, 192
    da = np.stack([_descs(rng, A) for _ in range(C)])
    db = _descs(rng, B)
    db[:40] = da[0, :40]
    va = rng.rand(C, A) > 0.2
    vb = rng.rand(B) > 0.2
    mi, mo = jax.jit(jax.vmap(
        lambda d, v: cross_check_match(d, v, db, vb, max_dist=64)))(da, va)
    for c in range(C):
        bi, bm, _ = cross_check_match_reference(da[c], va[c], db, vb)
        assert np.array_equal(np.asarray(mi[c]), bi)
        assert np.array_equal(np.asarray(mo[c]), bm)
