"""The GPU kernels' dispatch, wrappers and arithmetic, checked on the CPU:
the capability check, the Pallas kernels in the interpreter (ragged
sizes, masking, the near-field layout), the compile-cache placement and
chip_smoke.py's refusal to run without a GPU. The `gpu`-marked tests
compile the kernels for the card and skip elsewhere."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from rigidmultiblobswall_tpu.ops import backend, ewald, mobility as mob
from rigidmultiblobswall_tpu.ops import pair_kernels
from rigidmultiblobswall_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# capability check: CPU "auto" gives XLA, an explicit kernel raises
# ---------------------------------------------------------------------------


def test_auto_resolves_to_xla_on_cpu():
    assert not backend.kernels_available(jnp.float32)
    assert not backend.use_kernel("auto", jnp.float32)
    assert not backend.use_kernel("xla", jnp.float32)
    assert backend.use_kernel("pallas", jnp.float32, interpret=True)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_explicit_kernel_without_gpu_raises(dtype):
    with pytest.raises(ValueError, match="CUDA GPU"):
        backend.use_kernel("pallas", dtype)


def test_pairwise_pallas_request_raises_on_cpu():
    r = jnp.asarray(np.random.default_rng(0).uniform(1, 3, (10, 3)),
                    jnp.float32)
    with pytest.raises(ValueError, match="CUDA GPU"):
        mob.pairwise_matvec(r, r, r, 1.0, 0.3, method="pallas")
    # outside the kernel's scope an explicit request raises as well
    with pytest.raises(ValueError, match="does not cover"):
        mob.pairwise_matvec(r, r, r, 1.0, 0.3, method="pallas",
                            periodic_length=(5.0, 5.0, 0.0))
    # "auto" on the CPU runs the XLA engines
    out = mob.pairwise_matvec(r, r, r, 1.0, 0.3)
    assert out.shape == (10, 3) and bool(jnp.all(jnp.isfinite(out)))


def test_pair_kernel_launch_without_interpret_raises_on_cpu():
    q = jnp.ones((4, 3), jnp.float32)
    with pytest.raises(ValueError, match="CUDA GPU"):
        pair_kernels.pair_matvec_pallas(q, q, q)


# ---------------------------------------------------------------------------
# pair kernel: ragged sizes and masking (Pallas interpreter)
# ---------------------------------------------------------------------------


def _ragged(n_src, n_tgt, seed):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 4, (n_src, 3))
    src[:, 2] = rng.uniform(0.2, 3, n_src)
    tgt = rng.uniform(0, 4, (n_tgt, 3))
    tgt[:, 2] = rng.uniform(0.2, 3, n_tgt)
    v = rng.normal(size=(n_src, 3))
    return src, tgt, v


@pytest.mark.parametrize("coupling", ["tt", "tr", "rt", "rr"])
@pytest.mark.parametrize("n_src,n_tgt", [(45, 29), (17, 70)])
def test_pair_kernel_ragged_sizes(coupling, n_src, n_tgt):
    """N a multiple of neither tile: masked loads zero the padded
    sources, masked stores drop the padded targets."""
    src, tgt, v = _ragged(n_src, n_tgt, seed=n_src + n_tgt)
    a, eta = 0.3, 1.0
    ref = mob.pairwise_matvec(jnp.asarray(src), jnp.asarray(tgt),
                              jnp.asarray(v), eta, a, coupling=coupling,
                              domain="no_wall", self_interaction=False,
                              method="generic")
    got = pair_kernels.pair_matvec_pallas(
        jnp.asarray(src / a, jnp.float32), jnp.asarray(tgt / a, jnp.float32),
        jnp.asarray(v, jnp.float32), coupling=coupling, wall=False,
        self_interaction=False, tiles=(16, 8, 4), interpret=True)
    got = np.asarray(got) / (8 * np.pi * eta * a ** mob._PREF_POW[coupling])
    ref = np.asarray(ref)
    assert got.shape == (n_tgt, 3)
    np.testing.assert_allclose(got, ref, atol=3e-6 * np.abs(ref).max())


def test_pair_kernel_tiles_do_not_change_the_result():
    src, _, v = _ragged(53, 1, seed=3)
    q = jnp.asarray(src / 0.3, jnp.float32)
    vv = jnp.asarray(v, jnp.float32)
    outs = [np.asarray(pair_kernels.pair_matvec_pallas(
        q, q, vv, coupling="tt", tiles=t, interpret=True))
        for t in [(8, 8, 4), (16, 32, 4), (64, 64, 8)]]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=0,
                                   atol=1e-6 * np.abs(outs[0]).max())


def test_pair_kernel_padded_sources_carry_no_strength():
    """A source block padded past N must add nothing, even for a target
    sitting exactly where the padding places sources (0, 0, 1)."""
    q = jnp.asarray([[0.0, 0.0, 1.0], [2.5, 0.0, 1.5], [0.0, 3.0, 2.0]],
                    jnp.float32)
    v = jnp.asarray(np.random.default_rng(4).normal(size=(3, 3)),
                    jnp.float32)
    full = pair_kernels.pair_matvec_pallas(q, q, v, coupling="tt",
                                           tiles=(4, 4, 4), interpret=True)
    exact = pair_kernels.pair_matvec_pallas(q, q, v, coupling="tt",
                                            tiles=(4, 2, 4), interpret=True)
    assert bool(jnp.all(jnp.isfinite(full)))
    np.testing.assert_allclose(np.asarray(full), np.asarray(exact),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# near-field kernel on a small plan (Pallas interpreter)
# ---------------------------------------------------------------------------


def _small_plan(near_impl="pallas", n=240, seed=5, **kw):
    rng = np.random.default_rng(seed)
    L = 20.0
    pos = jnp.asarray(rng.uniform(0, L, (n, 3)), jnp.float32)
    p = ewald.default_params(0.5, 1.3, (L, L, L), tol=1e-4, grid_max=64)
    p = dataclasses.replace(p, near_impl=near_impl, **kw)
    return ewald.make_plan(p, pos), rng


@pytest.mark.parametrize("rows,chunk", [(16, 64), (8, 32)])
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_near_kernel_matches_xla_sweep(rows, chunk, n_rhs):
    plan, rng = _small_plan(near_rows=rows, near_chunk=chunk)
    C, S = plan.src_ids.shape
    assert S % chunk == 0 and S >= 27 * plan.params.cell_capacity
    assert C == int(np.prod(plan.cell_dims))
    f = jnp.asarray(rng.normal(size=(240, 3 * n_rhs)), jnp.float32)
    ref = np.asarray(ewald.real_matvec_xla(plan, f))
    got = np.asarray(ewald.real_matvec_pallas(plan, f, interpret=True))
    np.testing.assert_allclose(got, ref, atol=5e-6 * np.abs(ref).max())


def test_near_kernel_request_raises_on_cpu():
    plan, rng = _small_plan()
    f = jnp.asarray(rng.normal(size=(240, 3)), jnp.float32)
    with pytest.raises(ValueError, match="CUDA GPU"):
        ewald.real_matvec(plan, f)
    # "auto" builds no layout here and runs the XLA sweep
    auto, _ = _small_plan(near_impl="auto")
    assert auto.src_pos is None
    assert ewald.real_matvec(auto, f).shape == (240, 3)


def test_near_kernel_refused_for_mixed_radii():
    L = 20.0
    p = ewald.default_params(0.5, 1.3, (L, L, L), tol=1e-4, grid_max=64)
    p = dataclasses.replace(p, radii=(0.4, 0.5), near_impl="pallas")
    pos = jnp.asarray(np.random.default_rng(6).uniform(0, L, (50, 3)))
    with pytest.raises(ValueError, match="mixed radii"):
        ewald.make_plan(p, pos, group_of=np.zeros(50, np.int32))


# ---------------------------------------------------------------------------
# compile cache placement
# ---------------------------------------------------------------------------


def test_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.default_cache_dir() is None
    calls = []
    monkeypatch.setattr("jax.config.update",
                        lambda k, v: calls.append((k, v)))
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in [k for k, _ in calls]


def test_cache_dir_defaults_to_the_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.default_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    calls = []
    monkeypatch.setattr("jax.config.update",
                        lambda k, v: calls.append((k, v)))
    assert cache.enable_compilation_cache() == path
    assert ("jax_compilation_cache_dir", path) in calls


# ---------------------------------------------------------------------------
# chip_smoke.py without a GPU
# ---------------------------------------------------------------------------


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


# ---------------------------------------------------------------------------
# on the card (skip elsewhere)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("coupling", ["tt", "grand"])
def test_pair_kernel_compiled_on_gpu(gpu, coupling):
    src, _, _ = _ragged(1000, 1, seed=7)
    nin = 6 if coupling == "grand" else 3
    v = np.random.default_rng(8).normal(size=(1000, nin))
    q = jnp.asarray(src / 0.3, jnp.float32)
    got = pair_kernels.pair_matvec_pallas(q, q, jnp.asarray(v, jnp.float32),
                                          coupling=coupling)
    ref = pair_kernels.pair_matvec_pallas(q, q, jnp.asarray(v, jnp.float32),
                                          coupling=coupling, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=2e-6 * np.abs(np.asarray(ref)).max())


@pytest.mark.gpu
def test_near_kernel_compiled_on_gpu(gpu):
    plan, rng = _small_plan()
    f = jnp.asarray(rng.normal(size=(240, 3)), jnp.float32)
    ref = np.asarray(ewald.real_matvec_xla(plan, f))
    got = np.asarray(ewald.real_matvec(plan, f))
    np.testing.assert_allclose(got, ref, atol=5e-6 * np.abs(ref).max())
