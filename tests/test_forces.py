"""Blob-blob force kernels: direct O(N^2) sweep vs the linked-cell
neighbor-list variant (the reference's kd-tree O(N) backend,
forces_numba.py:142-241)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rigidmultiblobswall_tpu.ops import forces as force_ops


def _params():
    # debye 0.05 -> cutoff 2a + 30b = 2.1 (realistic short-ranged repulsion)
    return dict(repulsion_strength=0.7, debye_length=0.05, blob_radius=0.3)


def test_neighbor_list_matches_direct_open_domain():
    rng = np.random.default_rng(0)
    r = jnp.asarray(rng.uniform(0, 12, (400, 3)))
    f_direct = force_ops.blob_blob_forces(r, **_params())
    f_nl = force_ops.blob_blob_forces_neighbor_list(r, **_params())
    scale = float(jnp.max(jnp.abs(f_direct)))
    # pairs beyond the 2a + 30b cutoff contribute < exp(-30) ~ 1e-13
    assert np.allclose(np.asarray(f_nl), np.asarray(f_direct),
                       atol=1e-10 * max(scale, 1.0))


def test_neighbor_list_matches_direct_clustered():
    """Dense cluster: many blobs share cells, overlapping pairs hit the
    linear branch of the potential."""
    rng = np.random.default_rng(1)
    r = jnp.asarray(rng.normal(0, 0.8, (300, 3)))
    f_direct = force_ops.blob_blob_forces(r, **_params())
    f_nl = force_ops.blob_blob_forces_neighbor_list(r, cell_capacity=512,
                                                    **_params())
    scale = float(jnp.max(jnp.abs(f_direct)))
    assert np.allclose(np.asarray(f_nl), np.asarray(f_direct),
                       atol=1e-10 * scale)


def test_neighbor_list_matches_direct_periodic():
    rng = np.random.default_rng(2)
    L = 12.0
    r = jnp.asarray(rng.uniform(0, L, (500, 3)))
    kw = dict(_params(), periodic_length=(L, L, 0.0))
    f_direct = force_ops.blob_blob_forces(r, **kw)
    f_nl = force_ops.blob_blob_forces_neighbor_list(r, **kw)
    scale = float(jnp.max(jnp.abs(f_direct)))
    assert np.allclose(np.asarray(f_nl), np.asarray(f_direct),
                       atol=1e-10 * scale)


def test_neighbor_list_small_periodic_box_falls_back():
    """A periodic box under 4 cutoffs wide cannot host the wrapped
    27-cell stencil; the function must fall back to the direct sweep."""
    rng = np.random.default_rng(3)
    L = 6.0
    r = jnp.asarray(rng.uniform(0, L, (60, 3)))
    kw = dict(_params(), periodic_length=(L, L, L))
    f_direct = force_ops.blob_blob_forces(r, **kw)
    f_nl = force_ops.blob_blob_forces_neighbor_list(r, **kw)
    assert np.allclose(np.asarray(f_nl), np.asarray(f_direct), atol=1e-12)


def test_neighbor_list_custom_cutoff_drops_far_pairs():
    """With an explicit small cutoff only near pairs contribute; a far
    isolated pair must feel (almost) nothing."""
    r = jnp.asarray([[0.0, 0.0, 0.0], [0.7, 0.0, 0.0], [30.0, 0.0, 0.0]])
    f = force_ops.blob_blob_forces_neighbor_list(r, cutoff=2.0,
                                             **_params())
    assert abs(float(f[2, 0])) < 1e-12
    assert float(f[0, 0]) < 0 < float(f[1, 0])


def test_direct_forces_newton_third_law():
    rng = np.random.default_rng(4)
    r = jnp.asarray(rng.uniform(0, 5, (50, 3)))
    f = force_ops.blob_blob_forces(r, **_params())
    assert np.allclose(np.asarray(jnp.sum(f, axis=0)), 0.0, atol=1e-10)


def test_neighbor_list_pallas_cell_sweep_matches_generic():
    """The pre-gathered cell-layout sweep (the path fully-periodic
    boxes take) is exact vs the direct sum."""
    rng = np.random.default_rng(9)
    L = 12.0
    r = jnp.asarray(rng.uniform(0, L, (350, 3)), jnp.float32)
    kw = dict(_params(), periodic_length=(L, L, L))
    f_direct = force_ops.blob_blob_forces(r, **kw)
    rc = 2 * kw["blob_radius"] + 30 * kw["debye_length"]
    dims = tuple(min(int(L // rc), 16) for _ in range(3))
    f_pl = force_ops._neighbor_forces_layout(
        r, (L, L, L), dims, 64, kw["repulsion_strength"],
        kw["debye_length"], kw["blob_radius"])
    scale = float(jnp.max(jnp.abs(f_direct)))
    assert np.allclose(np.asarray(f_pl), np.asarray(f_direct),
                       atol=2e-6 * scale)


def test_neighbor_list_pallas_wall_slab_matches_direct():
    """The wall-slab layout branch (xy-periodic, open z bounded by
    spectral_wall_height) is exact vs the direct xy-periodic sum for
    in-slab configurations."""
    import math

    rng = np.random.default_rng(11)
    L = 12.0
    z_hi = 3.0
    n = 320
    r = np.empty((n, 3), np.float32)
    r[:, :2] = rng.uniform(0, L, (n, 2))
    r[:, 2] = rng.uniform(0.2, z_hi - 0.2, n)
    r = jnp.asarray(r)
    kw = dict(_params(), periodic_length=(L, L, 0.0))
    f_direct = force_ops.blob_blob_forces(r, **kw)
    rc = 2 * kw["blob_radius"] + 30 * kw["debye_length"]
    nd = min(int(L // rc), 16)
    cs_z = 1.001 * rc
    nz_w = max(int(math.ceil(z_hi / cs_z)), 1) + 1
    f_pl = force_ops._neighbor_forces_layout(
        r, (L, L, nz_w * cs_z), (nd, nd, nz_w), 64,
        kw["repulsion_strength"], kw["debye_length"], kw["blob_radius"],
        z_clip=(nz_w - 1) * cs_z * 0.999)
    scale = float(jnp.max(jnp.abs(f_direct)))
    assert np.allclose(np.asarray(f_pl), np.asarray(f_direct),
                       atol=2e-6 * scale)


def test_neighbor_list_overflow_wall_slab_monitor():
    """neighbor_list_overflow reproduces the wall-slab binning: cell
    overflow and above-slab (z-clamped) blobs are both counted."""
    from rigidmultiblobswall_tpu.models.system import (BodyType, System)

    t = BodyType(name="b", ref_config=np.zeros((1, 3)), count=1)
    L = 12.0
    base = dict(types=(t,), eta=1.0, blob_radius=0.3, kT=0.0,
                domain="single_wall_spectral", periodic_length=(L, L, 0.0),
                spectral_wall_height=3.0,
                blob_blob_force_method="neighbor_list",
                repulsion_strength=0.7, debye_length=0.05,
                blob_blob_grid_dim=16)
    rng = np.random.default_rng(3)
    n = 200
    r = np.empty((n, 3), np.float32)
    r[:, :2] = rng.uniform(0, L, (n, 2))
    r[:, 2] = rng.uniform(0.2, 2.8, n)

    sys_ok = System(**base, blob_blob_cell_capacity=64)
    assert int(force_ops.neighbor_list_overflow(sys_ok, jnp.asarray(r))) == 0

    # overflow: capacity 1 cannot hold clustered cells
    sys_tiny = System(**base, blob_blob_cell_capacity=1)
    assert int(force_ops.neighbor_list_overflow(
        sys_tiny, jnp.asarray(r))) > 0

    # above-slab blobs are counted even without cell overflow
    r_hi = r.copy()
    r_hi[:5, 2] = 50.0
    assert int(force_ops.neighbor_list_overflow(
        sys_ok, jnp.asarray(r_hi))) >= 5
