"""Spectral Ewald periodic RPY: split consistency, NUFFT machinery,
and literature physics (Hasimoto lattice drag).

Validation chain (each stage isolates one ingredient):
  1. xi-independence of brute-force real+wave sums -> the Hasimoto split
     and the quadrature-built real-space tables are mutually consistent.
  2. FFT/window matvec vs brute-force k-sum -> the NUFFT spreading,
     deconvolution, and normalization.
  3. Self-mobility of a dilute periodic array vs Hasimoto's 1.7601
     sc-lattice coefficient -> absolute normalization against published
     theory, independent of this implementation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rigidmultiblobswall_tpu.ops import ewald

A, ETA = 0.5, 1.3
BOX = (20.0, 20.0, 20.0)


@pytest.fixture(scope="module")
def small_system():
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, BOX[0], size=(16, 3))
    f = rng.normal(size=(16, 3))
    return pos, f


def _brute(params, pos, f, n_waves=30):
    return (ewald.brute_force_real(params, pos, f)
            + ewald.brute_force_wave(params, pos, f, n_waves=n_waves))


def test_split_is_xi_independent(small_system):
    pos, f = small_system
    p1 = ewald.default_params(A, ETA, BOX, tol=1e-6, n_table=4096)
    p2 = ewald.default_params(A, ETA, BOX, tol=1e-6, r_cut_factor=9.0,
                              n_table=4096)
    assert abs(p1.xi - p2.xi) > 0.2  # genuinely different splits
    u1 = _brute(p1, pos, f)
    u2 = _brute(p2, pos, f)
    err = np.linalg.norm(u1 - u2) / np.linalg.norm(u1)
    assert err < 2e-6, err


def test_table_quadrature_converged():
    p = ewald.default_params(A, ETA, BOX, tol=1e-6)
    r = np.linspace(0.0, p.r_cut, 64)
    c1 = ewald.wave_freespace_scalars(r, A, ETA, p.xi, n_k=1001)
    c2 = ewald.wave_freespace_scalars(r, A, ETA, p.xi, n_k=4001)
    for a, b in zip(c1, c2):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_chebyshev_fit_matches_quadrature_tables():
    """The device-side Clenshaw evaluation must agree with the host
    quadrature tables well below the engine tolerance (auto-degree)."""
    from numpy.polynomial import chebyshev as npcheb

    for tol in (1e-4, 1e-6):
        p = ewald.default_params(A, ETA, BOX, tol=tol)
        co, _ = ewald._host_cheb(p)
        r, a_tab, b_tab, _ = ewald.realspace_tables(
            p.a, p.eta, p.xi, p.r_cut, n_points=p.n_table)
        scale = 1.0 / (6 * np.pi * ETA * A)
        for i, (lo, hi) in enumerate([(0, 2 * A), (2 * A, p.r_cut)]):
            m = (r >= lo) & (r <= hi)
            t = (2 * r[m] - (hi + lo)) / (hi - lo)
            for j, tab in enumerate((a_tab, b_tab)):
                err = np.abs(npcheb.chebval(t, co[i, j]) - tab[m]).max()
                assert err / scale < 0.05 * tol, (tol, i, j, err / scale)


def test_remainder_decays_at_cutoff():
    """The real-space remainder must be ~erfc-small at r_cut, or the
    cell-list truncation would bite."""
    p = ewald.default_params(A, ETA, BOX, tol=1e-6)
    r, al, be, _ = ewald.realspace_tables(A, ETA, p.xi, p.r_cut)
    scale = 1.0 / (6 * np.pi * ETA * A)
    assert abs(al[-1]) / scale < 1e-6
    assert abs(be[-1]) / scale < 1e-6


@pytest.mark.parametrize("tol,expect", [(1e-4, 5e-4), (1e-6, 5e-6)])
def test_fft_matvec_matches_brute_force(small_system, tol, expect):
    pos, f = small_system
    p = ewald.default_params(A, ETA, BOX, tol=tol)
    ref = _brute(p, pos, f)
    plan = ewald.make_plan(p, jnp.asarray(pos))
    u = np.asarray(ewald.matvec(plan, jnp.asarray(f)))
    err = np.linalg.norm(u - ref) / np.linalg.norm(ref)
    assert err < expect, err


def test_matvec_translation_invariant(small_system):
    pos, f = small_system
    p = ewald.default_params(A, ETA, BOX, tol=1e-4)
    u0 = np.asarray(ewald.matvec(ewald.make_plan(p, jnp.asarray(pos)),
                                 jnp.asarray(f)))
    shift = np.array([3.7, -11.2, 40.9])
    u1 = np.asarray(ewald.matvec(
        ewald.make_plan(p, jnp.asarray(pos + shift)), jnp.asarray(f)))
    np.testing.assert_allclose(u1, u0, rtol=0, atol=2e-4 * np.max(np.abs(u0)))


def test_matvec_symmetric_positive(small_system):
    pos, _ = small_system
    p = ewald.default_params(A, ETA, BOX, tol=1e-4)
    plan = ewald.make_plan(p, jnp.asarray(pos))
    n = pos.shape[0] * 3

    def col(e):
        return ewald.matvec(plan, e.reshape(-1, 3)).reshape(-1)

    m = np.asarray(jax.vmap(col)(jnp.eye(n))).T
    np.testing.assert_allclose(m, m.T, atol=1e-6 * np.abs(m).max())
    w = np.linalg.eigvalsh(0.5 * (m + m.T))
    assert w.min() > -1e-10 * w.max(), w.min()


def test_hasimoto_lattice_drag():
    """One blob per cubic cell: U = F/(6 pi eta a) (1 - 1.7601 c^{1/3}
    + O(c)), c = (4 pi/3)(a/L)^3 (Hasimoto 1959). Extract the c^{1/3}
    coefficient from two dilute box sizes and compare to 1.7601."""
    coef = []
    for L in (20.0, 40.0):
        # grid_max=128 inflates r_cut for the bigger box; by split
        # invariance (test_split_is_xi_independent) the physics is
        # unchanged and the CPU FFTs are 8x cheaper
        p = ewald.default_params(A, ETA, (L, L, L), tol=1e-6, grid_max=128)
        plan = ewald.make_plan(p, jnp.asarray(np.zeros((1, 3))))
        f = jnp.asarray([[1.0, 0.0, 0.0]])
        u = float(np.asarray(ewald.matvec(plan, f))[0, 0])
        m0 = 1.0 / (6 * np.pi * ETA * A)
        c13 = ((4 * np.pi / 3) ** (1 / 3)) * A / L
        coef.append((1.0 - u / m0) / c13)
    # Richardson-extrapolate the O(c) contamination away: coef(L) =
    # 1.7601 + b/L^2-ish; the larger box is already close
    assert abs(coef[1] - 1.7601) < 0.02, coef
    assert abs(2 * coef[1] - coef[0] - 1.7601) < 0.05, coef


def test_wave_part_fft_vs_brute(small_system):
    """Isolate the NUFFT (no real-space part in the comparison)."""
    pos, f = small_system
    p = ewald.default_params(A, ETA, BOX, tol=1e-5)
    plan = ewald.make_plan(p, jnp.asarray(pos))
    u_fft = np.asarray(ewald.wave_matvec(plan, jnp.asarray(f)))
    u_ref = ewald.brute_force_wave(p, pos, f, n_waves=30)
    err = np.linalg.norm(u_fft - u_ref) / np.linalg.norm(u_ref)
    assert err < 3e-5, err


def test_spectral_engine_drives_brownian_step():
    """End-to-end: a periodic suspension of 12-blob shells takes one
    stochastic_Slip_Trapz step entirely on the spectral engine
    (domain='periodic_spectral' routes every GMRES/Lanczos product
    through ewald.matvec via saddle.maybe_dense_mobility)."""
    from rigidmultiblobswall_tpu.models import integrators
    from rigidmultiblobswall_tpu.models.system import (BodyType, System,
                                                       make_state)

    rng = np.random.default_rng(5)
    i = np.arange(12) + 0.5
    phi = np.arccos(1 - 2 * i / 12)
    th = np.pi * (1 + 5**0.5) * i
    shell = 0.3 * np.stack([np.cos(th) * np.sin(phi),
                            np.sin(th) * np.sin(phi), np.cos(phi)], axis=1)
    L = 8.0
    t = BodyType(name="shell", ref_config=shell, count=8)
    system = System(types=(t,), eta=1.0, blob_radius=0.1, kT=0.05, g=0.1,
                    domain="periodic_spectral",
                    periodic_length=(L, L, L), spectral_tol=1e-4,
                    spectral_grid_max=64,
                    repulsion_strength=0.1, debye_length=0.2,
                    solver_tolerance=1e-6)
    side = 2
    idx = np.arange(8)
    pos = np.stack([(idx % side), (idx // side) % side, idx // 4],
                   axis=1) * 3.0 + 1.0
    quat = rng.normal(size=(8, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    state = make_state(pos, quat)

    step = integrators.make_stepper(system, "stochastic_Slip_Trapz", 1e-3,
                                    lanczos_tolerance=1e-4,
                                    lanczos_max_iter=40, max_rejections=2)
    carry = integrators.init_carry(system, dtype=jnp.float64)
    new_state, _, aux = jax.jit(step)(state, jax.random.PRNGKey(0), carry)
    assert np.all(np.isfinite(np.asarray(new_state.pos)))
    assert int(aux.det_iterations) > 0
    assert int(aux.rejections) == 0
    # displacements bounded (no blow-up through the spectral path)
    disp = np.abs(np.asarray(new_state.pos) - pos).max()
    assert disp < 0.5, disp


def test_spectral_deterministic_matches_dilute_open_boundary():
    """A single body in a huge periodic box sediments like the unbounded
    problem to O(a/L): cross-validates the spectral saddle solve against
    the established open-boundary path."""
    from rigidmultiblobswall_tpu.models import solvers
    from rigidmultiblobswall_tpu.models.system import (BodyType, System,
                                                       make_state)

    i = np.arange(12) + 0.5
    phi = np.arccos(1 - 2 * i / 12)
    th = np.pi * (1 + 5**0.5) * i
    shell = 0.3 * np.stack([np.cos(th) * np.sin(phi),
                            np.sin(th) * np.sin(phi), np.cos(phi)], axis=1)
    t = BodyType(name="shell", ref_config=shell, count=1)
    L = 60.0
    kw = dict(types=(t,), eta=1.0, blob_radius=0.1, g=1.0,
              solver_tolerance=1e-8)
    sys_open = System(domain="no_wall", **kw)
    sys_per = System(domain="periodic_spectral",
                     periodic_length=(L, L, L), spectral_tol=1e-4,
                     spectral_grid_max=96, **kw)
    state = make_state([[30.0, 30.0, 30.0]], [[1.0, 0, 0, 0]])
    v_open = np.asarray(solvers.solve_mobility_problem(
        sys_open, state).velocities).ravel()
    v_per = np.asarray(solvers.solve_mobility_problem(
        sys_per, state).velocities).ravel()
    # the periodic image correction is ~2.84 a_eff/L ~ 2% here
    assert abs(v_per[2] - v_open[2]) / abs(v_open[2]) < 0.05
    assert abs(v_per[2]) < abs(v_open[2])  # images hinder sedimentation


def test_pallas_near_field_matches_xla():
    """The fused Pallas near-field sweep (plan-time pre-gathered source
    layout, piece-selected Clenshaw scalars) reproduces the XLA cell
    sweep on a dense random system (Pallas interpreter on the CPU)."""
    import dataclasses

    rng = np.random.default_rng(3)
    n = 300
    pos = rng.uniform(0.0, BOX[0], size=(n, 3)).astype(np.float32)
    f = rng.normal(size=(n, 3)).astype(np.float32)
    p = ewald.default_params(A, ETA, BOX, tol=1e-4, grid_max=64)
    plan_x = ewald.make_plan(
        dataclasses.replace(p, near_impl="xla"), jnp.asarray(pos))
    plan_p = ewald.make_plan(
        dataclasses.replace(p, near_impl="pallas"), jnp.asarray(pos))
    assert plan_p.src_pos is not None and plan_x.src_pos is None
    ux = np.asarray(ewald.real_matvec(plan_x, jnp.asarray(f)))
    up = np.asarray(ewald.real_matvec_pallas(plan_p, jnp.asarray(f),
                                             interpret=True))
    scale = np.abs(ux).max()
    np.testing.assert_allclose(up / scale, ux / scale, atol=5e-6)


def test_matvec_sharded_matches_single_device():
    """matvec_sharded (cell-sharded near field + plane-sharded wave with
    distributed FFT) reproduces the single-device product on an 8-device
    virtual mesh."""
    from rigidmultiblobswall_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(5)
    n = 120
    pos = rng.uniform(0.0, BOX[0], size=(n, 3))
    f = rng.normal(size=(n, 3))
    p = ewald.default_params(A, ETA, BOX, tol=1e-4, grid_max=64)
    assert p.grid[0] % 8 == 0 and p.grid[1] % 8 == 0  # sharded-wave path
    plan = ewald.make_plan(p, jnp.asarray(pos))
    u1 = np.asarray(ewald.matvec(plan, jnp.asarray(f)))
    mesh = make_mesh(8)
    u8 = np.asarray(ewald.matvec(plan, jnp.asarray(f), mesh=mesh))
    scale = np.abs(u1).max()
    np.testing.assert_allclose(u8 / scale, u1 / scale, atol=5e-6)


def test_auto_cell_capacity_matches_fixed():
    """cell_capacity=0 resolves a drop-free capacity at uniform density
    and reproduces the fixed-capacity near-field product."""
    import dataclasses

    rng = np.random.default_rng(7)
    n = 400
    pos = rng.uniform(0.0, BOX[0], size=(n, 3))
    f = rng.normal(size=(n, 3))
    p48 = ewald.default_params(A, ETA, BOX, tol=1e-4)
    p_auto = dataclasses.replace(p48, cell_capacity=0)
    plan48 = ewald.make_plan(p48, jnp.asarray(pos))
    plan_a = ewald.make_plan(p_auto, jnp.asarray(pos))
    assert plan_a.params.cell_capacity > 0  # resolved into the plan
    assert int(plan_a.n_dropped_cells) == 0
    u48 = np.asarray(ewald.real_matvec(plan48, jnp.asarray(f)))
    ua = np.asarray(ewald.real_matvec(plan_a, jnp.asarray(f)))
    scale = np.abs(u48).max()
    np.testing.assert_allclose(ua / scale, u48 / scale, atol=1e-12)


def test_split_parts_are_psd():
    """Both Hasimoto split parts must be SPD — the property that makes
    closed-form wave sampling + near-only Lanczos (PSE-style) valid."""
    rng = np.random.default_rng(11)
    n = 14
    pos = rng.uniform(0.0, BOX[0], size=(n, 3))
    p = ewald.default_params(A, ETA, BOX, tol=1e-4)
    plan = ewald.make_plan(p, jnp.asarray(pos))
    eye = np.eye(3 * n)
    mw = np.stack([np.asarray(ewald.wave_matvec(
        plan, jnp.asarray(e.reshape(n, 3)))).ravel() for e in eye], axis=1)
    mr = np.stack([np.asarray(ewald.real_matvec(
        plan, jnp.asarray(e.reshape(n, 3)))).ravel() for e in eye], axis=1)
    scale = np.linalg.norm(mw + mr, 2)
    assert np.linalg.eigvalsh(0.5 * (mw + mw.T)).min() > -1e-9 * scale
    assert np.linalg.eigvalsh(0.5 * (mr + mr.T)).min() > -1e-9 * scale


def test_wave_sqrt_noise_covariance():
    """Empirical covariance of the closed-form wave sampler converges to
    the dense wave operator (exact identity, statistical check)."""
    rng = np.random.default_rng(12)
    n = 8
    pos = rng.uniform(0.0, BOX[0], size=(n, 3))
    p = ewald.default_params(A, ETA, BOX, tol=1e-3)
    plan = ewald.make_plan(p, jnp.asarray(pos))
    eye = np.eye(3 * n)
    mw = np.stack([np.asarray(ewald.wave_matvec(
        plan, jnp.asarray(e.reshape(n, 3)))).ravel() for e in eye], axis=1)
    mw = 0.5 * (mw + mw.T)

    n_samp = 3000
    sampler = jax.jit(lambda k: ewald.wave_sqrt_noise(plan, k).ravel())
    keys = jax.random.split(jax.random.PRNGKey(3), n_samp)
    samples = np.asarray(jax.lax.map(sampler, keys, batch_size=50))
    emp = samples.T @ samples / n_samp
    err = np.linalg.norm(emp - mw) / np.linalg.norm(mw)
    # Frobenius error of a (24,24) Wishart estimate at K=3000: ~5%
    assert err < 0.12, err


def test_matvec_multi_matches_stacked_singles():
    """The multi-RHS engine sweep (shared windows + shared near-field
    Chebyshev scalars) is EXACTLY the stack of single products."""
    rng = np.random.default_rng(7)
    n = 80
    pos = rng.uniform(0.0, BOX[0], size=(n, 3))
    p = ewald.default_params(A, ETA, BOX, tol=1e-5)
    plan = ewald.make_plan(p, jnp.asarray(pos))
    F = jnp.asarray(rng.normal(size=(3, n, 3)))
    single = jnp.stack([ewald.matvec(plan, F[b]) for b in range(3)])
    multi = ewald.matvec_multi(plan, F)
    err = float(jnp.max(jnp.abs(single - multi))
                / jnp.max(jnp.abs(single)))
    assert err < 1e-12, err


@pytest.mark.parametrize("near_impl", ["xla", "pallas"])
def test_update_plan_refresh_small_drift(near_impl):
    """update_plan under the drift budget: the near field stays EXACT
    (old stencil still covers every r_cut pair; distances use the new
    positions) and the wave side keeps tol-level accuracy (stale
    plane/slab assignments only truncate the ~tol window tail)."""
    rng = np.random.default_rng(21)
    n = 120
    pos = rng.uniform(0.0, BOX[0], size=(n, 3))
    p = ewald.default_params(A, ETA, BOX, tol=1e-4, near_impl=near_impl)
    plan = ewald.make_plan(p, jnp.asarray(pos))
    h = min(p.spacing)
    drift = rng.uniform(-0.25 * h, 0.25 * h, size=(n, 3))
    pos2 = pos + drift
    F = jnp.asarray(rng.normal(size=(n, 3)))

    up = ewald.update_plan(plan, jnp.asarray(pos2))
    fresh = ewald.make_plan(p, jnp.asarray(pos2))
    # the refresh branch was taken: cell membership is inherited
    assert bool(jnp.array_equal(up.cell_table, plan.cell_table))

    def near(pl_):
        if near_impl == "pallas":
            assert pl_.src_pos is not None
            return ewald.real_matvec_pallas(pl_, F, interpret=True)
        return ewald.real_matvec(pl_, F)

    y_up = near(up) + ewald.wave_matvec(up, F)
    y_new = near(fresh) + ewald.wave_matvec(fresh, F)
    rel = float(jnp.max(jnp.abs(y_up - y_new)) / jnp.max(jnp.abs(y_new)))
    assert rel < 30 * p.tol, rel
    # near field alone is exact (same pairs, true new distances)
    rn = float(jnp.max(jnp.abs(near(up) - near(fresh)))
               / jnp.max(jnp.abs(y_new)))
    assert rn < 1e-6, rn


def test_update_plan_rebuild_fallback_large_drift():
    """Past the drift budget update_plan falls back to a FULL rebuild:
    the result must agree with make_plan at the new positions (same
    params -> same layout) to rounding."""
    rng = np.random.default_rng(22)
    n = 60
    pos = rng.uniform(0.0, BOX[0], size=(n, 3))
    p = ewald.default_params(A, ETA, BOX, tol=1e-4)
    plan = ewald.make_plan(p, jnp.asarray(pos))
    pos2 = rng.uniform(0.0, BOX[0], size=(n, 3))   # completely new config
    F = jnp.asarray(rng.normal(size=(n, 3)))
    up = ewald.update_plan(plan, jnp.asarray(pos2))
    fresh = ewald.make_plan(p, jnp.asarray(pos2))
    y_up = np.asarray(ewald.matvec(up, F))
    y_new = np.asarray(ewald.matvec(fresh, F))
    np.testing.assert_allclose(y_up, y_new, rtol=0, atol=1e-12 * np.max(
        np.abs(y_new)))


def test_update_plan_cumulative_drift_triggers_rebuild():
    """Chained refreshes (the cross-step plan carry) measure drift against
    the SORT-time positions, not the previous refresh: many small steps
    that each fit the per-step budget must still trigger the full rebuild
    once the accumulated drift exceeds it, keeping the near field exact
    for the whole run."""
    rng = np.random.default_rng(23)
    n = 120
    pos = rng.uniform(0.0, BOX[0], size=(n, 3))
    p = ewald.default_params(A, ETA, BOX, tol=1e-4)
    plan = ewald.make_plan(p, jnp.asarray(pos))
    side = np.asarray(BOX) / np.asarray(plan.cell_dims)
    budget = 0.5 * np.minimum(side - p.r_cut, np.asarray(p.spacing))
    # coherent per-step drift at ~0.4x the budget: step 3 pushes the
    # cumulative displacement past it
    step = 0.4 * budget.min() * np.ones(3) / np.sqrt(3.0)
    F = jnp.asarray(rng.normal(size=(n, 3)))
    cur = pos.copy()
    for k in range(6):
        cur = cur + step
        plan = ewald.update_plan(plan, jnp.asarray(cur))
        fresh = ewald.make_plan(p, jnp.asarray(cur))
        rn = float(jnp.max(jnp.abs(ewald.real_matvec(plan, F)
                                   - ewald.real_matvec(fresh, F)))
                   / jnp.max(jnp.abs(ewald.matvec(fresh, F))))
        assert rn < 1e-6, (k, rn)
    # the rebuild actually fired at least once: the sort anchor moved
    assert not bool(jnp.allclose(plan.sort_pos, jnp.asarray(
        pos - np.floor(pos / np.asarray(BOX)) * np.asarray(BOX))))


def test_matvec_multi_sharded_matches_singles():
    """Multi-RHS over the mesh: one distributed sweep (shared gridding and
    near-field work across b-major channels) equals the stacked
    single-RHS sharded products."""
    from rigidmultiblobswall_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(6)
    n = 96
    pos = rng.uniform(0.0, BOX[0], size=(n, 3))
    F = jnp.asarray(rng.normal(size=(2, n, 3)))
    p = ewald.default_params(A, ETA, BOX, tol=1e-4, grid_max=64)
    plan = ewald.make_plan(p, jnp.asarray(pos))
    mesh = make_mesh(8)
    singles = jnp.stack([
        ewald.matvec_sharded(mesh, plan, F[b]) for b in range(2)])
    multi = ewald.matvec_multi(plan, F, mesh=mesh)
    scale = float(jnp.max(jnp.abs(singles)))
    np.testing.assert_allclose(np.asarray(multi) / scale,
                               np.asarray(singles) / scale, atol=1e-10)
