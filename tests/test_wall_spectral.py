"""Spectral single-wall engine (ops/ewald_wall) correctness.

Oracle = Richardson-extrapolated direct image-box lattice sum of the
RPY + Swan-Brady pair blocks (the combined real+image kernel decays
like 1/rho^3 in-plane, so the xy lattice sum converges absolutely).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rigidmultiblobswall_tpu.ops import ewald_wall as ew
from rigidmultiblobswall_tpu.ops import mobility as mob
from rigidmultiblobswall_tpu.ops import rpy, wall_kernels
from rigidmultiblobswall_tpu.ops import _wall_channels_gen as gen

A, ETA = 0.25, 0.9
LBOX = 26 * A


def _config(n, seed=0, z_lo=1.2, z_hi=3.0):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, LBOX, n), rng.uniform(0, LBOX, n),
                    rng.uniform(z_lo * A, z_hi * A, n)], axis=1)
    f = rng.normal(size=(n, 3))
    return pos, f


@pytest.fixture(scope="module")
def plan6():
    pos, f = _config(6)
    params = ew.default_wall_params(A, ETA, (LBOX, LBOX), z_hi=3.5 * A,
                                    tol=1e-4)
    return ew.make_wall_plan(params, jnp.asarray(pos)), pos, f


@pytest.fixture(scope="module")
def oracle6():
    pos, f = _config(6)
    u1 = ew.brute_force_wall(pos, f, A, ETA, (LBOX, LBOX), n_img=40)
    u2 = ew.brute_force_wall(pos, f, A, ETA, (LBOX, LBOX), n_img=80)
    return 2 * u2 - u1


def test_img_channels_match_pair_formula():
    """Generated channel apply with EXACT radial generators reproduces
    the Swan-Brady pair correction (ops/rpy.py::wall_tt_radii) minus the
    merged image-Stokeslet part."""
    rng = np.random.default_rng(1)
    n = 16
    h = rng.uniform(1.05 * A, 3 * A, n)
    x3 = rng.uniform(1.05 * A, 3 * A, n)
    dx = rng.uniform(-2, 2, n)
    dy = rng.uniform(-2, 2, n)
    rz = x3 + h
    f = rng.normal(size=(n, 3))
    W = np.asarray(rpy.wall_tt_radii(
        jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(rz),
        jnp.asarray(x3), jnp.asarray(h), A, A))
    r2 = dx * dx + dy * dy + rz * rz
    r = np.sqrt(r2)
    s2 = 2 * A * A
    c1 = (1 + s2 / (3 * r2)) / r
    c2 = (1 - s2 / r2) / (r2 * r)
    R = np.stack([dx, dy, rz], 1)
    S = (c1[:, None, None] * np.eye(3)
         + c2[:, None, None] * np.einsum("ni,nj->nij", R, R))
    target = np.einsum("nij,nj->ni", W + S @ np.diag([1.0, 1.0, -1.0]), f)
    cvals = wall_kernels.img_exact_values_np(r / A)
    # scaled inputs (A2 = 1), result scales back by 1/a
    ux, uy, uz = gen.img_terms(dx / A, dy / A, rz / A, h / A,
                               f[:, 0], f[:, 1], f[:, 2], 1.0, *cvals)
    got = np.stack([ux, uy, uz], 1) / A
    assert np.abs(got - target).max() < 1e-12 * max(np.abs(target).max(), 1)


def test_matvec_matches_converged_lattice_sum(plan6, oracle6):
    plan, pos, f = plan6
    u = np.asarray(ew.matvec(plan, jnp.asarray(f)))
    scale = np.abs(oracle6).max()
    assert np.abs(u - oracle6).max() / scale < 1e-5


def test_tol_controls_error(oracle6):
    pos, f = _config(6)
    scale = np.abs(oracle6).max()
    params = ew.default_wall_params(A, ETA, (LBOX, LBOX), z_hi=3.5 * A,
                                    tol=1e-3)
    plan = ew.make_wall_plan(params, jnp.asarray(pos))
    u = np.asarray(ew.matvec(plan, jnp.asarray(f)))
    err_loose = np.abs(u - oracle6).max() / scale
    assert err_loose < 1e-3          # loose params stay inside their tol
    assert err_loose > 3e-6          # and are genuinely less accurate


def test_matvec_symmetry(plan6):
    """The wall mobility is symmetric: <u, M v> = <M u, v>."""
    plan, pos, f = plan6
    rng = np.random.default_rng(3)
    v = rng.normal(size=f.shape)
    Mu = np.asarray(ew.matvec(plan, jnp.asarray(f)))
    Mv = np.asarray(ew.matvec(plan, jnp.asarray(v)))
    left = np.sum(f * Mv)
    right = np.sum(Mu * v)
    # the two-piece Chebyshev-fitted near-field/image tables carry an
    # O(fit tol) asymmetry (measured ~4e-8 at tol=1e-4); the bound
    # tracks the engine tolerance rather than demanding exactness the
    # fitted tables never promised
    assert abs(left - right) < 1e-3 * plan.params.tol * max(abs(left), 1.0)


def test_matvec_multi_matches_single(plan6):
    plan, pos, f = plan6
    rng = np.random.default_rng(4)
    F = jnp.asarray(rng.normal(size=(3, len(pos), 3)))
    multi = np.asarray(ew.matvec_multi(plan, F))
    for b in range(3):
        single = np.asarray(ew.matvec(plan, F[b]))
        assert np.abs(multi[b] - single).max() < 1e-10


def test_dense_wall_mobility_spd(plan6):
    """Materialize M column by column; the wall mobility must be SPD
    (positive split + physics) to ~engine tolerance."""
    plan, pos, f = plan6
    n = len(pos)
    cols = []
    for j in range(3 * n):
        e = np.zeros((n, 3))
        e.flat[j] = 1.0
        cols.append(np.asarray(ew.matvec(plan, jnp.asarray(e))).ravel())
    M = np.stack(cols, axis=1)
    M = 0.5 * (M + M.T)
    evals = np.linalg.eigvalsh(M)
    assert evals.min() > -1e-6 * evals.max()


def test_overlap_regularization_matches_direct():
    """Blobs below z = a: the engine must reproduce the reference's
    B^T M(z_eff) B damping (mobility/mobility.py:52-119), here checked
    against the damped converged lattice sum."""
    pos, f = _config(5, seed=7, z_lo=0.3, z_hi=2.5)  # some below a
    params = ew.default_wall_params(A, ETA, (LBOX, LBOX), z_hi=3.0 * A,
                                    tol=1e-4)
    plan = ew.make_wall_plan(params, jnp.asarray(pos))
    u = np.asarray(ew.matvec(plan, jnp.asarray(f)))
    damp = np.minimum(pos[:, 2] / A, 1.0)
    pos_eff = pos.copy()
    pos_eff[:, 2] = np.maximum(pos_eff[:, 2], A)
    u1 = ew.brute_force_wall(pos_eff, damp[:, None] * f, A, ETA,
                             (LBOX, LBOX), n_img=40)
    u2 = ew.brute_force_wall(pos_eff, damp[:, None] * f, A, ETA,
                             (LBOX, LBOX), n_img=80)
    ub = damp[:, None] * (2 * u2 - u1)
    # bound = the engine's own tol contract (measured ~3e-5 at tol 1e-4:
    # wall-touching z_eff = a sits at the edge of the fitted image-table
    # domain, the least accurate corner the tol ladder still covers)
    assert np.abs(u - ub).max() / np.abs(ub).max() < params.tol


def test_couette_mean_flow():
    """k_par = 0 physics: a sheet of uniform parallel forces above the
    wall drives u_x(z) ~ (1/(eta A)) sum_j min(z, z_j) f_x (the image
    system's Couette profile), and net perpendicular flow vanishes."""
    rng = np.random.default_rng(11)
    n = 24
    pos = np.stack([rng.uniform(0, LBOX, n), rng.uniform(0, LBOX, n),
                    np.full(n, 1.6 * A)], axis=1)
    # one probe high above the sheet: it sees almost pure mean flow
    probe_z = 3.2 * A
    pos[0, 2] = probe_z
    f = np.zeros((n, 3))
    f[1:, 0] = 1.0
    params = ew.default_wall_params(A, ETA, (LBOX, LBOX), z_hi=3.5 * A,
                                    tol=1e-4)
    plan = ew.make_wall_plan(params, jnp.asarray(pos))
    u = np.asarray(ew.matvec(plan, jnp.asarray(f)))
    u1 = ew.brute_force_wall(pos, f, A, ETA, (LBOX, LBOX), n_img=40)
    u2 = ew.brute_force_wall(pos, f, A, ETA, (LBOX, LBOX), n_img=80)
    ub = 2 * u2 - u1
    assert np.abs(u - ub).max() / np.abs(ub).max() < 5e-5
    # Couette estimate for the probe (finite-N near-field corrections
    # are ~(a/L): compare at 15%)
    couette = np.sum(np.minimum(probe_z, pos[1:, 2])) / (ETA * LBOX * LBOX)
    assert abs(u[0, 0] - couette) / couette < 0.15
    # perpendicular response is near-field finite-N physics only (the
    # k_par=0 mean flow through planes vanishes); it stays small but not
    # zero for a discrete sheet
    assert abs(u[0, 2]) < 2e-2 * abs(u[0, 0])


def _converged_dense_planes(r_blobs, n_img=40):
    """Dense (3,3,N,N) wall mobility planes from the Richardson-
    extrapolated lattice sum (the m_dense layout of
    solvers.solve_mobility_problem)."""
    from rigidmultiblobswall_tpu.ops import rpy as _rpy

    r = np.asarray(r_blobs, np.float64)
    n = len(r)

    def dense(ni):
        sh = np.asarray([(ix * LBOX, iy * LBOX, 0.0)
                         for ix in range(-ni, ni + 1)
                         for iy in range(-ni, ni + 1)])
        src = r[None, :, :] + sh[:, None, :]          # (S, n, 3)
        d = (r[:, None, None, :] - src[None]) / A     # (n, S, n, 3)
        home = np.all(sh == 0, axis=1)
        sm = np.zeros(d.shape[:-1], bool)
        sm[:, home] = np.eye(n, dtype=bool)[:, None, :]
        m = np.asarray(_rpy.rpy_tt(jnp.asarray(d), jnp.asarray(sm)))
        w = np.asarray(_rpy.wall_tt(
            jnp.asarray(d[..., 0]), jnp.asarray(d[..., 1]),
            jnp.asarray((r[:, None, None, 2] + src[None, ..., 2]) / A),
            jnp.asarray(src[None, ..., 2] / A * np.ones((n, 1, 1))),
            jnp.asarray(sm)))
        return (m + w).sum(axis=1) / (8 * np.pi * ETA * A)  # (n,n,3,3)

    M = 2 * dense(2 * n_img) - dense(n_img)
    return jnp.asarray(np.transpose(M, (2, 3, 0, 1)))    # (3,3,N,N)


def test_solver_integration_matches_converged_dense():
    """domain='single_wall_spectral' through the full saddle solve
    matches a CONVERGED dense lattice-sum mobility at kT=0. (The direct
    single_wall engine with periodic_length truncates at +-1 image
    boxes — reference behavior — which for net-forced sedimentation
    misses most of the collective backflow, so the converged dense sum
    is the correct oracle here.)"""
    from rigidmultiblobswall_tpu.models import kinematics as kin
    from rigidmultiblobswall_tpu.models import solvers
    from rigidmultiblobswall_tpu.models.system import (BodyType, System,
                                                       make_state)

    rng = np.random.default_rng(5)
    shell = rng.normal(size=(8, 3))
    shell *= 0.5 * A / np.linalg.norm(shell, axis=1, keepdims=True)
    t = BodyType(name="s8", ref_config=shell, count=4)
    common = dict(types=(t,), eta=ETA, blob_radius=A, kT=0.0, g=0.5,
                  solver_tolerance=1e-9)
    pos = np.stack([rng.uniform(4 * A, LBOX - 4 * A, 4),
                    rng.uniform(4 * A, LBOX - 4 * A, 4),
                    rng.uniform(1.6 * A, 2.6 * A, 4)], axis=1)
    quat = rng.normal(size=(4, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    state = make_state(pos, quat)

    sys_dir = System(domain="single_wall",
                     periodic_length=(LBOX, LBOX, 0.0), **common)
    sys_spec = System(domain="single_wall_spectral",
                      periodic_length=(LBOX, LBOX, 0.0),
                      spectral_wall_height=4.0 * A, spectral_tol=1e-5,
                      **common)
    r_blobs = kin.blob_positions(sys_dir, state)
    planes = _converged_dense_planes(r_blobs, n_img=20)
    sol_ref = solvers.solve_mobility_problem(sys_dir, state,
                                             m_dense=planes)
    sol_spec = solvers.solve_mobility_problem(sys_spec, state)
    v_ref = np.asarray(sol_ref.velocities)
    v_spec = np.asarray(sol_spec.velocities)
    scale = np.abs(v_ref).max()
    # measured 5.2e-7 vs the n_img=20 oracle (whose own Richardson
    # drift to n_img=40 is 2.6e-7) at spectral_tol 1e-5 — the engine
    # converges an order below its tol ladder here; 1e-5 keeps ~20x
    # margin (VERDICT r4 ask #9: tightened from the stale 5e-3)
    assert np.abs(v_ref - v_spec).max() / scale < 1e-5


def test_brownian_step_runs():
    """A Slip-Trapz Brownian step on the wall-spectral domain stays
    finite, rejects nothing at small dt, and reports solver work."""
    from rigidmultiblobswall_tpu.models import integrators
    from rigidmultiblobswall_tpu.models import saddle
    from rigidmultiblobswall_tpu.models.system import (BodyType, System,
                                                       make_state)

    rng = np.random.default_rng(6)
    shell = rng.normal(size=(6, 3))
    shell *= 0.5 * A / np.linalg.norm(shell, axis=1, keepdims=True)
    t = BodyType(name="s6", ref_config=shell, count=4)
    system = System(types=(t,), eta=ETA, blob_radius=A, kT=0.05, g=0.3,
                    domain="single_wall_spectral",
                    periodic_length=(LBOX, LBOX, 0.0),
                    spectral_wall_height=5.0 * A, spectral_tol=1e-4,
                    repulsion_strength_wall=0.2, debye_length_wall=0.3,
                    solver_tolerance=1e-6)
    pos = np.stack([rng.uniform(2 * A, LBOX - 2 * A, 4),
                    rng.uniform(2 * A, LBOX - 2 * A, 4),
                    rng.uniform(1.8 * A, 3.0 * A, 4)], axis=1)
    state = make_state(pos, np.tile([1.0, 0, 0, 0], (4, 1)))
    final, traj, aux = integrators.simulate(
        system, state, jax.random.PRNGKey(0),
        scheme="stochastic_Slip_Trapz", dt=2e-4, n_steps=3, save_every=1)
    assert np.all(np.isfinite(np.asarray(final.pos)))
    assert np.asarray(final.pos)[:, 2].min() > 0
    assert int(np.asarray(aux.det_iterations)[-1]) > 0


def test_update_wall_plan_matches_rebuild():
    """update_wall_plan (position re-gathers, no re-sorting) reproduces
    a freshly built plan's matvec within the drift budget, and falls
    back to a full rebuild beyond it."""
    pos, f = _config(6)
    params = ew.default_wall_params(A, ETA, (LBOX, LBOX), z_hi=3.5 * A,
                                    tol=1e-4)
    plan = ew.make_wall_plan(params, jnp.asarray(pos))
    rng = np.random.default_rng(9)
    # small drift: refresh path
    pos2 = pos + 0.02 * A * rng.normal(size=pos.shape)
    plan_r = ew.update_wall_plan(plan, jnp.asarray(pos2))
    plan_f = ew.make_wall_plan(params, jnp.asarray(pos2))
    u_r = np.asarray(ew.matvec(plan_r, jnp.asarray(f)))
    u_f = np.asarray(ew.matvec(plan_f, jnp.asarray(f)))
    assert np.abs(u_r - u_f).max() < 1e-10 * max(np.abs(u_f).max(), 1)
    # large drift: rebuild fallback must stay exact too
    pos3 = pos + 2.5 * A * rng.normal(size=pos.shape)
    plan_r3 = ew.update_wall_plan(plan, jnp.asarray(pos3))
    plan_f3 = ew.make_wall_plan(params, jnp.asarray(pos3))
    u_r3 = np.asarray(ew.matvec(plan_r3, jnp.asarray(f)))
    u_f3 = np.asarray(ew.matvec(plan_f3, jnp.asarray(f)))
    assert np.abs(u_r3 - u_f3).max() < 1e-10 * max(np.abs(u_f3).max(), 1)


def test_wave_noise_split_covariance():
    """PSE-split exactness for the wall engine (VERDICT r3 #2): the
    closed-form wave sampler's covariance MINUS the per-mode defect
    equals the engine's wave operator (so sample + Lanczos-on-
    (near - defect) has covariance exactly M = near + wave), and the
    Lanczos operator near - Delta stays SPD. Mirrors
    test_ewald.py::test_wave_sqrt_noise_covariance; reference noise
    semantics stochastic_forcing.py:112-264."""
    import jax

    rng = np.random.default_rng(0)
    n = 6
    pos = np.stack([rng.uniform(0, LBOX, n), rng.uniform(0, LBOX, n),
                    rng.uniform(0.3, 2.2, n)], 1)
    params = ew.default_wall_params(A, ETA, (LBOX, LBOX), z_hi=2.5,
                                    tol=1e-3)
    plan = ew.make_wall_plan(params, jnp.asarray(pos))
    t = ew._host_noise_tables(params)
    fac = ew._noise_factors_device(params, jnp.float64)

    # sampled covariance = Gram of the sampler's linear chain
    # (fwd o fwd^T via vjp — the sampler feeds white REAL noise)
    def fwd(w):
        return ew._wave_noise_apply(plan, w, fac[0], fac[1])

    w0 = jnp.zeros((3 * t["p"], params.grid[0], params.grid[1]))
    _, vjp_fn = jax.vjp(fwd, w0)
    TT = jax.jit(lambda e: fwd(vjp_fn(e)[0]))
    dm = jax.jit(lambda e: ew.wave_defect_matvec(plan, e, factors=fac))
    wv = jax.jit(lambda f: ew.wave_matvec(plan, f))
    nv = jax.jit(lambda f: ew.near_matvec_xla(plan, f))
    Cov = np.zeros((3 * n, 3 * n))
    Dlt = np.zeros((3 * n, 3 * n))
    Mw = np.zeros((3 * n, 3 * n))
    Mn = np.zeros((3 * n, 3 * n))
    for j in range(3 * n):
        e = np.zeros((n, 3))
        e.flat[j] = 1.0
        ej = jnp.asarray(e)
        Cov[:, j] = np.asarray(TT(ej)).ravel()
        Dlt[:, j] = np.asarray(dm(ej)).ravel()
        Mw[:, j] = np.asarray(wv(ej)).ravel()
        Mn[:, j] = np.asarray(nv(ej)).ravel()
    Mw = 0.5 * (Mw + Mw.T)
    scale = np.abs(Mw).max()
    assert np.abs(Cov - Dlt - Mw).max() / scale < 5.0 * params.tol
    # the sampler is PSD by construction; the Lanczos operator must be
    # SPD with real margin for the near-field sqrt to exist
    H = 0.5 * ((Mn - Dlt) + (Mn - Dlt).T)
    ev = np.linalg.eigvalsh(H)
    ev_n = np.linalg.eigvalsh(0.5 * (Mn + Mn.T))
    assert ev.min() > 0.5 * ev_n.min() > 0
