"""Wall-spectral GRAND mobility (rot-coupling engine stage).

Parity of ops/ewald_wall_rot.grand_matvec against a Richardson-
extrapolated xy-lattice sum of the direct Swan-Brady grand blocks
(ops/rpy.py — themselves the reference math of mobility_numba.py:
646-679, 1040-1066, 1292-1321) — the same oracle construction the tt
engine's solve-level parity test uses (test_wall_spectral.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rigidmultiblobswall_tpu.ops import ewald_wall as ew
from rigidmultiblobswall_tpu.ops import ewald_wall_rot as ewr
from rigidmultiblobswall_tpu.ops import rpy

A = 0.3
ETA = 1.2
LBOX = 9.0


def _config(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, LBOX, n), rng.uniform(0, LBOX, n),
                    rng.uniform(1.4 * A, 3.2 * A, n)], axis=1)
    f = rng.normal(size=(n, 3))
    t = rng.normal(size=(n, 3))
    return pos, f, t


def _grand_oracle(r, f, t, n_img):
    """(u, w) from the truncated xy-lattice sum over (2 n_img + 1)^2
    image boxes of the scaled rpy + Swan-Brady blocks."""
    n = len(r)
    sh = np.asarray([(ix * LBOX, iy * LBOX, 0.0)
                     for ix in range(-n_img, n_img + 1)
                     for iy in range(-n_img, n_img + 1)])
    src = r[None, :, :] + sh[:, None, :]                 # (S, n, 3)
    d = (r[:, None, None, :] - src[None]) / A            # (n, S, n, 3)
    home = np.all(sh == 0, axis=1)
    sm = np.zeros(d.shape[:-1], bool)
    sm[:, home] = np.eye(n, dtype=bool)[:, None, :]
    sm_j = jnp.asarray(sm)
    d_j = jnp.asarray(d)
    dx, dy = d_j[..., 0], d_j[..., 1]
    rz = jnp.asarray((r[:, None, None, 2] + src[None, ..., 2]) / A)
    hs = jnp.asarray(src[None, ..., 2] / A * np.ones((n, 1, 1)))
    ht = jnp.asarray(r[:, None, None, 2] / A * np.ones((1, 1, n)))

    tt = rpy.rpy_tt(d_j, sm_j) + rpy.wall_tt(dx, dy, rz, hs, sm_j)
    cr = rpy.rpy_cross(d_j, sm_j)
    rt = cr + rpy.wall_rot_force(dx, dy, rz, hs, sm_j)
    tr = cr + rpy.wall_trans_torque(dx, dy, rz, ht, sm_j)
    rr = rpy.rpy_rr(d_j, sm_j) + rpy.wall_rr(dx, dy, rz, hs, sm_j)

    pref = 1.0 / (8 * np.pi * ETA * A)
    fj = jnp.asarray(f)
    tj = jnp.asarray(t)
    u = (jnp.einsum("nsmij,mj->ni", tt, fj) * pref
         + jnp.einsum("nsmij,mj->ni", tr, tj) * (pref / A))
    w = (jnp.einsum("nsmij,mj->ni", rt, fj) * (pref / A)
         + jnp.einsum("nsmij,mj->ni", rr, tj) * (pref / A / A))
    return np.asarray(u), np.asarray(w)


def _richardson(r, f, t, n_img=12):
    u1, w1 = _grand_oracle(r, f, t, n_img)
    u2, w2 = _grand_oracle(r, f, t, 2 * n_img)
    return 2 * u2 - u1, 2 * w2 - w1


@pytest.fixture(scope="module")
def setup():
    pos, f, t = _config(20, seed=3)
    params = ew.default_wall_params(A, ETA, (LBOX, LBOX), z_hi=3.4 * A,
                                    tol=1e-5)
    plan = ew.make_wall_plan(params, jnp.asarray(pos))
    tables = ewr.rot_tables_device(params, jnp.float64)
    u_ref, w_ref = _richardson(pos, f, t)
    return pos, f, t, params, plan, tables, u_ref, w_ref


def test_grand_matvec_matches_converged_oracle(setup):
    pos, f, t, params, plan, tables, u_ref, w_ref = setup
    v, w = ewr.grand_matvec(plan, jnp.asarray(f), jnp.asarray(t), tables)
    su = np.abs(u_ref).max()
    sw = np.abs(w_ref).max()
    err_u = np.abs(np.asarray(v) - u_ref).max() / su
    err_w = np.abs(np.asarray(w) - w_ref).max() / sw
    # measured per-block: tt 3.1e-5, rt 3.2e-5, tr 3.7e-5, rr 4.8e-6
    # (engine tol 1e-5 + Richardson truncation); 1e-4 keeps ~3x margin
    assert err_u < 1e-4, err_u
    assert err_w < 1e-4, err_w


def test_grand_matvec_single_block_products(setup):
    """f-only and t-only calls give the same blocks as the full call
    (the rollers path issues rt-only / rr-only products)."""
    pos, f, t, params, plan, tables, u_ref, w_ref = setup
    vf, wf = ewr.grand_matvec(plan, jnp.asarray(f), None, tables)
    vt, wt = ewr.grand_matvec(plan, None, jnp.asarray(t), tables)
    v, w = ewr.grand_matvec(plan, jnp.asarray(f), jnp.asarray(t), tables)
    assert np.allclose(np.asarray(vf) + np.asarray(vt), np.asarray(v),
                       atol=1e-11)
    assert np.allclose(np.asarray(wf) + np.asarray(wt), np.asarray(w),
                       atol=1e-11)


def test_grand_symmetry(setup):
    """<(f1,t1), M (f2,t2)> symmetry of the assembled grand product."""
    pos, f, t, params, plan, tables, u_ref, w_ref = setup
    rng = np.random.default_rng(9)
    f2 = rng.normal(size=f.shape)
    t2 = rng.normal(size=t.shape)
    v1, w1 = ewr.grand_matvec(plan, jnp.asarray(f), jnp.asarray(t), tables)
    v2, w2 = ewr.grand_matvec(plan, jnp.asarray(f2), jnp.asarray(t2),
                              tables)
    lhs = float(np.sum(np.asarray(v1) * f2) + np.sum(np.asarray(w1) * t2))
    rhs = float(np.sum(np.asarray(v2) * f) + np.sum(np.asarray(w2) * t))
    assert abs(lhs - rhs) < 2e-6 * max(abs(lhs), abs(rhs))


def test_rollers_spectral_dispatch_step_parity():
    """One stochastic AB rollers step (constrained omega: lockstep M_rr
    solves + grand Lanczos + RFD) on domain='single_wall_spectral'
    matches the direct O(N^2) engine from identical inputs. Small dense
    box so the direct engine's +-1-image periodic truncation is
    compensated by using NO periodic images in the direct twin and a
    box large enough that spectral wrap is below tol... instead: the
    two engines differ by the periodic far field, so compare on a box
    where the rollers' kernels have decayed: torque-driven fields decay
    like 1/r^2 and faster, gravity forces are compensated by the wall
    (net backflow excluded by comparing VELOCITY DIFFERENCES about the
    mean — the k_par = 0 collective mode is the only conditionally
    convergent piece)."""
    from rigidmultiblobswall_tpu.models import rollers

    n = 16
    rng = np.random.default_rng(11)
    L = 14.0
    r0 = np.stack([rng.uniform(0, L, n), rng.uniform(0, L, n),
                   rng.uniform(0.55, 1.2, n)], axis=1)

    common = dict(num_rollers=n, eta=0.9, blob_radius=0.5, kT=2e-3,
                  g=0.05, repulsion_strength=0.1, debye_length=0.2,
                  repulsion_strength_wall=0.1, debye_length_wall=0.2,
                  solver_tolerance=1e-9, free_kinematics=False,
                  omega_one_roller=(0.0, 4.0, 0.0), lanczos_max_iter=40,
                  periodic_length=(L, L, 0.0))
    sus_sp = rollers.RollerSuspension(
        domain="single_wall_spectral", spectral_tol=1e-6,
        spectral_wall_height=1.4, **common)
    # direct twin WITH pseudo-periodic +-1 images (reference behavior);
    # at this box the difference vs the converged periodic sum is the
    # slowly-decaying tt far field only — tested against the mean-free
    # part of the velocities
    sus_dir = rollers.RollerSuspension(domain="single_wall", **common)

    # ---- product-level parity of the DISPATCHED engines against the
    # converged (Richardson) lattice oracle. Measured at this box:
    # spectral rt 2.7e-5 / rr 5.5e-6 vs oracle, while the DIRECT engine
    # (reference +-1-image truncation) sits at 5.6e-3 / 1.4e-3 — the
    # spectral dispatch is the more accurate of the two; parity against
    # the truncated direct engine is therefore bounded by the direct
    # engine's own truncation, not by this engine.
    import test_wall_rot_engine as TT
    old = (TT.A, TT.ETA, TT.LBOX)
    TT.A, TT.ETA, TT.LBOX = 0.5, 0.9, L
    try:
        force = np.asarray(rollers.roller_forces(sus_dir, jnp.asarray(r0)))
        z = np.zeros_like(force)
        _, w_F = TT._richardson(r0, force, z, n_img=10)
        eng_sp = rollers._engine(sus_sp, jnp.asarray(r0))
        w_sp = np.asarray(eng_sp.rt(jnp.asarray(force)))
        assert np.abs(w_sp - w_F).max() / np.abs(w_F).max() < 2e-4
        t_in = rng.normal(size=(n, 3))
        _, w_T = TT._richardson(r0, z, t_in, n_img=10)
        w_sp2 = np.asarray(eng_sp.rr(jnp.asarray(t_in)))
        assert np.abs(w_sp2 - w_T).max() / np.abs(w_T).max() < 1e-4
    finally:
        TT.A, TT.ETA, TT.LBOX = old

    # ---- full step consistency vs the direct twin (bounded by the
    # direct engine's image truncation at this box)
    key = jax.random.PRNGKey(7)
    v_sp, t_sp, vs_sp, it_sp, il_sp = rollers.det_stoch_velocity_lockstep(
        sus_sp, jnp.asarray(r0), key, 1e-3)
    v_d, t_d, vs_d, it_d, il_d = rollers.det_stoch_velocity_lockstep(
        sus_dir, jnp.asarray(r0), key, 1e-3)
    st = np.abs(np.asarray(t_d)).max()
    assert np.abs(np.asarray(t_sp) - np.asarray(t_d)).max() / st < 2e-2
    a = np.asarray(v_sp) - np.asarray(v_sp).mean(axis=0)
    b = np.asarray(v_d) - np.asarray(v_d).mean(axis=0)
    sv = np.abs(b).max()
    assert np.abs(a - b).max() / sv < 5e-2
