"""Minimally-resolved roller suspensions: one blob per body with grand
(trans-rot) mobility coupling.

Functional re-design of QuaternionIntegratorRollers
(/root/reference/quaternion_integrator/quaternion_integrator_rollers.py):
state is just blob positions (N,3); bodies spin either freely under a
prescribed torque (free_kinematics=True) or with a prescribed angular
velocity, in which case the torque solves M_rr T = omega - M_rt F by
unpreconditioned GMRES (:905-982).

With hydro_interactions off, the closed-form Swan-Brady self mobilities
with wall damping are used instead (:985-1079, :1263-1312).

Schemes: deterministic forward_euler / adams_bashforth, stochastic
first_order / adams_bashforth (recommended) / EM, with the wall-rejection
retry on body centers z < 0 (:136-150).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import forces as force_ops
from ..ops import mobility as mob
from ..ops.gmres import gmres
from ..ops.lanczos import stochastic_forcing_lanczos


@dataclasses.dataclass(frozen=True)
class RollerSuspension:
    """Static description of a roller suspension (N single-blob bodies).

    domain="single_wall_spectral" routes every grand-mobility product
    through the O(N log N) doubly-periodic wall engine
    (ops/ewald_wall_rot.grand_matvec) instead of the O(N^2) direct
    kernels — the reference's rollers hot loop
    (quaternion_integrator_rollers.py:905-982) with spectral products.
    Requires periodic_length x/y > 0 and spectral_wall_height > 0."""

    num_rollers: int
    eta: float = 1.0
    blob_radius: float = 1.0
    kT: float = 0.0
    g: float = 0.0
    domain: str = "single_wall"
    spectral_tol: float = 1e-4
    spectral_grid_max: int = 512
    spectral_wall_height: float = 0.0
    spectral_cell_capacity: int = 0
    spectral_bucket_capacity: int = 0
    periodic_length: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    repulsion_strength: float = 0.0
    debye_length: float = 1.0
    repulsion_strength_wall: float = 0.0
    debye_length_wall: float = 1.0
    solver_tolerance: float = 1e-8
    rf_delta: float = 1e-3
    free_kinematics: bool = True
    omega_one_roller: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    hydro_interactions: bool = True
    lanczos_max_iter: int = 64
    # hooks: prescribed torque (free kinematics) and extra blob forces
    torque_fn: Optional[Callable] = None
    force_fn: Optional[Callable] = None
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)

    @property
    def mobility_kwargs(self):
        kw = dict(domain=self.domain, periodic_length=self.periodic_length)
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        return kw


class RollerAux(NamedTuple):
    velocities: jax.Array
    torques: jax.Array
    det_iterations: jax.Array
    stoch_iterations: jax.Array
    rejections: jax.Array
    wall_overlaps: jax.Array


class RollerCarry(NamedTuple):
    velocities_prev: jax.Array
    first_step: jax.Array
    # wall-spectral engine state carried ACROSS steps (plan refreshed
    # per configuration) and its position-independent rot tables —
    # carried as pytree ARGUMENTS so the (10^1..10^2 MB) polish/near
    # tables never lower as HLO literal constants (as the integrators'
    # noise factors)
    plan: object = None
    rot_tables: object = None


def init_carry(sus: RollerSuspension, dtype=jnp.float64,
               positions=None) -> RollerCarry:
    plan = None
    tables = None
    if positions is not None and sus.domain == "single_wall_spectral":
        from ..ops import ewald_wall, ewald_wall_rot

        params = _roller_spectral_params(sus)
        plan = jax.jit(lambda r: ewald_wall.make_wall_plan(params, r))(
            jnp.asarray(positions, dtype))
        tables = ewald_wall_rot.rot_tables_device(params, dtype)
    return RollerCarry(
        velocities_prev=jnp.zeros((sus.num_rollers, 3), dtype=dtype),
        first_step=jnp.asarray(True), plan=plan, rot_tables=tables)


# ---------------------------------------------------------------------------
# Forces and closed-form Swan-Brady self mobilities
# ---------------------------------------------------------------------------


def roller_forces(sus: RollerSuspension, r):
    f = force_ops.blob_external_forces(
        r, g=sus.g, blob_mass=1.0, blob_radius=sus.blob_radius,
        repulsion_strength_wall=sus.repulsion_strength_wall,
        debye_length_wall=sus.debye_length_wall)
    f = f + force_ops.blob_blob_forces(
        r, repulsion_strength=sus.repulsion_strength,
        debye_length=sus.debye_length, blob_radius=sus.blob_radius,
        periodic_length=sus.periodic_length)
    if sus.force_fn is not None:
        f = f + sus.force_fn(sus, r)
    return f


def roller_torques(sus: RollerSuspension, r, dtype):
    if sus.torque_fn is not None:
        return sus.torque_fn(sus, r).reshape(sus.num_rollers, 3)
    return jnp.zeros((sus.num_rollers, 3), dtype=dtype)


# ---------------------------------------------------------------------------
# Grand-mobility product engines (direct O(N^2) vs wall-spectral)
# ---------------------------------------------------------------------------


def _roller_spectral_params(sus: RollerSuspension):
    from ..ops import ewald_wall

    Lx, Ly = sus.periodic_length[0], sus.periodic_length[1]
    if not (Lx > 0 and Ly > 0):
        raise ValueError("single_wall_spectral rollers need "
                         "periodic_length > 0 on x and y")
    if sus.spectral_wall_height <= 0:
        raise ValueError("single_wall_spectral rollers need "
                         "spectral_wall_height > 0 (slab top)")
    return ewald_wall.default_wall_params(
        sus.blob_radius, sus.eta, (Lx, Ly),
        z_hi=sus.spectral_wall_height, tol=sus.spectral_tol,
        grid_max=sus.spectral_grid_max,
        cell_capacity=sus.spectral_cell_capacity,
        bucket_capacity=sus.spectral_bucket_capacity)


class _DirectEngine:
    """Product closures on the pairwise kernels at configuration r."""

    def __init__(self, sus, r):
        self.sus, self.r = sus, r
        self.kw = sus.mobility_kwargs

    def at(self, r_new):
        return _DirectEngine(self.sus, r_new)

    def tt(self, f):
        return mob.mobility_trans_times_force(
            self.r, f, self.sus.eta, self.sus.blob_radius, **self.kw)

    def tr(self, t):
        return mob.mobility_trans_times_torque(
            self.r, t, self.sus.eta, self.sus.blob_radius, **self.kw)

    def rt(self, f):
        return mob.mobility_rot_times_force(
            self.r, f, self.sus.eta, self.sus.blob_radius, **self.kw)

    def rr(self, t):
        return mob.mobility_rot_times_torque(
            self.r, t, self.sus.eta, self.sus.blob_radius, **self.kw)

    def grand(self, f, t):
        return mob.grand_mobility_matvec(
            self.r, f, t, self.sus.eta, self.sus.blob_radius, **self.kw)

    def rr_multi(self, T):
        """(B, n, 3) -> (B, n, 3) rr products in one condensed sweep."""
        return mob.pairwise_matvec_multi(
            self.r, self.r, T, self.sus.eta, self.sus.blob_radius,
            coupling="rr", self_interaction=True, **self.kw)

    def tr_multi(self, T):
        return mob.pairwise_matvec_multi(
            self.r, self.r, T, self.sus.eta, self.sus.blob_radius,
            coupling="tr", self_interaction=True, **self.kw)


class _WallSpectralEngine:
    """Product closures on the O(N log N) wall engine (ewald_wall_rot)."""

    def __init__(self, sus, r, plan=None, tables=None):
        from ..ops import ewald_wall, ewald_wall_rot

        self.sus = sus
        params = _roller_spectral_params(sus)
        if plan is None:
            plan = ewald_wall.make_wall_plan(params, r)
        if tables is None:
            tables = ewald_wall_rot.rot_tables_device(params, r.dtype)
        self.plan = plan
        self.tables = tables

    def at(self, r_new):
        from ..ops import ewald_wall

        return _WallSpectralEngine(
            self.sus, r_new,
            plan=ewald_wall.update_wall_plan(self.plan, r_new),
            tables=self.tables)

    def tt(self, f):
        from ..ops import ewald_wall

        return ewald_wall.matvec(self.plan, f)

    def tr(self, t):
        from ..ops import ewald_wall_rot

        return ewald_wall_rot.grand_matvec(self.plan, None, t,
                                           self.tables)[0]

    def rt(self, f):
        from ..ops import ewald_wall_rot

        return ewald_wall_rot.grand_matvec(self.plan, f, None,
                                           self.tables)[1]

    def rr(self, t):
        from ..ops import ewald_wall_rot

        return ewald_wall_rot.grand_matvec(self.plan, None, t,
                                           self.tables)[1]

    def grand(self, f, t):
        from ..ops import ewald_wall_rot

        return ewald_wall_rot.grand_matvec(self.plan, f, t, self.tables)

    def rr_multi(self, T):
        return jnp.stack([self.rr(T[b]) for b in range(T.shape[0])])

    def tr_multi(self, T):
        return jnp.stack([self.tr(T[b]) for b in range(T.shape[0])])


def _engine(sus: RollerSuspension, r, carry=None):
    if sus.domain == "single_wall_spectral":
        plan = getattr(carry, "plan", None)
        tables = getattr(carry, "rot_tables", None)
        if plan is not None:
            from ..ops import ewald_wall

            plan = ewald_wall.update_wall_plan(plan, r)
        return _WallSpectralEngine(sus, r, plan=plan, tables=tables)
    return _DirectEngine(sus, r)


def swan_brady_self_mobilities(sus: RollerSuspension, z):
    """Closed-form single-wall self mobilities with overlap damping
    (quaternion_integrator_rollers.py:1016-1064)."""
    a = sus.blob_radius
    eta = sus.eta
    f_tt = 1.0 / (6.0 * jnp.pi * eta * a)
    f_rr = 1.0 / (6.0 * jnp.pi * eta * a**3)
    f_rt = 1.0 / (6.0 * jnp.pi * eta * a**2)
    h = z / a
    he = jnp.maximum(h, 1.0)
    damping = jnp.clip(h, 0.0, 1.0)
    mu_rt_para = f_rt * (3.0 / (32.0 * he**4)) * damping
    mu_tt_perp = f_tt * (1.0 - 9.0 / (8.0 * he) + 1.0 / (2.0 * he**3)
                         - 1.0 / (8.0 * he**5)) * damping
    mu_tt_para = f_tt * (1.0 - 9.0 / (16.0 * he) + 2.0 / (16.0 * he**3)
                         - 1.0 / (16.0 * he**5)) * damping
    mu_rr_perp = f_rr * (0.75 - 3.0 / (32.0 * he**3)) * damping
    mu_rr_para = f_rr * (0.75 - 15.0 / (64.0 * he**3)) * damping
    deriv_mu_tt_perp = f_tt * (9.0 / (8.0 * he**2) - 1.5 / he**4
                               + 5.0 / (8.0 * he**6)) * damping
    return dict(tt_para=mu_tt_para, tt_perp=mu_tt_perp, rt_para=mu_rt_para,
                rr_para=mu_rr_para, rr_perp=mu_rr_perp,
                d_tt_perp=deriv_mu_tt_perp)


# ---------------------------------------------------------------------------
# Deterministic velocity (+ constrained-omega torque solve)
# ---------------------------------------------------------------------------


def deterministic_velocity_and_torque(sus: RollerSuspension, r, *,
                                      x0_torque=None, eng=None,
                                      gmres_restart=20, gmres_maxiter=1000):
    """(v, T, gmres_iters) per quaternion_integrator_rollers.py:905-982."""
    dtype = r.dtype
    force = roller_forces(sus, r)

    if not sus.hydro_interactions:
        return _deterministic_uncorrelated(sus, r, force)
    if eng is None:
        eng = _engine(sus, r)

    if not sus.free_kinematics:
        omega = jnp.broadcast_to(
            jnp.asarray(sus.omega_one_roller, dtype=dtype),
            (sus.num_rollers, 3))
        rhs = omega - eng.rt(force)
        rhs_flat = rhs.ravel()
        rhs_norm = jnp.linalg.norm(rhs_flat)
        safe = jnp.where(rhs_norm > 0, rhs_norm, 1.0)

        def op(t):
            return eng.rr(t.reshape(-1, 3)).ravel()

        res = gmres(op, rhs_flat / safe, x0=x0_torque,
                    tol=sus.solver_tolerance, restart=gmres_restart,
                    maxiter=gmres_maxiter)
        torque = (res.x * rhs_norm).reshape(sus.num_rollers, 3)
        iters = res.iterations
    else:
        torque = roller_torques(sus, r, dtype)
        iters = jnp.asarray(0)

    velocity = eng.tt(force) + eng.tr(torque)
    return velocity, torque, iters


def _deterministic_uncorrelated(sus: RollerSuspension, r, force):
    """Closed-form uncorrelated mobilities
    (quaternion_integrator_rollers.py:985-1079)."""
    mus = swan_brady_self_mobilities(sus, r[:, 2])
    fx, fy, fz = force[:, 0], force[:, 1], force[:, 2]
    if not sus.free_kinematics:
        omega = jnp.broadcast_to(
            jnp.asarray(sus.omega_one_roller, dtype=r.dtype),
            (sus.num_rollers, 3))

        def safe_inv(x):
            return jnp.where(x > 0, 1.0 / jnp.where(x > 0, x, 1.0), 0.0)

        inv_para = safe_inv(mus["rr_para"])
        inv_perp = safe_inv(mus["rr_perp"])
        tx = inv_para * (omega[:, 0] + mus["rt_para"] * fy)
        ty = inv_para * (omega[:, 1] - mus["rt_para"] * fx)
        tz = inv_perp * omega[:, 2]
        torque = jnp.stack([tx, ty, tz], axis=1)
    else:
        torque = roller_torques(sus, r, r.dtype)
    vx = mus["tt_para"] * fx + mus["rt_para"] * torque[:, 1]
    vy = mus["tt_para"] * fy - mus["rt_para"] * torque[:, 0]
    vz = mus["tt_perp"] * fz
    velocity = jnp.stack([vx, vy, vz], axis=1)
    return velocity, torque, jnp.asarray(0)


# ---------------------------------------------------------------------------
# Stochastic velocity
# ---------------------------------------------------------------------------


def _rfd_div(sus, r, key, product):
    """(kT/(delta a)) * [P(r+dx/2) dx - P(r-dx/2) dx] for product P."""
    dtype = r.dtype
    dx = jax.random.normal(key, r.shape, dtype=dtype)
    shift = sus.rf_delta * sus.blob_radius * 0.5
    plus = product(r + dx * shift, dx)
    minus = product(r - dx * shift, dx)
    return (sus.kT / (sus.rf_delta * sus.blob_radius)) * (plus - minus)


def stochastic_velocity(sus: RollerSuspension, r, key, dt, *, eng=None,
                        gmres_restart=20, gmres_maxiter=1000):
    """Full grand-mobility stochastic velocity with RFD drift terms
    (quaternion_integrator_rollers.py:1082-1200). Returns
    (v_stoch, lanczos_iters, gmres_iters)."""
    dtype = r.dtype
    n = sus.num_rollers
    k_noise, k_rfd = jax.random.split(key)
    if eng is None:
        eng = _engine(sus, r)

    def grand(ft):
        f = ft[:3 * n].reshape(n, 3)
        t = ft[3 * n:].reshape(n, 3)
        u, w = eng.grand(f, t)
        return jnp.concatenate([u.ravel(), w.ravel()])

    z = jax.random.normal(k_noise, (6 * n,), dtype=dtype)
    noise = stochastic_forcing_lanczos(
        grand, z, factor=jnp.sqrt(2.0 * sus.kT / dt),
        tolerance=sus.solver_tolerance, max_iter=sus.lanczos_max_iter)

    wall = sus.domain != "no_wall"
    if sus.kT > 0 and wall:
        div_M_tt = _rfd_div(sus, r, k_rfd,
                            lambda rr, dx: eng.at(rr).tt(dx))
        div_M_rt = _rfd_div(sus, r, k_rfd,
                            lambda rr, dx: eng.at(rr).rt(dx))
    else:
        div_M_tt = jnp.zeros((n, 3), dtype)
        div_M_rt = jnp.zeros((n, 3), dtype)

    noise_t = noise.noise[:3 * n].reshape(n, 3)
    noise_r = noise.noise[3 * n:].reshape(n, 3)

    if not sus.free_kinematics:
        rhs = (-noise_r - div_M_rt).ravel()
        rhs_norm = jnp.linalg.norm(rhs)
        safe = jnp.where(rhs_norm > 0, rhs_norm, 1.0)

        def op(t):
            return eng.rr(t.reshape(-1, 3)).ravel()

        res = gmres(op, rhs / safe, tol=sus.solver_tolerance,
                    restart=gmres_restart, maxiter=gmres_maxiter)
        torque = (res.x * rhs_norm).reshape(n, 3)
        iters = res.iterations
    else:
        torque = jnp.zeros((n, 3), dtype)
        iters = jnp.asarray(0)

    v = eng.tr(torque)
    v = v + noise_t + div_M_tt
    return v, noise.iterations, iters


def det_stoch_velocity_lockstep(sus: RollerSuspension, r, key, dt, *,
                                x0_torque=None, eng=None,
                                gmres_restart=20, gmres_maxiter=1000):
    """Fused deterministic + stochastic update for constrained-omega
    rollers with hydrodynamic interactions: the deterministic torque
    solve (M_rr T = omega - M_rt F, quaternion_integrator_rollers.py:944)
    and the stochastic torque solve (M_rr T = -noise_r - div M_rt, :1164)
    are both M_rr systems at the SAME configuration — one lockstep
    Krylov loop shares every rr pair sweep across the two right-hand
    sides (ops/gmres.gmres_lockstep), and the two trailing M_tr torque
    products share one condensed-coefficient sweep
    (ops/mobility.pairwise_matvec_multi).

    Returns (v_det, torque_det, v_stoch, gmres_sweeps, lanczos_iters)."""
    from ..ops.gmres import gmres_lockstep

    dtype = r.dtype
    n = sus.num_rollers
    k_noise, k_rfd = jax.random.split(key)
    force = roller_forces(sus, r)
    if eng is None:
        eng = _engine(sus, r)

    def grand(ft):
        f = ft[:3 * n].reshape(n, 3)
        t = ft[3 * n:].reshape(n, 3)
        u, w = eng.grand(f, t)
        return jnp.concatenate([u.ravel(), w.ravel()])

    z = jax.random.normal(k_noise, (6 * n,), dtype=dtype)
    noise = stochastic_forcing_lanczos(
        grand, z, factor=jnp.sqrt(2.0 * sus.kT / dt),
        tolerance=sus.solver_tolerance, max_iter=sus.lanczos_max_iter)

    wall = sus.domain != "no_wall"
    if sus.kT > 0 and wall:
        div_M_tt = _rfd_div(sus, r, k_rfd,
                            lambda rr, dx: eng.at(rr).tt(dx))
        div_M_rt = _rfd_div(sus, r, k_rfd,
                            lambda rr, dx: eng.at(rr).rt(dx))
    else:
        div_M_tt = jnp.zeros((n, 3), dtype)
        div_M_rt = jnp.zeros((n, 3), dtype)

    noise_t = noise.noise[:3 * n].reshape(n, 3)
    noise_r = noise.noise[3 * n:].reshape(n, 3)

    omega = jnp.broadcast_to(
        jnp.asarray(sus.omega_one_roller, dtype=dtype), (n, 3))
    rhs_det = (omega - eng.rt(force)).ravel()
    rhs_st = (-noise_r - div_M_rt).ravel()

    B = jnp.stack([rhs_det, rhs_st])
    norms = jnp.linalg.norm(B, axis=1)
    safe = jnp.where(norms > 0, norms, 1.0)
    x0 = None
    if x0_torque is not None:
        x0 = jnp.stack([x0_torque.ravel() / safe[0],
                        jnp.zeros(3 * n, dtype)])

    def op_multi(T):
        return eng.rr_multi(T.reshape(2, n, 3)).reshape(2, -1)

    res = gmres_lockstep(op_multi, B / safe[:, None], x0=x0,
                         tol=sus.solver_tolerance, restart=gmres_restart,
                         maxiter=gmres_maxiter)
    T = res.x * norms[:, None]
    torque_det = T[0].reshape(n, 3)
    torque_st = T[1].reshape(n, 3)

    # the two M_tr torque products share one pair sweep
    tr = eng.tr_multi(jnp.stack([torque_det, torque_st]))
    v_det = eng.tt(force) + tr[0]
    v_st = tr[1] + noise_t + div_M_tt
    return v_det, torque_det, v_st, res.iterations, noise.iterations


def stochastic_linear_velocity(sus: RollerSuspension, r, key, dt, *,
                               with_drift=True, eng=None):
    """Free-kinematics M_tt-only noise (+ RFD drift)
    (quaternion_integrator_rollers.py:1203-1260, :1315-1353)."""
    dtype = r.dtype
    n = sus.num_rollers
    kw = sus.mobility_kwargs
    k_noise, k_rfd = jax.random.split(key)

    if not sus.hydro_interactions:
        z = jax.random.normal(k_noise, (n, 3), dtype=dtype)
        mus = swan_brady_self_mobilities(sus, r[:, 2])
        fd = jnp.sqrt(2.0 * sus.kT / dt)
        vx = fd * jnp.sqrt(mus["tt_para"]) * z[:, 0]
        vy = fd * jnp.sqrt(mus["tt_para"]) * z[:, 1]
        vz = fd * jnp.sqrt(mus["tt_perp"]) * z[:, 2]
        if with_drift:
            vz = vz + sus.kT * mus["d_tt_perp"]
        return jnp.stack([vx, vy, vz], axis=1), jnp.asarray(0)

    if eng is None:
        eng = _engine(sus, r)

    def mtt(f):
        return eng.tt(f.reshape(-1, 3)).ravel()

    z = jax.random.normal(k_noise, (3 * n,), dtype=dtype)
    noise = stochastic_forcing_lanczos(
        mtt, z, factor=jnp.sqrt(2.0 * sus.kT / dt),
        tolerance=sus.solver_tolerance, max_iter=sus.lanczos_max_iter)
    v = noise.noise.reshape(n, 3)
    if with_drift and sus.kT > 0 and sus.domain != "no_wall":
        v = v + _rfd_div(sus, r, k_rfd,
                         lambda rr, dx: eng.at(rr).tt(dx))
    return v, noise.iterations


# ---------------------------------------------------------------------------
# Schemes + stepper
# ---------------------------------------------------------------------------


def _scheme_forward_euler(sus, dt, key, r, carry):
    v, t, it = deterministic_velocity_and_torque(
        sus, r, eng=_engine(sus, r, carry) if sus.hydro_interactions
        else None)
    return r + dt * v, v, t, it, jnp.asarray(0)


def _scheme_adams_bashforth(sus, dt, key, r, carry):
    v, t, it = deterministic_velocity_and_torque(
        sus, r, eng=_engine(sus, r, carry) if sus.hydro_interactions
        else None)
    v_ab = jnp.where(carry.first_step, v, 1.5 * v - 0.5 * carry.velocities_prev)
    return r + dt * v_ab, v, t, it, jnp.asarray(0)


def _scheme_stochastic_first_order(sus, dt, key, r, carry):
    k1, k2 = jax.random.split(key)
    eng = _engine(sus, r, carry) if sus.hydro_interactions else None
    if sus.free_kinematics:
        v, t, it = deterministic_velocity_and_torque(sus, r, eng=eng)
        vs, it_l = stochastic_linear_velocity(sus, r, k2, dt, eng=eng)
        return r + dt * (v + vs), v, t, it, it_l
    if sus.hydro_interactions:
        v, t, vs, it, it_l = det_stoch_velocity_lockstep(sus, r, k2, dt,
                                                         eng=eng)
        return r + dt * (v + vs), v, t, it, it_l
    v, t, it = deterministic_velocity_and_torque(sus, r)
    vs, it_l, it_g = stochastic_velocity(sus, r, k2, dt)
    return r + dt * (v + vs), v, t, it + it_g, it_l


def _scheme_stochastic_adams_bashforth(sus, dt, key, r, carry):
    k1, k2 = jax.random.split(key)
    eng = _engine(sus, r, carry) if sus.hydro_interactions else None
    if sus.free_kinematics:
        v, t, it = deterministic_velocity_and_torque(sus, r, eng=eng)
        vs, it_l = stochastic_linear_velocity(sus, r, k2, dt, eng=eng)
    elif sus.hydro_interactions:
        # det + stoch torque solves share one lockstep M_rr Krylov loop
        v, t, vs, it, it_l = det_stoch_velocity_lockstep(sus, r, k2, dt,
                                                         eng=eng)
        v_ab = jnp.where(carry.first_step, v,
                         1.5 * v - 0.5 * carry.velocities_prev)
        return r + dt * (v_ab + vs), v, t, it, it_l
    else:
        v, t, it = deterministic_velocity_and_torque(sus, r)
        vs, it_l, it_g = stochastic_velocity(sus, r, k2, dt)
        it = it + it_g
    v_ab = jnp.where(carry.first_step, v, 1.5 * v - 0.5 * carry.velocities_prev)
    return r + dt * (v_ab + vs), v, t, it, it_l


def _thermal_drift(sus, r, key):
    """kT div_t(M_tt) via centered RFD
    (quaternion_integrator_rollers.py:1404-1434)."""
    if sus.kT <= 0 or sus.domain == "no_wall":
        return jnp.zeros_like(r)
    eng = _engine(sus, r)
    return _rfd_div(sus, r, key,
                    lambda rr, dx: eng.at(rr).tt(dx))


def _noise_velocity(sus, r, key, dt_eff):
    """sqrt(2 kT / dt_eff) M_tt^{1/2} W without drift, both hydro modes."""
    n = sus.num_rollers
    dtype = r.dtype
    if not sus.hydro_interactions:
        z = jax.random.normal(key, (n, 3), dtype=dtype)
        mus = swan_brady_self_mobilities(sus, r[:, 2])
        fd = jnp.sqrt(2.0 * sus.kT / dt_eff)
        return jnp.stack([fd * jnp.sqrt(mus["tt_para"]) * z[:, 0],
                          fd * jnp.sqrt(mus["tt_para"]) * z[:, 1],
                          fd * jnp.sqrt(mus["tt_perp"]) * z[:, 2]],
                         axis=1), jnp.asarray(0)
    eng = _engine(sus, r)

    def mtt(f):
        return eng.tt(f.reshape(-1, 3)).ravel()

    z = jax.random.normal(key, (3 * n,), dtype=dtype)
    res = stochastic_forcing_lanczos(
        mtt, z, factor=jnp.sqrt(2.0 * sus.kT / dt_eff),
        tolerance=sus.solver_tolerance, max_iter=sus.lanczos_max_iter)
    return res.noise.reshape(n, 3), res.iterations


def _scheme_stochastic_mid_point(sus, dt, key, r, carry):
    """Midpoint with centered-RFD drift
    (quaternion_integrator_rollers.py:495-574)."""
    k_drift, k1, k2 = jax.random.split(key, 3)
    drift = _thermal_drift(sus, r, k_drift)
    v1, t, it1 = deterministic_velocity_and_torque(sus, r)
    vs1, itl1 = _noise_velocity(sus, r, k1, 0.5 * dt)
    r_mid = r + 0.5 * dt * (v1 + vs1)
    v2, _, it2 = deterministic_velocity_and_torque(sus, r_mid)
    vs2, itl2 = _noise_velocity(sus, r_mid, k2, 0.5 * dt)
    v = v2 + drift + 0.5 * (vs1 + vs2)
    return r + dt * v, v2, t, it1 + it2, itl1 + itl2


def _scheme_stochastic_mid_point_v2(sus, dt, key, r, carry):
    """Midpoint variant: both noises drawn at the initial configuration
    (quaternion_integrator_rollers.py:577-656)."""
    k_drift, k1, k2 = jax.random.split(key, 3)
    drift = _thermal_drift(sus, r, k_drift)
    v1, t, it1 = deterministic_velocity_and_torque(sus, r)
    vs1, itl1 = _noise_velocity(sus, r, k1, 0.5 * dt)
    vs2, itl2 = _noise_velocity(sus, r, k2, 0.5 * dt)
    r_mid = r + 0.5 * dt * (v1 + vs1)
    v2, _, it2 = deterministic_velocity_and_torque(sus, r_mid)
    v = v2 + drift + 0.5 * (vs1 + vs2)
    return r + dt * v, v2, t, it1 + it2, itl1 + itl2


def _scheme_stochastic_trapezoidal(sus, dt, key, r, carry):
    """Trapezoidal with centered-RFD drift
    (quaternion_integrator_rollers.py:659-735)."""
    k_drift, k1 = jax.random.split(key)
    drift = _thermal_drift(sus, r, k_drift)
    v1, t, it1 = deterministic_velocity_and_torque(sus, r)
    vs, itl = _noise_velocity(sus, r, k1, dt)
    r_star = r + dt * (v1 + vs)
    v2, _, it2 = deterministic_velocity_and_torque(sus, r_star)
    v = 0.5 * (v1 + v2) + drift + vs
    return r + dt * v, v2, t, it1 + it2, itl


def _scheme_stochastic_GDC(sus, dt, key, r, carry):
    """Generalized drifter-corrector: the divergence of the Brownian
    velocity is estimated by a z finite difference and enters as a time
    rescaling (quaternion_integrator_rollers.py:369-493)."""
    dtype = r.dtype
    k1, _ = jax.random.split(key)
    n = sus.num_rollers

    if sus.hydro_interactions:
        # reuse the same noise vector at both configurations via same key
        vs_n, itl1 = _noise_velocity(sus, r, k1, dt)
        dz = jnp.zeros_like(r).at[:, 2].set(sus.rf_delta * sus.blob_radius)
        vs_fd, itl2 = _noise_velocity(sus, r + dz, k1, dt)
        div = jnp.sum((vs_fd[:, 2] - vs_n[:, 2])
                      / (sus.rf_delta * sus.blob_radius))
        correction = 1.0 + 0.5 * dt * div
    else:
        z = jax.random.normal(k1, (n, 3), dtype=dtype)

        def uncorr_noise(rr):
            mus = swan_brady_self_mobilities(sus, rr[:, 2])
            fd = jnp.sqrt(2.0 * sus.kT / dt)
            return jnp.stack([fd * jnp.sqrt(mus["tt_para"]) * z[:, 0],
                              fd * jnp.sqrt(mus["tt_para"]) * z[:, 1],
                              fd * jnp.sqrt(mus["tt_perp"]) * z[:, 2]],
                             axis=1)

        vs_n = uncorr_noise(r)
        dz = jnp.zeros_like(r).at[:, 2].set(sus.rf_delta * sus.blob_radius)
        vs_fd = uncorr_noise(r + dz)
        div = (vs_fd[:, 2] - vs_n[:, 2]) / (sus.rf_delta * sus.blob_radius)
        correction = (1.0 + 0.5 * dt * div)[:, None]
        itl1 = itl2 = jnp.asarray(0)

    v_det, t, it = deterministic_velocity_and_torque(sus, r)
    # the reference evaluates det+noise at the Brownian midpoint; the noise
    # at the midpoint reuses the same random vector
    v_mid = v_det + vs_n
    r_new = r + dt * v_mid * correction
    return r_new, v_det, t, it, itl1 + (itl2 if sus.hydro_interactions else 0)


def _scheme_stochastic_EM(sus, dt, key, r, carry):
    k1, k2 = jax.random.split(key)
    v, t, it = deterministic_velocity_and_torque(sus, r)
    vs, it_l = stochastic_linear_velocity(sus, r, k2, dt, with_drift=False)
    return r + dt * (v + vs), v, t, it, it_l


_SCHEMES = {
    "deterministic_forward_euler_rollers": _scheme_forward_euler,
    "deterministic_adams_bashforth_rollers": _scheme_adams_bashforth,
    "stochastic_first_order_rollers": _scheme_stochastic_first_order,
    "stochastic_adams_bashforth_rollers": _scheme_stochastic_adams_bashforth,
    "stochastic_EM_rollers": _scheme_stochastic_EM,
    "stochastic_mid_point_rollers": _scheme_stochastic_mid_point,
    "stochastic_mid_point_version_2_rollers": _scheme_stochastic_mid_point_v2,
    "stochastic_trapezoidal_rollers": _scheme_stochastic_trapezoidal,
    "stochastic_GDC_rollers": _scheme_stochastic_GDC,
}


def available_schemes():
    return tuple(_SCHEMES)


def make_stepper(sus: RollerSuspension, scheme: str, dt: float, *,
                 max_rejections: int = 50):
    """step(positions (N,3), key, carry) -> (positions, carry, RollerAux)."""
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown roller scheme {scheme!r}; "
                         f"available: {sorted(_SCHEMES)}")
    body_fn = _SCHEMES[scheme]
    wall = sus.domain in ("single_wall", "single_wall_spectral")

    def step(r, key, carry: RollerCarry):
        def cond(loop):
            _, _, _, attempts, ok = loop
            return jnp.logical_not(ok) & (attempts < max_rejections)

        def body(loop):
            _, key, _, attempts, _ = loop
            key, sub = jax.random.split(key)
            r_new, v, t, det_it, st_it = body_fn(sus, dt, sub, r, carry)
            ok = jnp.min(r_new[:, 2]) >= 0.0 if wall else jnp.asarray(True)
            return (r_new, key, (v, t, det_it, st_it), attempts + 1, ok)

        zero = (jnp.zeros_like(r), jnp.zeros_like(r), jnp.asarray(0),
                jnp.asarray(0))
        init = (r, key, zero, jnp.asarray(0), jnp.asarray(False))
        r_new, _, (v, t, det_it, st_it), attempts, ok = jax.lax.while_loop(
            cond, body, init)

        overlaps = (jnp.sum(r_new[:, 2] < sus.blob_radius)
                    if wall else jnp.asarray(0))
        plan = getattr(carry, "plan", None)
        if plan is not None:
            from ..ops import ewald_wall

            # refresh the carried plan at the accepted configuration so
            # next step's in-graph refresh measures one-step drift only
            plan = ewald_wall.update_wall_plan(plan, r_new)
        carry = RollerCarry(velocities_prev=v, first_step=jnp.asarray(False),
                            plan=plan,
                            rot_tables=getattr(carry, "rot_tables", None))
        aux = RollerAux(velocities=v, torques=t, det_iterations=det_it,
                        stoch_iterations=st_it, rejections=attempts - 1,
                        wall_overlaps=overlaps)
        return r_new, carry, aux

    return step


def simulate(sus: RollerSuspension, positions, key, *, scheme, dt, n_steps,
             save_every=1, **kw):
    step = make_stepper(sus, scheme, dt, **kw)
    carry0 = init_carry(sus, dtype=positions.dtype, positions=positions)

    def scan_body(lc, _):
        r, key, carry = lc

        def inner(lc, _):
            r, key, carry = lc
            key, sub = jax.random.split(key)
            r, carry, aux = step(r, sub, carry)
            return (r, key, carry), aux

        (r, key, carry), aux = jax.lax.scan(inner, (r, key, carry), None,
                                            length=save_every)
        return (r, key, carry), (r, jax.tree.map(lambda x: x[-1], aux))

    (r, key, carry), (traj, aux) = jax.lax.scan(
        scan_body, (positions, key, carry0), None,
        length=n_steps // save_every)
    return r, traj, aux
