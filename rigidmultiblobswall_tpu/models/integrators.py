"""Temporal integrators for rigid multiblob Brownian dynamics.

Functional re-design of the reference's QuaternionIntegrator scheme family
(/root/reference/quaternion_integrator/quaternion_integrator_multi_bodies.py):
each scheme is a pure function `attempt(key, state, carry) -> StepResult`;
`make_stepper` wraps it with the wall-rejection retry loop (reference
`while True` + check_positions, :84,:1779-1824) as a bounded
`lax.while_loop` that redraws the Brownian increments on every retry.

Schemes implemented (reference line refs):
  deterministic_forward_euler       :75
  deterministic_adams_bashforth     :142
  deterministic_midpoint            :188
  stochastic_EM                     :262
  stochastic_first_order_RFD        :326
  stochastic_Slip_Trapz             :925  (recommended stochastic scheme)
  stochastic_traction_EM            :626
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import mobility as mob
from ..ops.lanczos import stochastic_forcing_lanczos
from . import kinematics as kin
from . import saddle, solvers
from .system import State, System


class StepAux(NamedTuple):
    velocities: jax.Array       # (B,6) velocities used for the update
    det_iterations: jax.Array   # GMRES iterations this step
    stoch_iterations: jax.Array # Lanczos iterations this step
    rejections: jax.Array       # wall-rejection retries this step
    solves_converged: jax.Array = True  # every GMRES solve of the last
    #                                     attempt reached tolerance
    capacity_overflows: jax.Array = 0   # spectral plan drop counters
    #                                     (gridding segments + near cells)
    #                                     as of the plan's last full sort


class Carry(NamedTuple):
    velocities_prev: jax.Array  # (B,6) for Adams-Bashforth
    first_step: jax.Array       # bool
    step_idx: jax.Array = None  # int, for time-dependent constraints
    # spectral engine carried ACROSS steps: each step refreshes it at its
    # own start configuration (ops/ewald.update_plan — position
    # re-gathers with an automatic full-rebuild fallback past the drift
    # budget) instead of paying the plan sorts every step. None for
    # every other engine, and when init_carry is not given a state.
    plan: object = None
    # Krylov recycle state (ops/gmres.RecycleState) carried across steps
    # when make_stepper(recycle_k > 0): the slow saddle modes barely
    # change between steps, so recycled directions warm-start/deflate
    # every solve (measured 5 -> 1 GMRES iterations,
    # tools/deflation_experiment.py). None when disabled.
    recycle: object = None
    # wall-engine per-mode noise factor tables (ewald_wall.
    # _noise_factors_device), position-independent, O(modes * p^2)
    # floats — carried as pytree ARGUMENTS so they never lower as HLO
    # literal constants (at bench slabs the tables are 10^2 MB, which
    # would bloat every compiled step).
    # None for every other engine and when init_carry got no state.
    noise_factors: object = None


def init_carry(system: System, dtype=jnp.float64, state=None,
               recycle_k: int = 0) -> Carry:
    plan = None
    factors = None
    if state is not None and saddle.is_spectral(system):
        # jitted: eagerly the plan build dispatches hundreds of small
        # ops one by one
        plan = jax.jit(lambda r: saddle.maybe_dense_mobility(system, r))(
            kin.blob_positions(system, state))
        if system.domain == "single_wall_spectral" and system.kT > 0:
            from ..ops import ewald_wall

            factors = ewald_wall._noise_factors_device(
                saddle.spectral_params(system), dtype)
    rec = None
    if recycle_k > 0:
        from ..ops.gmres import RecycleState

        rec = RecycleState.empty(recycle_k, saddle.saddle_size(system),
                                 dtype)
    return Carry(
        velocities_prev=jnp.zeros((system.num_bodies, 6), dtype=dtype),
        first_step=jnp.asarray(True),
        step_idx=jnp.asarray(0),
        plan=plan,
        recycle=rec,
        noise_factors=factors,
    )


def body_lengths(system: System, dtype=jnp.float64):
    """(B,) RFD length scale per body (body/body.py:218-231 + 2a)."""
    out = np.concatenate([
        np.full(t.count, t.body_length + 2.0 * system.blob_radius)
        for t in system.types
    ])
    return jnp.asarray(out, dtype=dtype)


def _noise_slip(system, state, pc, key, factor, tolerance, max_iter,
                check_every=1, m_dense=None, _cached_noise_factors=None,
                **_ignored):
    """sqrt(2 kT/dt) M^{1/2} W via preconditioned Lanczos.

    periodic_spectral: positively-split sampling instead — the wave part
    of the Hasimoto split has a CLOSED-FORM square root in k-space
    (ewald.wave_sqrt_noise), so Lanczos runs only on the local,
    well-conditioned near-field operator (a ~30x cheaper product that
    converges in a handful of iterations, vs ~25+ full matvecs for the
    whole M). Independent Gaussians for the two parts add in covariance:
    Cov = M_wave + M_near = M."""
    if system.domain == "periodic_spectral":
        from ..ops import ewald

        if not isinstance(m_dense, ewald.SpectralPlan):
            m_dense = saddle.maybe_dense_mobility(
                system, kin.blob_positions(system, state))
        plan = m_dense
        kw, kr = jax.random.split(key)
        uw = ewald.wave_sqrt_noise(plan, kw).reshape(-1)
        z = jax.random.normal(kr, (3 * system.num_blobs,),
                              dtype=state.pos.dtype)
        res = stochastic_forcing_lanczos(
            lambda f: ewald.real_matvec(plan, f.reshape(-1, 3)).reshape(-1),
            z, factor=factor, tolerance=tolerance, max_iter=max_iter,
            check_every=check_every)
        return res.noise + factor * uw, res.iterations
    if system.domain == "single_wall_spectral":
        # wall PSE split: closed-form sample of the wave modes' PSD
        # parts (per-mode z-Chebyshev factors, ewald_wall.
        # wave_sqrt_noise) + Lanczos on (M_near - Delta), Delta the
        # small PSD per-mode defect (the wall image channels are not
        # individually PSD per in-plane mode; see ewald_wall.
        # _noise_factors_device). Covariances add exactly to
        # D(M_near + M_wave)D with D the overlap damping.
        from ..ops import ewald_wall

        if not isinstance(m_dense, ewald_wall.WallPlan):
            m_dense = saddle.maybe_dense_mobility(
                system, kin.blob_positions(system, state))
        plan = m_dense
        kw, kr = jax.random.split(key)
        damp = plan.damp[:, None]
        fac = _cached_noise_factors
        if fac is None:
            fac = ewald_wall._noise_factors_device(plan.params,
                                                   state.pos.dtype)
        uw = (damp * ewald_wall.wave_sqrt_noise(plan, kw,
                                                factors=fac)).reshape(-1)
        z = jax.random.normal(kr, (3 * system.num_blobs,),
                              dtype=state.pos.dtype)

        def near_minus_defect(f):
            f3 = damp * f.reshape(-1, 3)
            out = (ewald_wall.near_matvec(plan, f3)
                   - ewald_wall.wave_defect_matvec(plan, f3, factors=fac))
            return (damp * out).reshape(-1)

        res = stochastic_forcing_lanczos(
            near_minus_defect, z, factor=factor, tolerance=tolerance,
            max_iter=max_iter, check_every=check_every)
        return res.noise + factor * uw, res.iterations
    mobility_pc, L_mult = saddle.make_noise_pc(system, state, pc,
                                               m_dense=m_dense)
    z = jax.random.normal(key, (3 * system.num_blobs,), dtype=state.pos.dtype)
    res = stochastic_forcing_lanczos(mobility_pc, z, factor=factor,
                                     tolerance=tolerance, max_iter=max_iter,
                                     L_mult=L_mult, check_every=check_every)
    return res.noise, res.iterations


_PC_CACHE_KEY = "_cached_pc"
_PLAN_CACHE_KEY = "_cached_plan"
_RECYCLE_KEY = "_cached_recycle"
_FACTORS_KEY = "_cached_noise_factors"
_CACHE_KEYS = (_PC_CACHE_KEY, _PLAN_CACHE_KEY, _RECYCLE_KEY, _FACTORS_KEY)


def _get_pc(system, state, lanczos_kw):
    """Use the stepper's cached preconditioner when update_PC > 1
    (reference static-var memoization keyed on step % update_PC,
    multi_bodies.py:508); otherwise factor at the current state."""
    pc = lanczos_kw.get(_PC_CACHE_KEY)
    if pc is not None:
        return pc
    return saddle.build_block_diag_pc(system, state)


def _get_m_dense(system, r_blobs, lanczos_kw):
    """Step-start mobility engine: the carried cross-step spectral plan
    (already refreshed at this configuration by the stepper wrapper)
    when present, else build at r_blobs."""
    plan = lanczos_kw.get(_PLAN_CACHE_KEY)
    if plan is not None:
        return plan
    return saddle.maybe_dense_mobility(system, r_blobs)


def _free_mask(system, dtype):
    return jnp.asarray(~system.prescribed_body_mask, dtype=dtype)[:, None]


# ---------------------------------------------------------------------------
# Scheme bodies: each returns (state_new, aux_ok_tuple)
# ---------------------------------------------------------------------------


def _det_recycle(system, state, lanczos_kw, m_dense, pc=None):
    """Refresh the carried Krylov recycle state for a deterministic
    solve (one batched sweep); returns the refreshed state or None."""
    rec = lanczos_kw.get(_RECYCLE_KEY)
    if rec is None:
        return None
    return solvers.refresh_recycle(system, state, rec, pc=pc,
                                   m_dense=m_dense)


def _deterministic_forward_euler(system, dt, solver_kw, lanczos_kw,
                                 key, state, carry):
    m_dense = _get_m_dense(system, kin.blob_positions(system, state),
                           lanczos_kw)
    rec = _det_recycle(system, state, lanczos_kw, m_dense)
    sol = solvers.solve_mobility_problem(
        system, state, m_dense=m_dense, recycle=rec,
        collect_recycle=rec is not None, **solver_kw)
    new_state = kin.advance(state, sol.velocities, dt)
    ok = kin.valid_configuration(system, new_state)
    return (new_state, sol.velocities, sol.iterations, jnp.asarray(0), ok,
            sol.converged, sol.recycle if rec is not None else None)


def _deterministic_adams_bashforth(system, dt, solver_kw, lanczos_kw,
                                   key, state, carry):
    m_dense = _get_m_dense(system, kin.blob_positions(system, state),
                           lanczos_kw)
    rec = _det_recycle(system, state, lanczos_kw, m_dense)
    sol = solvers.solve_mobility_problem(
        system, state, m_dense=m_dense, recycle=rec,
        collect_recycle=rec is not None, **solver_kw)
    v_ab = jnp.where(carry.first_step, sol.velocities,
                     1.5 * sol.velocities - 0.5 * carry.velocities_prev)
    new_state = kin.advance(state, v_ab, dt)
    ok = kin.valid_configuration(system, new_state)
    return (new_state, sol.velocities, sol.iterations, jnp.asarray(0), ok,
            sol.converged, sol.recycle if rec is not None else None)


def _deterministic_midpoint(system, dt, solver_kw, lanczos_kw,
                            key, state, carry):
    pc = _get_pc(system, state, lanczos_kw)
    m_dense = _get_m_dense(system, kin.blob_positions(system, state),
                           lanczos_kw)
    sol1 = solvers.solve_mobility_problem(system, state, pc=pc,
                                          m_dense=m_dense, **solver_kw)
    mid = kin.advance(state, sol1.velocities, 0.5 * dt)
    ok_mid = kin.valid_configuration(system, mid)
    m_mid = saddle.refresh_dense_mobility(
        system, m_dense, kin.blob_positions(system, mid))
    x0 = jnp.concatenate([sol1.lam.ravel(), sol1.velocities.ravel(),
                          sol1.phi.ravel()])
    sol2 = solvers.solve_mobility_problem(system, mid, pc=pc, x0=x0,
                                          m_dense=m_mid, **solver_kw)
    new_state = kin.advance(state, sol2.velocities, dt)
    ok = ok_mid & kin.valid_configuration(system, new_state)
    return (new_state, sol2.velocities,
            sol1.iterations + sol2.iterations, jnp.asarray(0), ok,
            sol1.converged & sol2.converged)


def _stochastic_EM(system, dt, solver_kw, lanczos_kw, key, state, carry):
    pc = _get_pc(system, state, lanczos_kw)
    factor = jnp.sqrt(2.0 * system.kT / dt)
    # ONE mobility engine per step (the carried cross-step spectral plan
    # when present), shared by the noise Lanczos and the solve
    m_dense = _get_m_dense(system, kin.blob_positions(system, state),
                           lanczos_kw)
    noise, it_l = _noise_slip(system, state, pc, key, factor,
                              m_dense=m_dense, **lanczos_kw)
    sol = solvers.solve_mobility_problem(system, state, pc=pc,
                                         noise_slip=noise,
                                         m_dense=m_dense, **solver_kw)
    new_state = kin.advance(state, sol.velocities, dt)
    ok = kin.valid_configuration(system, new_state)
    return (new_state, sol.velocities, sol.iterations, it_l, ok,
            sol.converged)


def _stochastic_first_order_RFD(system, dt, solver_kw, lanczos_kw,
                                key, state, carry):
    """EM + RFD thermal drift kT div_x N via two extra solves
    (quaternion_integrator_multi_bodies.py:326-428)."""
    dtype = state.pos.dtype
    pc = _get_pc(system, state, lanczos_kw)
    k_noise, k_rfd = jax.random.split(key)
    factor = jnp.sqrt(2.0 * system.kT / dt)
    # ONE mobility engine per step-start configuration (the carried
    # cross-step spectral plan when present); the +-delta/2 RFD
    # configurations refresh it (position re-gathers only)
    m_dense = _get_m_dense(system, kin.blob_positions(system, state),
                           lanczos_kw)
    noise, it_l = _noise_slip(system, state, pc, k_noise, factor,
                              m_dense=m_dense, **lanczos_kw)
    sol = solvers.solve_mobility_problem(system, state, pc=pc,
                                         noise_slip=noise,
                                         m_dense=m_dense, **solver_kw)
    velocities = sol.velocities

    W = jax.random.normal(k_rfd, (system.num_bodies, 6), dtype=dtype)
    lengths = body_lengths(system, dtype)
    disp = W.at[:, :3].multiply(lengths[:, None])      # displacement scale
    force_rfd = W.at[:, :3].divide(lengths[:, None])   # conjugate force scale
    delta = system.rf_delta

    n3 = 3 * system.num_blobs
    rhs_rfd = jnp.concatenate([jnp.zeros(n3, dtype), -force_rfd.ravel()])

    spectral = saddle.is_spectral(system)
    state_minus = State(pos=state.pos - 0.5 * delta * disp[:, :3],
                        quat=kin.quat.step(state.quat, W[:, 3:], -0.5 * delta))
    m_minus = (saddle.refresh_dense_mobility(
        system, m_dense, kin.blob_positions(system, state_minus))
        if spectral else "auto")
    sol_minus = solvers.solve_mobility_problem(system, state_minus, pc=pc,
                                               rhs=rhs_rfd, m_dense=m_minus,
                                               **solver_kw)

    state_plus = State(pos=state.pos + 0.5 * delta * disp[:, :3],
                       quat=kin.quat.step(state.quat, W[:, 3:], 0.5 * delta))
    # residual trick: velocities_drift = N(x+)(rhs) - N(x-)(rhs) to O(delta)
    r_plus = kin.blob_positions(system, state_plus)
    m_plus = (saddle.refresh_dense_mobility(system, m_dense, r_plus)
              if spectral else None)
    op_plus = saddle.make_linear_operator(system, state_plus, r_plus,
                                          m_dense=m_plus)
    sol_minus_flat = jnp.concatenate([sol_minus.lam.ravel(),
                                      sol_minus.velocities.ravel()])
    rhs_residual = rhs_rfd - op_plus(sol_minus_flat)
    sol_drift = solvers.solve_mobility_problem(system, state_plus, pc=pc,
                                               rhs=rhs_residual,
                                               m_dense=m_plus if spectral
                                               else "auto", **solver_kw)

    velocities = velocities + (system.kT / delta) * sol_drift.velocities
    new_state = kin.advance(state, velocities, dt)
    ok = kin.valid_configuration(system, new_state)
    iters = sol.iterations + sol_minus.iterations + sol_drift.iterations
    conv = sol.converged & sol_minus.converged & sol_drift.converged
    return new_state, velocities, iters, it_l, ok, conv


def _stochastic_traction_EM(system, dt, solver_kw, lanczos_kw,
                            key, state, carry):
    """EM with RFD drift handled at the traction level: 2 rigid solves +
    1 Lanczos + 2 M products + 4 K products
    (quaternion_integrator_multi_bodies.py:626-737)."""
    dtype = state.pos.dtype
    pc = _get_pc(system, state, lanczos_kw)
    k_noise, k_rfd = jax.random.split(key)
    factor = jnp.sqrt(2.0 * system.kT / dt)
    kT_over_delta = 2.0 * system.kT / system.rf_delta
    mob_kw = system.mobility_kwargs

    W_slip = jax.random.normal(k_rfd, (system.num_blobs, 3), dtype=dtype)
    r_blobs = kin.blob_positions(system, state)
    # ONE mobility engine per step-start configuration (the carried
    # cross-step spectral plan when present), shared by the M products,
    # the RFD solve, the noise Lanczos and the drift-corrected solve;
    # both sides of the RFD difference must use the SAME engine — the
    # mismatch would be amplified by the 1/rf_delta in the drift term
    m_dense = _get_m_dense(system, r_blobs, lanczos_kw)
    MxW = saddle._mobility_apply(system, r_blobs, m_dense, W_slip)
    KTxW = kin.KT_mul(system, state, W_slip)

    # RFD displacement of the whole suspension by delta * W at blob level:
    # solve for the rigid-body motion consistent with W_slip
    sol_rfd = solvers.solve_mobility_problem(
        system, state,
        rhs=jnp.concatenate([-W_slip.ravel(),
                             jnp.zeros(6 * system.num_bodies, dtype)]),
        pc=pc, m_dense=m_dense, **solver_kw)
    rfd_state = kin.advance(state, sol_rfd.velocities, system.rf_delta)

    r_rfd = kin.blob_positions(system, rfd_state)
    # spectral plans refresh in place at the displaced configuration
    # (position re-gathers only — the RFD displacement is tiny)
    m_rfd = saddle.refresh_dense_mobility(system, m_dense, r_rfd,
                                          build=False)
    M_rfd_xW = saddle._mobility_apply(system, r_rfd, m_rfd, W_slip)
    KT_rfd_xW = kin.KT_mul(system, rfd_state, W_slip)

    noise, it_l = _noise_slip(system, state, pc, k_noise, factor,
                              m_dense=m_dense, **lanczos_kw)
    rand_slip = noise + kT_over_delta * (M_rfd_xW - MxW).ravel()
    rand_ft = -kT_over_delta * (KT_rfd_xW - KTxW)

    sol = solvers.solve_mobility_problem(system, state, pc=pc,
                                         noise_slip=rand_slip,
                                         noise_ft=rand_ft,
                                         m_dense=m_dense, **solver_kw)
    new_state = kin.advance(state, sol.velocities, dt)
    ok = kin.valid_configuration(system, new_state)
    iters = sol_rfd.iterations + sol.iterations
    return (new_state, sol.velocities, iters, it_l, ok,
            sol_rfd.converged & sol.converged)


def _stochastic_slip_trapz(system, dt, solver_kw, lanczos_kw,
                           key, state, carry):
    """Stochastic trapezoidal with slip-level thermal drift: 3 rigid solves
    + 1 Lanczos + 2 M products + 2 K^T products (the reference's
    recommended scheme, quaternion_integrator_multi_bodies.py:925-1045)."""
    dtype = state.pos.dtype
    pc = _get_pc(system, state, lanczos_kw)
    k1, k2 = jax.random.split(key)
    factor = jnp.sqrt(2.0 * system.kT / dt)
    kT_over_delta = 2.0 * system.kT / system.rf_delta
    mob_kw = system.mobility_kwargs

    W_slip = jax.random.normal(k2, (system.num_blobs, 3), dtype=dtype)
    r_blobs = kin.blob_positions(system, state)
    m_dense = _get_m_dense(system, r_blobs, lanczos_kw)
    MxW = saddle._mobility_apply(system, r_blobs, m_dense, W_slip)
    KTxW = kin.KT_mul(system, state, W_slip)

    noise1, it_l = _noise_slip(system, state, pc, k1, factor,
                               m_dense=m_dense, **lanczos_kw)

    # carried Krylov recycle state: re-biorthonormalize once at the
    # step-start configuration (ONE batched k-RHS sweep), then every
    # solve of the step warm-starts/deflates with it
    rec = lanczos_kw.get(_RECYCLE_KEY)
    if rec is not None:
        rec = solvers.refresh_recycle(system, state, rec, pc=pc,
                                      m_dense=m_dense)

    # the rigid solve and the RFD solve share the configuration (and so
    # the operator and PC): solve both RHS in ONE lockstep Krylov loop,
    # sharing every pair sweep / gridding pass across the two columns
    # (the reference solves them back to back,
    # quaternion_integrator_multi_bodies.py:966-1007)
    rhs1 = solvers.build_rhs(system, state, r_blobs, noise_slip=noise1)
    rhs_rfd = jnp.zeros_like(rhs1).at[:3 * system.num_blobs].set(
        -W_slip.ravel())
    lock_kw = {k: v for k, v in solver_kw.items() if k != "verbose"}
    sol_pair = solvers.solve_mobility_problem_lockstep(
        system, state, rhs=jnp.stack([rhs1, rhs_rfd]), pc=pc,
        m_dense=m_dense, recycle=rec, collect_recycle=rec is not None,
        **lock_kw)
    sol1 = solvers.MobilitySolution(
        lam=sol_pair.lam[0], velocities=sol_pair.velocities[0],
        iterations=sol_pair.iterations,
        residual_norm=sol_pair.residual_norm[0], phi=sol_pair.phi[0])
    v1 = sol1.velocities
    W_RFD = sol_pair.velocities[1] * _free_mask(system, dtype)

    rfd_state = kin.advance(state, W_RFD, system.rf_delta)
    r_rfd = kin.blob_positions(system, rfd_state)
    # same-engine RFD difference at the rf_delta-displaced configuration:
    # the spectral plan refreshes in place (position re-gathers only —
    # the drift is tiny) instead of paying a full plan rebuild for ONE
    # product; other engines take the matrix-free sweep
    m_rfd = saddle.refresh_dense_mobility(system, m_dense, r_rfd,
                                          build=False)
    M_rfd_xW = saddle._mobility_apply(system, r_rfd, m_rfd, W_slip)
    KT_rfd_xW = kin.KT_mul(system, rfd_state, W_slip)

    rand_slip_cor = noise1 + kT_over_delta * (M_rfd_xW - MxW).ravel()
    rand_ft_cor = -kT_over_delta * (KT_rfd_xW - KTxW)

    predictor = kin.advance(state, v1, dt)
    ok_pred = kin.valid_configuration(system, predictor)

    # warm-start the corrector from the predictor solution (the operator
    # and RHS move only O(dt) between x_n and the predictor); the
    # predictor's mobility engine refreshes from the step-start plan
    r_pred = kin.blob_positions(system, predictor)
    m_pred = saddle.refresh_dense_mobility(system, m_dense, r_pred)
    x0 = jnp.concatenate([sol1.lam.ravel(), v1.ravel(), sol1.phi.ravel()])
    # the corrector is warm-started from the predictor AND the recycle
    # projection; harvesting happens at the LOCKSTEP solve (the
    # corrector's residual Krylov space is nearly empty and harvests
    # nothing useful)
    sol2 = solvers.solve_mobility_problem(system, predictor, pc=pc,
                                          noise_slip=rand_slip_cor,
                                          noise_ft=rand_ft_cor, x0=x0,
                                          m_dense=m_pred, recycle=rec,
                                          **solver_kw)
    velocities = 0.5 * (v1 + sol2.velocities)
    new_state = kin.advance(state, velocities, dt)
    ok = ok_pred & kin.valid_configuration(system, new_state)
    # lockstep pair counts batched sweeps once (one sweep serves both RHS)
    iters = sol_pair.iterations + sol2.iterations
    rec_out = sol_pair.recycle if sol_pair.recycle is not None else rec
    return (new_state, velocities, iters, it_l, ok,
            sol_pair.converged & sol2.converged, rec_out)


def _dense_sqrt_mul(N, z, factor):
    """factor * N^{1/2} z via dense eigendecomposition (the reference's
    stochastic_forcing_eig, stochastic_forcing/stochastic_forcing.py:7-83)."""
    w, q = jnp.linalg.eigh(N)
    w = jnp.sqrt(jnp.maximum(w, 0.0))
    return factor * (q @ (w * (q.T @ z)))


def _stochastic_adams_bashforth(system, dt, solver_kw, lanczos_kw,
                                key, state, carry):
    """AB2 deterministic + EM noise + RFD drift: rollers-style AB for
    multi-body suspensions
    (quaternion_integrator_multi_bodies.py:431-549)."""
    dtype = state.pos.dtype
    pc = _get_pc(system, state, lanczos_kw)
    k_noise, k_rfd = jax.random.split(key)
    factor = jnp.sqrt(2.0 * system.kT / dt)
    n3 = 3 * system.num_blobs

    r_blobs_ab = kin.blob_positions(system, state)
    # ONE mobility engine per step-start configuration, shared by the
    # noise Lanczos and the lockstep solve; the +-delta/2 RFD
    # configurations refresh it (position re-gathers only)
    m_dense = _get_m_dense(system, r_blobs_ab, lanczos_kw)
    noise, it_l = _noise_slip(system, state, pc, k_noise, factor,
                              m_dense=m_dense, **lanczos_kw)
    # stochastic + deterministic solves share the configuration: one
    # lockstep Krylov loop with two RHS columns
    rhs_det = solvers.build_rhs(system, state, r_blobs_ab)
    rhs_stoch = jnp.zeros_like(rhs_det).at[:n3].set(-noise.ravel())
    lock_kw = {k: v for k, v in solver_kw.items() if k != "verbose"}
    sol_pair = solvers.solve_mobility_problem_lockstep(
        system, state, rhs=jnp.stack([rhs_stoch, rhs_det]), pc=pc,
        m_dense=m_dense, **lock_kw)
    v_stoch = sol_pair.velocities[0]
    v_det = sol_pair.velocities[1]

    W = jax.random.normal(k_rfd, (system.num_bodies, 6), dtype=dtype)
    lengths = body_lengths(system, dtype)
    disp = W.at[:, :3].multiply(lengths[:, None])
    force_rfd = W.at[:, :3].divide(lengths[:, None])
    delta = system.rf_delta
    rhs_rfd = jnp.concatenate([jnp.zeros(n3, dtype), -force_rfd.ravel()])

    state_minus = State(pos=state.pos - 0.5 * delta * disp[:, :3],
                        quat=kin.quat.step(state.quat, W[:, 3:], -0.5 * delta))
    # +-delta/2 engines: spectral plans refresh cheaply; the materialized
    # dense path keeps its previous scoped "auto" rebuilds (holding three
    # plane sets live at once would break the memory budget)
    spectral = saddle.is_spectral(system)
    r_minus = kin.blob_positions(system, state_minus)
    m_minus = (saddle.refresh_dense_mobility(system, m_dense, r_minus)
               if spectral else "auto")
    sol_minus = solvers.solve_mobility_problem(system, state_minus, pc=pc,
                                               rhs=rhs_rfd, m_dense=m_minus,
                                               **solver_kw)
    state_plus = State(pos=state.pos + 0.5 * delta * disp[:, :3],
                       quat=kin.quat.step(state.quat, W[:, 3:], 0.5 * delta))
    r_plus = kin.blob_positions(system, state_plus)
    m_plus = (saddle.refresh_dense_mobility(system, m_dense, r_plus)
              if spectral else None)
    op_plus = saddle.make_linear_operator(system, state_plus, r_plus,
                                          m_dense=m_plus)
    sol_minus_flat = jnp.concatenate([sol_minus.lam.ravel(),
                                      sol_minus.velocities.ravel()])
    rhs_residual = rhs_rfd - op_plus(sol_minus_flat)
    sol_drift = solvers.solve_mobility_problem(system, state_plus, pc=pc,
                                               rhs=rhs_residual,
                                               m_dense=m_plus if spectral
                                               else "auto", **solver_kw)
    v_stoch = v_stoch + (system.kT / delta) * sol_drift.velocities

    v_ab = jnp.where(carry.first_step, v_det,
                     1.5 * v_det - 0.5 * carry.velocities_prev)
    new_state = kin.advance(state, v_ab + v_stoch, dt)
    ok = kin.valid_configuration(system, new_state)
    iters = (sol_pair.iterations
             + sol_minus.iterations + sol_drift.iterations)
    # carry keeps only the deterministic velocity (reference :546)
    conv = sol_pair.converged & sol_minus.converged & sol_drift.converged
    return new_state, v_det, iters, it_l, ok, conv


def _deterministic_forward_euler_dense(system, dt, solver_kw, lanczos_kw,
                                       key, state, carry):
    v, _ = solvers.solve_mobility_problem_dense(system, state)
    new_state = kin.advance(state, v, dt)
    ok = kin.valid_configuration(system, new_state)
    return new_state, v, jnp.asarray(0), jnp.asarray(0), ok, True


def _stochastic_first_order_RFD_dense(system, dt, solver_kw, lanczos_kw,
                                      key, state, carry):
    """Dense-algebra RFD scheme
    (quaternion_integrator_multi_bodies.py:552-623)."""
    dtype = state.pos.dtype
    k_noise, k_rfd = jax.random.split(key)
    v, N = solvers.solve_mobility_problem_dense(system, state)
    z = jax.random.normal(k_noise, (6 * system.num_bodies,), dtype=dtype)
    v = v + _dense_sqrt_mul(N, z, jnp.sqrt(2.0 * system.kT / dt)).reshape(
        system.num_bodies, 6)

    W = jax.random.normal(k_rfd, (system.num_bodies, 6), dtype=dtype)
    lengths = body_lengths(system, dtype)
    disp = W.at[:, :3].multiply(lengths[:, None])
    force_rfd = W.at[:, :3].divide(lengths[:, None])
    delta = system.rf_delta
    state_plus = State(pos=state.pos + delta * disp[:, :3],
                       quat=kin.quat.step(state.quat, W[:, 3:], delta))
    N_plus = solvers.solve_body_mobility(system, state_plus)
    v = v + (system.kT / delta) * (
        (N_plus - N) @ force_rfd.ravel()).reshape(system.num_bodies, 6)
    new_state = kin.advance(state, v, dt)
    ok = kin.valid_configuration(system, new_state)
    return new_state, v, jnp.asarray(0), jnp.asarray(0), ok, True


def _dense_pieces(system, state):
    """Dense solve ingredients for the DLA schemes
    (solve_mobility_problem_DLA,
    quaternion_integrator_multi_bodies.py:1592-1635): velocities plus the
    dense M, R = M^{-1}, K and N = pinv(K^T R K)."""
    dtype = state.pos.dtype
    r_blobs = kin.blob_positions(system, state)
    slip = kin.active_slip(system, state, dtype)
    if system.slip_fn is not None:
        slip = slip + system.slip_fn(system, state).reshape(slip.shape)
    FT = solvers.force_torque_calculator(system, state, r_blobs)
    M = solvers.dense_blob_mobility(system, state)
    K = solvers._dense_K(system, state)
    R = jnp.linalg.inv(M)
    N = jnp.linalg.pinv(K.T @ (R @ K))
    v = N @ (FT.ravel() - K.T @ (R @ slip.ravel()))
    return v, N, M, R, K


def _stochastic_slip_mid_dla(system, dt, solver_kw, lanczos_kw, key, state,
                             carry):
    """Slip-midpoint scheme with dense linear algebra
    (stochastic_Slip_Mid_DLA,
    quaternion_integrator_multi_bodies.py:1346-1438): predictor noise
    N K^T M^{-1} M^{1/2} W1 at sqrt(4kT/dt), RFD displacement
    W_RFD = N K^T M^{-1} W_slip probing the divergence of both M and K^T,
    corrector with the summed increment Wcor = W1 + W1'."""
    dtype = state.pos.dtype
    B = system.num_bodies
    n3 = 3 * system.num_blobs
    k1, k2, k3 = jax.random.split(key, 3)
    delta = system.rf_delta

    v_mid, N, M, R, K = _dense_pieces(system, state)

    W1 = jax.random.normal(k1, (n3,), dtype=dtype)
    W_slip = jax.random.normal(k2, (n3,), dtype=dtype)
    Wcor = W1 + jax.random.normal(k3, (n3,), dtype=dtype)

    W_RFD = N @ (K.T @ (R @ W_slip))
    MxW_slip = M @ W_slip
    KTxW_slip = K.T @ W_slip
    Mhalf_W1 = _dense_sqrt_mul(M, W1, 1.0)
    Mhalf_Wcor = _dense_sqrt_mul(M, Wcor, 1.0)

    v_mid = v_mid + jnp.sqrt(4.0 * system.kT / dt) * (
        N @ (K.T @ (R @ Mhalf_W1)))

    # RFD configuration: displace by W_RFD * delta and difference M, K^T
    rfd_state = kin.advance(state, W_RFD.reshape(B, 6), delta)
    M_rfd = solvers.dense_blob_mobility(system, rfd_state)
    K_rfd = solvers._dense_K(system, rfd_state)
    DxM = M_rfd @ W_slip - MxW_slip
    DxKT = K_rfd.T @ W_slip - KTxW_slip

    mid = kin.advance(state, v_mid.reshape(B, 6), 0.5 * dt)
    ok_mid = kin.valid_configuration(system, mid)

    v_new, N2, M2, R2, K2 = _dense_pieces(system, mid)
    rhs_cor = (-(system.kT / delta) * DxKT
               + K2.T @ (R2 @ (jnp.sqrt(system.kT / dt) * Mhalf_Wcor
                               + (system.kT / delta) * DxM)))
    v_new = (v_new + N2 @ rhs_cor).reshape(B, 6)

    new_state = kin.advance(state, v_new, dt)
    ok = ok_mid & kin.valid_configuration(system, new_state)
    return new_state, v_new, jnp.asarray(0), jnp.asarray(0), ok, True


def _fixman(system, dt, solver_kw, lanczos_kw, key, state, carry):
    """Fixman midpoint with dense algebra
    (quaternion_integrator_multi_bodies.py:738-800)."""
    dtype = state.pos.dtype
    k1, k2 = jax.random.split(key)
    v_mid, N = solvers.solve_mobility_problem_dense(system, state)
    W1 = jax.random.normal(k1, (6 * system.num_bodies,), dtype=dtype)
    W_cor = W1 + jax.random.normal(k2, (6 * system.num_bodies,), dtype=dtype)
    Nhalf_W1 = _dense_sqrt_mul(N, W1, jnp.sqrt(4.0 * system.kT / dt))
    Nhalf_Wcor = _dense_sqrt_mul(N, W_cor, jnp.sqrt(system.kT / dt))
    Ninvhalf_cor = jnp.linalg.pinv(N) @ Nhalf_Wcor
    v_mid = v_mid + Nhalf_W1.reshape(system.num_bodies, 6)

    mid = kin.advance(state, v_mid, 0.5 * dt)
    ok_mid = kin.valid_configuration(system, mid)
    v_new, N_new = solvers.solve_mobility_problem_dense(system, mid)
    v_new = v_new + (N_new @ Ninvhalf_cor).reshape(system.num_bodies, 6)
    new_state = kin.advance(state, v_new, dt)
    ok = ok_mid & kin.valid_configuration(system, new_state)
    return new_state, v_new, jnp.asarray(0), jnp.asarray(0), ok, True


def _unpc_noise(system, state, key, factor, tolerance, max_iter,
                check_every=1, m_dense=None, **_ignored):
    """Plain M^{1/2} W (no preconditioner), used by the GDC scheme."""
    r_blobs = kin.blob_positions(system, state)
    # for periodic_spectral, the caller's carried plan (or a fresh build
    # outside the Lanczos while_loop); None falls through pairwise
    m_eng = m_dense
    if m_eng is None and saddle.is_spectral(system):
        m_eng = saddle.maybe_dense_mobility(system, r_blobs)

    def mtt(v):
        return saddle._mobility_apply(
            system, r_blobs, m_eng, v.reshape(-1, 3)).ravel()

    z = jax.random.normal(key, (3 * system.num_blobs,), dtype=state.pos.dtype)
    res = stochastic_forcing_lanczos(mtt, z, factor=factor,
                                     tolerance=tolerance, max_iter=max_iter,
                                     check_every=check_every)
    return res.noise, res.iterations, z


def _stochastic_GDC_RFD(system, dt, solver_kw, lanczos_kw, key, state, carry):
    """Generalized Drifter-Corrector: 1 constrained solve + 3 Lanczos +
    2 identity unconstrained solves
    (quaternion_integrator_multi_bodies.py:1048-1212)."""
    dtype = state.pos.dtype
    k_w, k_rfd = jax.random.split(key)
    factor = jnp.sqrt(2.0 * system.kT / dt)
    n3 = 3 * system.num_blobs
    zeros_b = jnp.zeros(6 * system.num_bodies, dtype)

    m_start = _get_m_dense(system, kin.blob_positions(system, state),
                           lanczos_kw)
    noise_n, it1, z = _unpc_noise(system, state, k_w, factor,
                                  m_dense=m_start, **lanczos_kw)
    sol_n = saddle.apply_identity_saddle_solver(
        system, state, jnp.concatenate([-noise_n, zeros_b]))
    _, U_n, _ = saddle.split_saddle_vector(system, sol_n)

    # one-sided RFD of the unconstrained velocity divergence
    W = jax.random.normal(k_rfd, (system.num_bodies, 6), dtype=dtype)
    lengths = body_lengths(system, dtype)
    rfd_state = State(
        pos=state.pos + system.rf_delta * lengths[:, None] * W[:, :3],
        quat=kin.quat.step(state.quat, W[:, 3:], system.rf_delta))
    # reuse the same z at the displaced configuration (:1126-1132)
    r_rfd = kin.blob_positions(system, rfd_state)
    # the displaced configuration refreshes the step-start engine
    # (position re-gathers only; the RFD displacement is tiny)
    m_eng_rfd = (saddle.refresh_dense_mobility(system, m_start, r_rfd,
                                               build=False)
                 if saddle.is_spectral(system) else None)

    def mtt_rfd(v):
        return saddle._mobility_apply(
            system, r_rfd, m_eng_rfd, v.reshape(-1, 3)).ravel()

    res_rfd = stochastic_forcing_lanczos(
        mtt_rfd, z, factor=factor,
        **{k: v for k, v in lanczos_kw.items() if k not in _CACHE_KEYS})
    sol_rfd = saddle.apply_identity_saddle_solver(
        system, rfd_state, jnp.concatenate([-res_rfd.noise, zeros_b]))
    _, U_rfd, _ = saddle.split_saddle_vector(system, sol_rfd)

    dU = U_rfd - U_n
    div = (jnp.sum(dU[:, :3] * W[:, :3] / (system.rf_delta * lengths[:, None]))
           + jnp.sum(dU[:, 3:] * W[:, 3:]) / system.rf_delta)

    mid = kin.advance(state, U_n, 0.5 * dt)
    ok_mid = kin.valid_configuration(system, mid)

    pc_mid = saddle.build_block_diag_pc(system, mid)
    # the carried step-start engine refreshes at the midpoint (position
    # re-gathers only for the spectral plan; other engines rebuild)
    m_mid = saddle.refresh_dense_mobility(
        system, m_start, kin.blob_positions(system, mid))
    noise_mid, it3 = _noise_slip(system, mid, pc_mid, k_w, factor,
                                 m_dense=m_mid, **lanczos_kw)
    sol_mid = solvers.solve_mobility_problem(system, mid, pc=pc_mid,
                                             noise_slip=noise_mid,
                                             m_dense=m_mid, **solver_kw)
    correction = 1.0 + 0.5 * dt * div
    new_state = kin.advance(state, sol_mid.velocities * correction, dt)
    ok = ok_mid & kin.valid_configuration(system, new_state)
    iters = sol_mid.iterations
    st_iters = it1 + res_rfd.iterations + it3
    return (new_state, sol_mid.velocities, iters, st_iters, ok,
            sol_mid.converged)


def _stochastic_slip_mid(system, dt, solver_kw, lanczos_kw, key, state,
                         carry):
    """Stochastic midpoint with slip-level drift: 3 rigid solves + 2
    Lanczos (quaternion_integrator_multi_bodies.py:1214-1343)."""
    dtype = state.pos.dtype
    pc = _get_pc(system, state, lanczos_kw)
    k1, k2, k3 = jax.random.split(key, 3)
    mob_kw = system.mobility_kwargs

    W_slip = jax.random.normal(k2, (system.num_blobs, 3), dtype=dtype)
    r_blobs = kin.blob_positions(system, state)
    # ONE mobility engine per step-start configuration, shared by the
    # M products, the noise Lanczos and the lockstep solve
    m_dense = _get_m_dense(system, r_blobs, lanczos_kw)
    MxW = saddle._mobility_apply(system, r_blobs, m_dense, W_slip)
    KTxW = kin.KT_mul(system, state, W_slip)

    mobility_pc, L_mult = saddle.make_noise_pc(system, state, pc,
                                               r_blobs=r_blobs,
                                               m_dense=m_dense)
    W1 = jax.random.normal(k1, (3 * system.num_blobs,), dtype=dtype)
    Wcor = W1 + jax.random.normal(k3, (3 * system.num_blobs,), dtype=dtype)
    lkw = {k: v for k, v in lanczos_kw.items() if k not in _CACHE_KEYS}
    noise_W1 = stochastic_forcing_lanczos(
        mobility_pc, W1, factor=jnp.sqrt(4.0 * system.kT / dt),
        L_mult=L_mult, **lkw)
    noise_Wcor = stochastic_forcing_lanczos(
        mobility_pc, Wcor, factor=jnp.sqrt(system.kT / dt),
        L_mult=L_mult, **lkw)

    # midpoint solve + RFD solve share the configuration: one lockstep
    # Krylov loop, one pair sweep per iteration for both RHS
    r_blobs_mid = kin.blob_positions(system, state)
    rhs_mid = solvers.build_rhs(system, state, r_blobs_mid,
                                noise_slip=noise_W1.noise)
    rhs_rfd = jnp.zeros_like(rhs_mid).at[:3 * system.num_blobs].set(
        -W_slip.ravel())
    lock_kw = {k: v for k, v in solver_kw.items() if k != "verbose"}
    sol_pair = solvers.solve_mobility_problem_lockstep(
        system, state, rhs=jnp.stack([rhs_mid, rhs_rfd]), pc=pc,
        m_dense=m_dense, **lock_kw)
    sol_mid = solvers.MobilitySolution(
        lam=sol_pair.lam[0], velocities=sol_pair.velocities[0],
        iterations=sol_pair.iterations,
        residual_norm=sol_pair.residual_norm[0], phi=sol_pair.phi[0])
    v_mid = sol_mid.velocities
    W_RFD = sol_pair.velocities[1] * _free_mask(system, dtype)

    rfd_state = kin.advance(state, W_RFD, system.rf_delta)
    r_rfd = kin.blob_positions(system, rfd_state)
    m_rfd = saddle.refresh_dense_mobility(system, m_dense, r_rfd,
                                          build=False)
    M_rfd_xW = saddle._mobility_apply(system, r_rfd, m_rfd, W_slip)
    KT_rfd_xW = kin.KT_mul(system, rfd_state, W_slip)

    kT_over_delta = system.kT / system.rf_delta
    rand_slip_cor = noise_Wcor.noise + kT_over_delta * (M_rfd_xW - MxW).ravel()
    rand_ft_cor = -kT_over_delta * (KT_rfd_xW - KTxW)

    mid = kin.advance(state, v_mid, 0.5 * dt)
    ok_mid = kin.valid_configuration(system, mid)
    r_mid = kin.blob_positions(system, mid)
    m_mid = saddle.refresh_dense_mobility(system, m_dense, r_mid)
    x0 = jnp.concatenate([sol_mid.lam.ravel(), v_mid.ravel(),
                          sol_mid.phi.ravel()])
    sol_cor = solvers.solve_mobility_problem(system, mid, pc=pc,
                                             noise_slip=rand_slip_cor,
                                             noise_ft=rand_ft_cor, x0=x0,
                                             m_dense=m_mid, **solver_kw)
    new_state = kin.advance(state, sol_cor.velocities, dt)
    ok = ok_mid & kin.valid_configuration(system, new_state)
    iters = sol_pair.iterations + sol_cor.iterations
    st = noise_W1.iterations + noise_Wcor.iterations
    return (new_state, sol_cor.velocities, iters, st, ok,
            sol_pair.converged & sol_cor.converged)


def _stochastic_traction_AB(system, dt, solver_kw, lanczos_kw, key, state,
                            carry):
    """AB with traction-level RFD: 3 rigid solves + 1 Lanczos
    (quaternion_integrator_multi_bodies.py:803-923)."""
    dtype = state.pos.dtype
    pc = _get_pc(system, state, lanczos_kw)
    k_rfd, k_noise = jax.random.split(key)
    n3 = 3 * system.num_blobs
    mob_kw = system.mobility_kwargs
    lengths = body_lengths(system, dtype)

    rfd_noise = jax.random.normal(k_rfd, (system.num_bodies, 6), dtype=dtype)
    W = rfd_noise.at[:, :3].multiply(system.kT / lengths[:, None])
    W = W.at[:, 3:].multiply(system.kT)
    rhs_rand = jnp.concatenate([jnp.zeros(n3, dtype), -W.ravel()])
    r_blobs = kin.blob_positions(system, state)
    # ONE mobility engine per step-start configuration, shared by the
    # RFD solve, the M products, the noise Lanczos and the lockstep solve
    m_dense = _get_m_dense(system, r_blobs, lanczos_kw)
    sol_rfd = solvers.solve_mobility_problem(system, state, rhs=rhs_rand,
                                             pc=pc, m_dense=m_dense,
                                             **solver_kw)
    U_RFD, Lam_RFD = sol_rfd.velocities, sol_rfd.lam

    MxLam = saddle._mobility_apply(system, r_blobs, m_dense, Lam_RFD)
    KTxLam = kin.KT_mul(system, state, Lam_RFD)
    KxU = kin.K_mul(system, state, U_RFD)

    rfd_state = State(
        pos=state.pos + system.rf_delta * lengths[:, None] * rfd_noise[:, :3],
        quat=kin.quat.step(state.quat, rfd_noise[:, 3:], system.rf_delta))
    r_rfd = kin.blob_positions(system, rfd_state)
    m_rfd = saddle.refresh_dense_mobility(system, m_dense, r_rfd,
                                          build=False)
    DxM = saddle._mobility_apply(system, r_rfd, m_rfd, Lam_RFD) - MxLam
    DxKT = kin.KT_mul(system, rfd_state, Lam_RFD) - KTxLam
    DxK = kin.K_mul(system, rfd_state, U_RFD) - KxU

    noise, it_l = _noise_slip(system, state, pc, k_noise,
                              jnp.sqrt(2.0 * system.kT / dt),
                              m_dense=m_dense, **lanczos_kw)
    rand_slip = (DxM - DxK).ravel() / system.rf_delta
    rand_ft = -DxKT / system.rf_delta

    # drift-corrected solve + noise solve share the configuration: one
    # lockstep Krylov loop with two RHS columns
    rhs_new = solvers.build_rhs(system, state, r_blobs,
                                noise_slip=rand_slip, noise_ft=rand_ft)
    rhs_rand = jnp.zeros_like(rhs_new).at[:n3].set(-noise)
    lock_kw = {k: v for k, v in solver_kw.items() if k != "verbose"}
    sol_pair = solvers.solve_mobility_problem_lockstep(
        system, state, rhs=jnp.stack([rhs_new, rhs_rand]), pc=pc,
        m_dense=m_dense, **lock_kw)
    v_det = sol_pair.velocities[0]
    v_noise = sol_pair.velocities[1]
    v_ab = jnp.where(carry.first_step, v_det + v_noise,
                     1.5 * v_det + v_noise - 0.5 * carry.velocities_prev)
    new_state = kin.advance(state, v_ab, dt)
    ok = kin.valid_configuration(system, new_state)
    iters = sol_rfd.iterations + sol_pair.iterations
    return (new_state, v_det, iters, it_l, ok,
            sol_rfd.converged & sol_pair.converged)


def _articulated_deterministic_forward_euler(system, dt, solver_kw,
                                             lanczos_kw, key, state, carry):
    """FE for articulated bodies: solve with constraints, advance, CM
    correction, nonlinear projection
    (quaternion_integrator_multi_bodies.py:1638-1687). Time-dependent
    links evaluate at t = step * dt via the carried step index."""
    from . import articulated as art_mod

    t_now = carry.step_idx * dt
    m_dense = _get_m_dense(system, kin.blob_positions(system, state),
                           lanczos_kw)
    sol = solvers.solve_mobility_problem(system, state, time=t_now,
                                         m_dense=m_dense, **solver_kw)
    moved = kin.advance(state, sol.velocities, dt)
    moved = art_mod.correct_center_of_mass(system, moved, state,
                                           sol.velocities, dt,
                                           time=t_now + dt)
    moved = art_mod.nonlinear_projection(
        system, moved, time=t_now + dt,
        tol=system.nonlinear_solver_tolerance)
    ok = kin.valid_configuration(system, moved)
    return (moved, sol.velocities, sol.iterations, jnp.asarray(0), ok,
            sol.converged)


def _articulated_deterministic_midpoint(system, dt, solver_kw, lanczos_kw,
                                        key, state, carry):
    """Midpoint for articulated bodies
    (quaternion_integrator_multi_bodies.py:1690-1776)."""
    from . import articulated as art_mod

    t_now = carry.step_idx * dt
    m_dense = _get_m_dense(system, kin.blob_positions(system, state),
                           lanczos_kw)
    sol1 = solvers.solve_mobility_problem(system, state, time=t_now,
                                          m_dense=m_dense, **solver_kw)
    mid = kin.advance(state, sol1.velocities, 0.5 * dt)
    mid = art_mod.correct_center_of_mass(system, mid, state, sol1.velocities,
                                         dt, midpoint_fraction=0.5,
                                         time=t_now + 0.5 * dt)
    mid = art_mod.nonlinear_projection(
        system, mid, time=t_now + 0.5 * dt,
        tol=system.nonlinear_solver_tolerance)

    x0 = jnp.concatenate([sol1.lam.ravel(), sol1.velocities.ravel(),
                          sol1.phi.ravel()])
    m_mid = saddle.refresh_dense_mobility(
        system, m_dense, kin.blob_positions(system, mid))
    sol2 = solvers.solve_mobility_problem(system, mid, time=t_now + 0.5 * dt,
                                          x0=x0, m_dense=m_mid, **solver_kw)
    new = kin.advance(state, sol2.velocities, dt)
    new = art_mod.correct_center_of_mass(system, new, state, sol2.velocities,
                                         dt, time=t_now + dt)
    new = art_mod.nonlinear_projection(
        system, new, time=t_now + dt,
        tol=system.nonlinear_solver_tolerance)
    ok = kin.valid_configuration(system, new)
    return (new, sol2.velocities, sol1.iterations + sol2.iterations,
            jnp.asarray(0), ok, sol1.converged & sol2.converged)


def _articulated_single_blob_scheme(midpoint):
    """Articulated single-blob (rollers) FE / midpoint: the multibody
    articulated update driven by the grand-mobility constrained solve
    (quaternion_integrator_rollers.py:737-802). Bodies must be
    single-blob types."""

    def scheme(system, dt, solver_kw, lanczos_kw, key, state, carry):
        from . import articulated as art_mod

        kw = {k: v for k, v in solver_kw.items() if k != "m_dense"}
        t_now = carry.step_idx * dt
        sol = solvers.solve_mobility_problem_single_blob(
            system, state, time=t_now, **kw)
        iters = sol.iterations
        conv = sol.converged
        if midpoint:
            mid = kin.advance(state, sol.velocities, 0.5 * dt)
            mid = art_mod.correct_center_of_mass(
                system, mid, state, sol.velocities, dt,
                midpoint_fraction=0.5, time=t_now + 0.5 * dt)
            mid = art_mod.nonlinear_projection(
                system, mid, time=t_now + 0.5 * dt,
                tol=system.nonlinear_solver_tolerance)
            sol = solvers.solve_mobility_problem_single_blob(
                system, mid, time=t_now + 0.5 * dt, **kw)
            iters = iters + sol.iterations
            conv = conv & sol.converged
        new = kin.advance(state, sol.velocities, dt)
        new = art_mod.correct_center_of_mass(system, new, state,
                                             sol.velocities, dt,
                                             time=t_now + dt)
        new = art_mod.nonlinear_projection(
            system, new, time=t_now + dt,
            tol=system.nonlinear_solver_tolerance)
        ok = kin.valid_configuration(system, new)
        return new, sol.velocities, iters, jnp.asarray(0), ok, conv

    return scheme


_SCHEMES = {
    "deterministic_forward_euler": _deterministic_forward_euler,
    "articulated_deterministic_forward_euler_rollers":
        _articulated_single_blob_scheme(midpoint=False),
    "articulated_deterministic_midpoint_rollers":
        _articulated_single_blob_scheme(midpoint=True),
    "articulated_deterministic_forward_euler": _articulated_deterministic_forward_euler,
    "articulated_deterministic_midpoint": _articulated_deterministic_midpoint,
    "deterministic_forward_euler_dense_algebra": _deterministic_forward_euler_dense,
    "stochastic_adams_bashforth": _stochastic_adams_bashforth,
    "stochastic_first_order_RFD_dense_algebra": _stochastic_first_order_RFD_dense,
    "Fixman": _fixman,
    "stochastic_GDC_RFD": _stochastic_GDC_RFD,
    "stochastic_Slip_Mid": _stochastic_slip_mid,
    "stochastic_Slip_Mid_DLA": _stochastic_slip_mid_dla,
    "stochastic_traction_AB": _stochastic_traction_AB,
    "deterministic_adams_bashforth": _deterministic_adams_bashforth,
    "deterministic_midpoint": _deterministic_midpoint,
    "stochastic_EM": _stochastic_EM,
    "stochastic_first_order_RFD": _stochastic_first_order_RFD,
    "stochastic_traction_EM": _stochastic_traction_EM,
    "stochastic_Slip_Trapz": _stochastic_slip_trapz,
}


def available_schemes():
    return tuple(_SCHEMES)


def make_stepper(system: System, scheme: str, dt: float, *,
                 tolerance: float = None,
                 lanczos_tolerance: float = 1e-6,
                 lanczos_max_iter: int = 64,
                 lanczos_check_every: int = 1,
                 gmres_restart: int = 60,
                 gmres_maxiter: int = 1000,
                 max_rejections: int = 50,
                 update_PC: int = 1,
                 recycle_k: int = 0,
                 verbose: bool = False) -> Callable:
    """Build step(state, key, carry) -> (state, carry, StepAux).

    The wall-rejection loop retries the whole step with fresh Brownian
    increments, bounded at max_rejections (the reference retries
    unboundedly; a deterministic scheme that lands invalid returns its last
    candidate and reports it in StepAux.rejections)."""
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; "
                         f"available: {sorted(_SCHEMES)}")
    body_fn = _SCHEMES[scheme]
    solver_kw = dict(tol=tolerance, restart=gmres_restart,
                     maxiter=gmres_maxiter)
    if verbose:
        # per-iteration GMRES residual printing from inside jit (the
        # reference's --print-residual, multi_bodies.py:62-74)
        solver_kw["verbose"] = True
    lanczos_kw = dict(tolerance=lanczos_tolerance, max_iter=lanczos_max_iter,
                      check_every=lanczos_check_every)

    def attempt(key, state, carry, extra_kw=None):
        lkw = dict(lanczos_kw, **(extra_kw or {}))
        res = body_fn(system, dt, solver_kw, lkw, key, state, carry)
        if len(res) == 6:
            # scheme without recycle support: pass the state through
            res = res + (lkw.get(_RECYCLE_KEY),)
        return res

    def _step_plan(state, carry):
        """Refresh the carried cross-step spectral plan at this step's
        start configuration (position re-gathers; full rebuild past the
        drift budget). Returns (plan_or_None, extra_kw)."""
        plan = getattr(carry, "plan", None)
        fac = getattr(carry, "noise_factors", None)
        fac_kw = {} if fac is None else {_FACTORS_KEY: fac}
        if plan is None:
            return None, fac_kw
        plan = saddle.refresh_dense_mobility(
            system, plan, kin.blob_positions(system, state))
        return plan, {_PLAN_CACHE_KEY: plan, **fac_kw}

    def _plan_overflow(plan, state):
        """Capacity-overflow count this step: the carried spectral
        plan's drop counters (recounted at each full rebuild) plus the
        linked-cell force layout's overflow at the current positions —
        a growing local density that outpaces the t=0 auto-sizing
        surfaces here instead of silently dropping near-field pairs /
        gridding contributions / repulsion forces."""
        from ..ops import forces as force_ops

        out = force_ops.neighbor_list_overflow(
            system, kin.blob_positions(system, state))
        if plan is not None and hasattr(plan, "n_dropped"):
            out = out + plan.n_dropped + plan.n_dropped_cells
        elif plan is not None and hasattr(plan, "n_dropped_grid"):
            # wall engine: gridding drops + cell drops + slab-top clips
            out = (out + plan.n_dropped_grid + plan.n_dropped_cells
                   + plan.n_clipped)
        return out

    if update_PC > 1:
        def step(state: State, key, carry):
            inner, pc, step_idx = carry
            pc = jax.lax.cond(
                step_idx % update_PC == 0,
                lambda: saddle.build_block_diag_pc(system, state),
                lambda: pc)
            plan, plan_kw = _step_plan(state, inner)
            rec_in = getattr(inner, "recycle", None)
            if rec_in is not None:
                plan_kw = {**plan_kw, _RECYCLE_KEY: rec_in}

            def cond(loop):
                _, _, _, attempts, ok = loop
                return jnp.logical_not(ok) & (attempts < max_rejections)

            def body(loop):
                _, key, _, attempts, _ = loop
                key, sub = jax.random.split(key)
                (new_state, velocities, det_it, st_it, ok, conv,
                 rec_out) = attempt(sub, state, inner,
                                    {_PC_CACHE_KEY: pc, **plan_kw})
                return (new_state, key,
                        (velocities, det_it, st_it, jnp.asarray(conv),
                         rec_out),
                        attempts + 1, ok)

            zero_aux = (jnp.zeros((system.num_bodies, 6),
                                  dtype=state.pos.dtype),
                        jnp.asarray(0), jnp.asarray(0), jnp.asarray(True),
                        rec_in)
            init = (state, key, zero_aux, jnp.asarray(0), jnp.asarray(False))
            (new_state, _, (velocities, det_it, st_it, conv, rec_new),
             attempts, ok) = jax.lax.while_loop(cond, body, init)
            new_inner = Carry(velocities_prev=velocities,
                              first_step=jnp.asarray(False),
                              step_idx=inner.step_idx + 1,
                              plan=plan, recycle=rec_new,
                              noise_factors=getattr(inner, "noise_factors",
                                                    None))
            aux = StepAux(velocities=velocities, det_iterations=det_it,
                          stoch_iterations=st_it, rejections=attempts - 1,
                          solves_converged=conv,
                          capacity_overflows=_plan_overflow(plan, state))
            return new_state, (new_inner, pc, step_idx + 1), aux

        return step

    def step(state: State, key, carry: Carry):
        plan, plan_kw = _step_plan(state, carry)
        rec_in = getattr(carry, "recycle", None)
        if rec_in is not None:
            plan_kw = {**plan_kw, _RECYCLE_KEY: rec_in}

        def cond(loop):
            _, _, _, attempts, ok = loop
            return jnp.logical_not(ok) & (attempts < max_rejections)

        def body(loop):
            _, key, _, attempts, _ = loop
            key, sub = jax.random.split(key)
            (new_state, velocities, det_it, st_it, ok, conv,
             rec_out) = attempt(sub, state, carry, plan_kw)
            return (new_state, key,
                    (velocities, det_it, st_it, jnp.asarray(conv), rec_out),
                    attempts + 1, ok)

        zero_aux = (jnp.zeros((system.num_bodies, 6), dtype=state.pos.dtype),
                    jnp.asarray(0), jnp.asarray(0), jnp.asarray(True),
                    rec_in)
        init = (state, key, zero_aux, jnp.asarray(0), jnp.asarray(False))
        (new_state, _, (velocities, det_it, st_it, conv, rec_new),
         attempts, ok) = jax.lax.while_loop(cond, body, init)

        new_carry = Carry(velocities_prev=velocities,
                          first_step=jnp.asarray(False),
                          step_idx=carry.step_idx + 1,
                          plan=plan, recycle=rec_new,
                          noise_factors=getattr(carry, "noise_factors",
                                                None))
        aux = StepAux(velocities=velocities, det_iterations=det_it,
                      stoch_iterations=st_it, rejections=attempts - 1,
                      solves_converged=conv,
                      capacity_overflows=_plan_overflow(plan, state))
        return new_state, new_carry, aux

    return step


def simulate(system: System, state: State, key, *, scheme: str, dt: float,
             n_steps: int, save_every: int = 1, **stepper_kw):
    """lax.scan time loop; returns (final_state, trajectory of saved
    states, aux history). The reference's outer time loop
    (multi_bodies.py:1422-1511) as one compiled scan."""
    step = make_stepper(system, scheme, dt, **stepper_kw)
    carry0 = init_carry(system, dtype=state.pos.dtype, state=state)

    def scan_body(loop_carry, _):
        state, key, carry = loop_carry

        def inner(lc, _):
            state, key, carry = lc
            key, sub = jax.random.split(key)
            state, carry, aux = step(state, sub, carry)
            return (state, key, carry), aux

        (state, key, carry), aux = jax.lax.scan(
            inner, (state, key, carry), None, length=save_every)
        last_aux = jax.tree.map(lambda x: x[-1], aux)
        return (state, key, carry), (state, last_aux)

    n_saves = n_steps // save_every
    (state, key, carry), (traj, aux_hist) = jax.lax.scan(
        scan_body, (state, key, carry0), None, length=n_saves)
    return state, traj, aux_hist


def init_carry_with_pc(system: System, state: State, dtype=jnp.float64):
    """Carry for steppers built with update_PC > 1: (Carry, cached PC,
    step index). The PC is refactored every update_PC steps inside the
    step (reference update_PC option, multi_bodies.py:508)."""
    return (init_carry(system, dtype=dtype, state=state),
            saddle.build_block_diag_pc(system, state),
            jnp.asarray(0))
