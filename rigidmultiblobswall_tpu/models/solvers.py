"""High-level static solves: mobility, resistance and body-mobility problems.

Mirrors the reference driver semantics
(/root/reference/multi_bodies/multi_bodies_utilities.py:450-614 and
quaternion_integrator_multi_bodies.py:1441-1547) with everything jittable:
RHS assembly (active slip, external force-torque, prescribed kinematics),
RHS normalization, right-preconditioned GMRES, and velocity extraction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import forces as force_ops
from ..ops import mobility as mob
from ..ops.gmres import gmres
from . import kinematics as kin
from . import saddle
from .system import State, System


class MobilitySolution(NamedTuple):
    lam: jax.Array          # (N,3) constraint forces on blobs
    velocities: jax.Array   # (B,6)
    iterations: jax.Array
    residual_norm: jax.Array
    phi: jax.Array = None   # (C,3) articulated constraint forces
    converged: jax.Array = True  # GMRES reached tolerance (all RHS)
    recycle: object = None  # updated ops/gmres.RecycleState (when asked)


def force_torque_calculator(system: System, state: State, r_blobs):
    """Default L5 force assembly (multi_bodies_functions.py:411-445):
    one-blob external forces + blob-blob pair forces aggregated through K^T,
    plus body-body forces and user hooks. Returns (B,6)."""
    f_blobs = force_ops.blob_external_forces(
        r_blobs, g=system.g, blob_mass=1.0, blob_radius=system.blob_radius,
        repulsion_strength_wall=system.repulsion_strength_wall,
        debye_length_wall=system.debye_length_wall)
    if system.blob_blob_force_method == "none":
        # the reference's blob_blob_force_implementation=None default
        # (multi_bodies_functions.py:260 -> default_zero_r_vectors)
        pass
    elif system.blob_blob_force_method == "neighbor_list":
        f_blobs = f_blobs + force_ops.blob_blob_forces_neighbor_list(
            r_blobs, repulsion_strength=system.repulsion_strength,
            debye_length=system.debye_length,
            blob_radius=system.blob_radius,
            periodic_length=system.periodic_length,
            cutoff=(system.blob_blob_cutoff or None),
            grid_dim=system.blob_blob_grid_dim,
            cell_capacity=system.blob_blob_cell_capacity,
            # wall slabs declare a static z extent so the pre-gathered
            # cell layout applies despite the open z direction
            z_extent=(system.spectral_wall_height
                      if system.spectral_wall_height > 0 else None))
    else:
        f_blobs = f_blobs + force_ops.blob_blob_forces(
            r_blobs, repulsion_strength=system.repulsion_strength,
            debye_length=system.debye_length,
            blob_radius=system.blob_radius,
            periodic_length=system.periodic_length)
    if system.blob_force_fn is not None:
        f_blobs = f_blobs + system.blob_force_fn(system, state, r_blobs)
    ft = kin.KT_mul(system, state, f_blobs)
    # body-body Yukawa is opt-in, matching the reference's default
    # body_body_force_torque_implementation=None (multi_bodies.py:1139)
    if system.body_body_force_method in ("python", "yukawa"):
        ft = ft + force_ops.body_body_forces_torques(
            state.pos, repulsion_strength=system.repulsion_strength,
            debye_length=system.debye_length,
            periodic_length=system.periodic_length)
    if system.body_force_torque_fn is not None:
        ft = ft + system.body_force_torque_fn(system, state, r_blobs)
    return ft


def build_rhs(system: System, state: State, r_blobs, slip=None,
              force_torque=None, noise_slip=None, noise_ft=None, time=0.0):
    """RHS = [slip - noise, -(F+noise_FT), B] with prescribed-kinematics
    rewrite (quaternion_integrator_multi_bodies.py:1457-1489)."""
    dtype = state.pos.dtype
    if slip is None:
        slip = kin.active_slip(system, state, dtype)
        if system.slip_fn is not None:
            slip = slip + system.slip_fn(system, state).reshape(
                system.num_blobs, 3)
    slip = slip.reshape(system.num_blobs, 3)
    if force_torque is None:
        force_torque = force_torque_calculator(system, state, r_blobs)
    force_torque = force_torque.reshape(system.num_bodies, 6)
    if noise_ft is not None:
        force_torque = force_torque + noise_ft.reshape(system.num_bodies, 6)

    if system.prescribed_body_mask.any():
        KU = kin.K_mul(system, state,
                       jnp.asarray(system.prescribed_velocities, dtype=dtype))
        blob_mask = saddle.blob_prescribed_mask(system)[:, None]
        slip = slip + blob_mask * KU
        body_mask = jnp.asarray(system.prescribed_body_mask)[:, None]
        force_torque = jnp.where(body_mask, 0.0, force_torque)

    parts = [slip.ravel(), -force_torque.ravel()]
    if saddle.num_constraints(system) > 0:
        from . import articulated as art_mod

        parts.append(art_mod.constraint_rhs(system, state, time).ravel())
    rhs = jnp.concatenate(parts)
    if noise_slip is not None:
        n3 = 3 * system.num_blobs
        rhs = rhs.at[:n3].add(-noise_slip.ravel())
    return rhs


def solve_mobility_problem(
    system: System,
    state: State,
    *,
    rhs=None,
    slip=None,
    force_torque=None,
    noise_slip=None,
    noise_ft=None,
    pc: Optional[saddle.BlockDiagPC] = None,
    x0=None,
    tol: Optional[float] = None,
    restart: int = 60,
    maxiter: int = 1000,
    m_dense="auto",
    time=0.0,
    verbose: bool = False,
    recycle=None,
    collect_recycle: bool = False,
) -> MobilitySolution:
    """Preconditioned GMRES solve of the saddle system
    (quaternion_integrator_multi_bodies.py:1441-1547).

    m_dense: 'auto' materializes the blob mobility when it fits the memory
    budget so each GMRES iteration is one dense matvec; None forces the
    matrix-free pairwise engine; or pass a prebuilt (3N,3N) matrix.
    recycle: ops/gmres.RecycleState for GCRO deflation (slow modes
    projected out, solution corrected through the recycle directions);
    collect_recycle additionally harvests an updated state from this
    solve's Krylov data (returned in .recycle)."""
    r_blobs = kin.blob_positions(system, state)
    if isinstance(m_dense, str) and m_dense == "auto":
        m_dense = saddle.maybe_dense_mobility(system, r_blobs)
    if rhs is None:
        rhs = build_rhs(system, state, r_blobs, slip=slip,
                        force_torque=force_torque, noise_slip=noise_slip,
                        noise_ft=noise_ft, time=time)
    if pc is None:
        pc = saddle.build_block_diag_pc(system, state, time=time)
    operator = saddle.make_linear_operator(system, state, r_blobs,
                                           m_dense=m_dense, time=time)
    tol = system.solver_tolerance if tol is None else tol

    rhs_norm = jnp.linalg.norm(rhs)
    safe_norm = jnp.where(rhs_norm > 0, rhs_norm, 1.0)
    rhs_unit = rhs / safe_norm

    # x0 is in physical units (e.g. a previous solution used as a warm
    # start, mirroring the reference's first_guess,
    # quaternion_integrator_rollers.py:753); rescale into the normalized
    # system actually handed to GMRES
    if x0 is not None:
        x0 = x0 / safe_norm
    rec_new = None
    if recycle is not None:
        from ..ops.gmres import gmres_deflated

        result, rec_new = gmres_deflated(
            operator, rhs_unit, recycle, x0=x0, tol=tol, restart=restart,
            maxiter=maxiter, collect_basis=collect_recycle,
            M=lambda v: saddle.apply_block_diag_pc(system, pc, v))
    else:
        result = gmres(operator, rhs_unit, x0=x0, tol=tol, restart=restart,
                       maxiter=maxiter, verbose=verbose,
                       M=lambda v: saddle.apply_block_diag_pc(system, pc, v))
    sol = result.x * rhs_norm
    lam, U, phi = saddle.split_saddle_vector(system, sol)

    if system.prescribed_body_mask.any():
        mask = jnp.asarray(system.prescribed_body_mask)[:, None]
        U = jnp.where(mask,
                      jnp.asarray(system.prescribed_velocities, dtype=U.dtype),
                      U)
    return MobilitySolution(lam=lam, velocities=U,
                            iterations=result.iterations,
                            residual_norm=result.residual_norm, phi=phi,
                            converged=result.converged, recycle=rec_new)


def solve_mobility_problem_lockstep(
    system: System,
    state: State,
    *,
    rhs,
    pc: Optional[saddle.BlockDiagPC] = None,
    x0=None,
    tol: Optional[float] = None,
    restart: int = 60,
    maxiter: int = 1000,
    m_dense="auto",
    time=0.0,
    recycle=None,
    collect_recycle: bool = False,
) -> MobilitySolution:
    """Solve the saddle system for a STACK of right-hand sides (nrhs, n)
    at ONE configuration, sharing every pair sweep / gridding pass across
    the stack (ops/gmres.gmres_lockstep + saddle.make_lockstep_operator).
    Replaces back-to-back reference solves at the same positions — e.g.
    Slip-Trapz's rigid solve and its RFD solve
    (quaternion_integrator_multi_bodies.py:966-1007). Returns a
    MobilitySolution whose fields carry a leading nrhs axis; `iterations`
    counts BATCHED sweeps (one sweep serves every RHS)."""
    from ..ops.gmres import gmres_lockstep

    r_blobs = kin.blob_positions(system, state)
    if isinstance(m_dense, str) and m_dense == "auto":
        m_dense = saddle.maybe_dense_mobility(system, r_blobs)
    if pc is None:
        pc = saddle.build_block_diag_pc(system, state, time=time)
    operator = saddle.make_lockstep_operator(system, state, r_blobs,
                                             m_dense=m_dense, time=time)
    tol = system.solver_tolerance if tol is None else tol

    rhs = jnp.asarray(rhs)
    rhs_norm = jnp.linalg.norm(rhs, axis=1)
    safe_norm = jnp.where(rhs_norm > 0, rhs_norm, 1.0)
    rhs_unit = rhs / safe_norm[:, None]
    if x0 is not None:
        x0 = x0 / safe_norm[:, None]

    pc_apply = jax.vmap(lambda v: saddle.apply_block_diag_pc(system, pc, v))
    rec_new = None
    if recycle is not None and collect_recycle:
        from ..ops import gmres as gmres_mod

        result, (Vb, Hraw, j_used) = gmres_lockstep(
            operator, rhs_unit, x0=x0, tol=tol, restart=restart,
            maxiter=maxiter, M=pc_apply, recycle=recycle,
            collect_basis=True)
        k = recycle.U.shape[0]
        Bp0 = jnp.zeros((Hraw.shape[1], k), Hraw.dtype)
        rec_new = gmres_mod.harvest_recycle(recycle, Vb, Hraw, Bp0,
                                            j_used, k)
    else:
        result = gmres_lockstep(operator, rhs_unit, x0=x0, tol=tol,
                                restart=restart, maxiter=maxiter,
                                M=pc_apply, recycle=recycle)
    sol = result.x * rhs_norm[:, None]
    lam, U, phi = jax.vmap(
        lambda v: saddle.split_saddle_vector(system, v))(sol)

    if system.prescribed_body_mask.any():
        mask = jnp.asarray(system.prescribed_body_mask)[None, :, None]
        U = jnp.where(mask,
                      jnp.asarray(system.prescribed_velocities,
                                  dtype=U.dtype)[None],
                      U)
    return MobilitySolution(lam=lam, velocities=U,
                            iterations=result.iterations,
                            residual_norm=result.residual_norm, phi=phi,
                            converged=jnp.all(result.converged),
                            recycle=rec_new)


def _single_blob_articulated_pc(system: System, state: State, time=0.0):
    """Per-instance constraint resistance G = pinv(C N0 C^T) with N0 the
    diagonal free-space self grand mobility
    (multi_bodies.py:1008-1108). Returns one (count, 3nc, 3nc) array per
    articulated type."""
    from . import articulated as art_mod

    eta, a = system.eta, system.blob_radius
    f_tt = 1.0 / (6.0 * jnp.pi * eta * a)
    f_rr = 1.0 / (8.0 * jnp.pi * eta * a**3)
    Gs = []
    for art in system.articulated:
        C = art_mod.dense_C_per_instance(system, art, state, time)
        n0 = jnp.diag(jnp.asarray([f_tt] * 3 + [f_rr] * 3,
                                  dtype=C.dtype))
        n0_full = jnp.kron(jnp.eye(art.num_bodies, dtype=C.dtype), n0)
        cnct = jnp.einsum("kij,jl,kml->kim", C, n0_full, C)
        Gs.append(jnp.linalg.pinv(cnct))
    return Gs


def solve_mobility_problem_single_blob(
    system: System,
    state: State,
    *,
    tol=None,
    restart: int = 60,
    maxiter: int = 1000,
    time=0.0,
    verbose: bool = False,
) -> MobilitySolution:
    """Constrained mobility solve for articulated SINGLE-BLOB bodies (the
    rollers articulated path, quaternion_integrator_rollers.py:1455-1576).

    Single blobs have no torque arm, so the blob-level saddle operator
    loses the rotational coupling; instead the solve uses the full 6N
    grand mobility directly. Unknowns x = (phi, U):

        U + M_grand C^T phi = M_grand F_ext
        C U                 = B

    preconditioned by the per-instance constraint resistance
    G = pinv(C N0 C^T) with N0 the diagonal self mobility."""
    from ..ops import mobility as mob_ops
    from . import articulated as art_mod

    dtype = state.pos.dtype
    r = state.pos  # single-blob bodies: blob == body center
    nb = system.num_bodies
    nc3 = 3 * art_mod.num_constraints(system)
    eta, a = system.eta, system.blob_radius
    mob_kw = system.mobility_kwargs
    offs = art_mod.constraint_offsets(system)

    ft = force_torque_calculator(system, state, r)  # (B,6)
    u_unc, w_unc = mob_ops.grand_mobility_matvec(
        r, ft[:, 0:3], ft[:, 3:6], eta, a, **mob_kw)
    U_unc = jnp.concatenate([u_unc, w_unc], axis=1)
    B = art_mod.constraint_rhs(system, state, time)  # (nc,3)
    rhs = jnp.concatenate([U_unc.ravel(), B.ravel()])

    def operator(vec):
        phi = vec[:nc3].reshape(-1, 3)
        U = vec[nc3:].reshape(nb, 6)
        Fc = art_mod.CT_mul(system, state, phi, time)  # (B,6)
        mu, mw = mob_ops.grand_mobility_matvec(
            r, Fc[:, 0:3], Fc[:, 3:6], eta, a, **mob_kw)
        res_U = jnp.concatenate([mu, mw], axis=1) + U
        res_C = art_mod.C_mul(system, state, U, time)
        return jnp.concatenate([res_U.ravel(), res_C.ravel()])

    Gs = _single_blob_articulated_pc(system, state, time)
    f_tt = 1.0 / (6.0 * jnp.pi * eta * a)
    f_rr = 1.0 / (8.0 * jnp.pi * eta * a**3)
    m0 = jnp.asarray([f_tt] * 3 + [f_rr] * 3, dtype=dtype)

    def pc(vec):
        rU = vec[:6 * nb].reshape(nb, 6)
        rB = vec[6 * nb:].reshape(-1, 3)
        CU = art_mod.C_mul(system, state, rU, time) - rB  # (nc,3)
        phi_parts = []
        for ia, art in enumerate(system.articulated):
            blk = CU[offs[ia]:offs[ia + 1]].reshape(art.count, -1)
            phi_parts.append(
                jnp.einsum("kij,kj->ki", Gs[ia], blk).reshape(-1, 3))
        phi = (jnp.concatenate(phi_parts, axis=0) if phi_parts
               else jnp.zeros((0, 3), dtype=dtype))
        Fc = art_mod.CT_mul(system, state, phi, time)
        U = rU - m0[None, :] * Fc
        return jnp.concatenate([phi.ravel(), U.ravel()])

    tol = system.solver_tolerance if tol is None else tol
    rhs_norm = jnp.linalg.norm(rhs)
    safe_norm = jnp.where(rhs_norm > 0, rhs_norm, 1.0)
    result = gmres(operator, rhs / safe_norm, tol=tol, restart=restart,
                   verbose=verbose,
                   maxiter=maxiter, M=pc)
    sol = result.x * rhs_norm
    phi = sol[:nc3].reshape(-1, 3)
    U = sol[nc3:].reshape(nb, 6)
    return MobilitySolution(lam=jnp.zeros((nb, 3), dtype=dtype),
                            velocities=U, iterations=result.iterations,
                            residual_norm=result.residual_norm, phi=phi,
                            converged=result.converged)


# ---------------------------------------------------------------------------
# Dense-algebra solves (small systems / utilities CLI)
# ---------------------------------------------------------------------------


def dense_blob_mobility(system: System, state: State):
    r_blobs = kin.blob_positions(system, state)
    if system.has_mixed_radii:
        return mob.dense_mobility_radii(
            r_blobs, jnp.asarray(system.blob_radii, r_blobs.dtype),
            system.eta, domain=system.domain)
    return mob.dense_mobility(r_blobs, system.eta, system.blob_radius,
                              domain=system.domain, coupling="tt")


def _dense_K(system: System, state: State):
    """Global dense K, (3N, 6B), block diagonal per body. Only used by the
    dense utility solves; products use kin.K_mul / kin.KT_mul."""
    K = jnp.zeros((3 * system.num_blobs, 6 * system.num_bodies),
                  dtype=state.pos.dtype)
    for i, t in enumerate(system.types):
        Kt = kin.K_dense(system, state, i)  # (c, 3nb, 6)
        b0 = system.body_offsets[i]
        n0 = system.blob_offsets[i]
        for c in range(t.count):
            K = jax.lax.dynamic_update_slice(
                K, Kt[c], (3 * (n0 + c * t.num_blobs), 6 * (b0 + c)))
    return K


def solve_body_mobility(system: System, state: State):
    """6Bx6B body mobility N = pinv(K^T M^{-1} K)
    (multi_bodies_utilities.py:583-614, body/body.py:194-205)."""
    M = dense_blob_mobility(system, state)
    K = _dense_K(system, state)
    MinvK = jnp.linalg.solve(M, K)
    return jnp.linalg.pinv(K.T @ MinvK)


def solve_mobility_problem_dense(system: System, state: State, slip=None,
                                 force_torque=None):
    """Dense-algebra mobility solve: returns (velocities (B,6),
    body mobility N (6B,6B))
    (quaternion_integrator_multi_bodies.py:1550-1589)."""
    dtype = state.pos.dtype
    r_blobs = kin.blob_positions(system, state)
    if slip is None:
        slip = kin.active_slip(system, state, dtype)
    if force_torque is None:
        force_torque = force_torque_calculator(system, state, r_blobs)
    M = dense_blob_mobility(system, state)
    K = _dense_K(system, state)
    Minv_slip = jnp.linalg.solve(M, slip.ravel())
    FT = force_torque.ravel() - K.T @ Minv_slip
    MinvK = jnp.linalg.solve(M, K)
    N = jnp.linalg.pinv(K.T @ MinvK)
    return (N @ FT).reshape(system.num_bodies, 6), N


def solve_resistance(system: System, state: State, velocities, slip=None):
    """Resistance problem: F = K^T M^{-1} (K U + slip)
    (multi_bodies_utilities.py:550-574). Returns (B,6) force-torques."""
    dtype = state.pos.dtype
    if slip is None:
        slip = kin.active_slip(system, state, dtype)
    M = dense_blob_mobility(system, state)
    KU = kin.K_mul(system, state, velocities.reshape(-1, 6))
    rhs = (KU + slip.reshape(-1, 3)).ravel()
    lam = jnp.linalg.solve(M, rhs)
    return kin.KT_mul(system, state, lam.reshape(-1, 3))


def refresh_recycle(system: System, state: State, rec, *, pc=None,
                    m_dense="auto", time=0.0):
    """Re-biorthonormalize a RecycleState at this configuration with ONE
    batched lockstep sweep (the k columns share the engine's pair and
    gridding work). See ops/gmres.refresh_recycle."""
    from ..ops import gmres as gmres_mod

    r_blobs = kin.blob_positions(system, state)
    if isinstance(m_dense, str) and m_dense == "auto":
        m_dense = saddle.maybe_dense_mobility(system, r_blobs)
    if pc is None:
        pc = saddle.build_block_diag_pc(system, state, time=time)
    operator = saddle.make_lockstep_operator(system, state, r_blobs,
                                             m_dense=m_dense, time=time)
    pc_apply = jax.vmap(lambda v: saddle.apply_block_diag_pc(system, pc, v))
    return gmres_mod.refresh_recycle(lambda Y: operator(pc_apply(Y)), rec)
