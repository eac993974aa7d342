"""Restarted GMRES with right preconditioning, fully in-XLA.

Replaces the reference's scipy wrapper
(/root/reference/general_application_utils.py:514-635): right
preconditioning solves A M(y) = b and returns x = M(y), so convergence is
judged on the true residual. The Arnoldi process runs as a
`lax.while_loop` with Givens-rotation least squares, so the whole solver
jits and differentiates like any other JAX function.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


def _mm(a, b):
    """Matrix product at full f32 precision: Krylov orthogonalisation
    loses basis orthogonality at TF32's three digits."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


class GmresResult(NamedTuple):
    x: jax.Array
    residual_norm: jax.Array
    iterations: jax.Array
    converged: jax.Array


def gmres(
    matvec: Callable,
    b: jax.Array,
    *,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 60,
    maxiter: int = 1000,
    M: Optional[Callable] = None,
    verbose: bool = False,
) -> GmresResult:
    """Solve matvec(x) = b for flat vectors b of static size.

    M applies the preconditioner inverse (an approximation of A^{-1});
    right preconditioning as in the reference default. verbose=True
    prints the per-iteration residual from inside the jitted loop (the
    reference's --print-residual gmres_counter, multi_bodies.py:62-74).
    """
    n = b.shape[0]
    dtype = b.dtype
    if M is None:
        M = lambda v: v
    cold_start = x0 is None
    if cold_start:
        x0 = jnp.zeros_like(b)

    m = int(min(restart, n, maxiter))
    max_cycles = max(1, -(-maxiter // m))

    b_norm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * b_norm, atol)

    def a_tilde(y):
        return matvec(M(y))

    def run_cycle(y, r, rnorm):
        V = jnp.zeros((m + 1, n), dtype).at[0].set(r / jnp.where(rnorm > 0, rnorm, 1.0))
        R = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(rnorm)

        def inner_cond(state):
            j, V, R, cs, sn, g, res = state
            return (j < m) & (res > target)

        def inner_body(state):
            j, V, R, cs, sn, g, res = state
            w = a_tilde(V[j])
            # classical Gram-Schmidt, applied twice for stability
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            h1 = _mm(V, w) * mask
            w = w - _mm(V.T, h1)
            h2 = _mm(V, w) * mask
            w = w - _mm(V.T, h2)
            h = h1 + h2
            wnorm = jnp.linalg.norm(w)
            V = V.at[j + 1].set(jnp.where(wnorm > 0, w / jnp.where(wnorm > 0, wnorm, 1.0), 0.0))
            h = h.at[j + 1].set(wnorm)

            # apply the accumulated Givens rotations to the new column
            def apply_rot(i, hv):
                hi = hv[i]
                hip = hv[i + 1]
                hv = hv.at[i].set(cs[i] * hi + sn[i] * hip)
                return hv.at[i + 1].set(-sn[i] * hi + cs[i] * hip)

            h = lax.fori_loop(0, j, apply_rot, h)

            # new rotation to annihilate h[j+1]
            hj, hjp = h[j], h[j + 1]
            denom = jnp.sqrt(hj * hj + hjp * hjp)
            c = jnp.where(denom > 0, hj / jnp.where(denom > 0, denom, 1.0), 1.0)
            s = jnp.where(denom > 0, hjp / jnp.where(denom > 0, denom, 1.0), 0.0)
            h = h.at[j].set(c * hj + s * hjp).at[j + 1].set(0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            gj = g[j]
            g = g.at[j].set(c * gj).at[j + 1].set(-s * gj)
            # denom == 0: A closed the Krylov space without the residual
            # reaching zero (singular operator) — the identity rotation
            # must NOT zero the estimate, or the outer loop would skip
            # the true-residual check and report a wrong x as converged
            res = jnp.where(denom > 0, jnp.abs(g[j + 1]), res)
            if verbose:
                jax.debug.print("gmres iteration {j}, residual {r}",
                                j=j, r=res)
            R = R.at[:, j].set(h)
            return (j + 1, V, R, cs, sn, g, res)

        state = (jnp.asarray(0), V, R, cs, sn, g, rnorm)
        j, V, R, cs, sn, g, res = lax.while_loop(inner_cond, inner_body, state)

        # triangular solve on the used leading block; unused columns get a
        # unit diagonal so the padded system stays nonsingular
        used = jnp.arange(m) < j
        Rm = R[:m, :m]
        Rm = jnp.where(jnp.eye(m, dtype=bool) & ~used[None, :], 1.0, Rm)
        # a zero USED diagonal = Krylov-space breakdown (singular
        # operator, or an identically-zero RHS in the lockstep analog):
        # unit-diagonal it AND zero its g entry, so that direction
        # contributes y_m = 0 (finite; no 0/0 NaN, no fabricated y_m =
        # g_m). The residual estimate above stays nonzero in the
        # singular case, so the solve reports converged=False
        dz = (jnp.diagonal(Rm) == 0.0)
        Rm = jnp.where(jnp.eye(m, dtype=bool) & dz[None, :], 1.0, Rm)
        gm = jnp.where(used & ~dz, g[:m], 0.0)
        ym = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        y = y + _mm(V[:m].T, ym)
        return y, j, res

    def outer_cond(state):
        y, r, rnorm, iters, cycles = state
        return (cycles < max_cycles) & (rnorm > target)

    # effective RHS of the correction system (skip the A*0 product on a
    # cold start: at scale one pair sweep is the unit of cost)
    r0 = b if cold_start else b - matvec(x0)

    def outer_body(state):
        y, r, rnorm, iters, cycles = state
        y, j, est = run_cycle(y, r, rnorm)

        # When the Givens estimate converged inside the cycle, skip the
        # explicit true-residual product: at scale it is one full pair
        # sweep per solve for a number the estimate already gives to
        # ~1e-6 relative (CGS2 keeps the Arnoldi relation tight; the PC
        # is pinned exactly-linear, see saddle._full_precision). A
        # restart (estimate NOT converged) still recomputes the true
        # residual — restart correctness never rides the estimate.
        def true_resid(_):
            rr = r0 - a_tilde(y)
            return rr, jnp.linalg.norm(rr)

        r, rnorm = lax.cond(est <= target, lambda _: (r, est),
                            true_resid, None)
        return (y, r, rnorm, iters + j, cycles + 1)
    state = (jnp.zeros_like(b), r0, jnp.linalg.norm(r0), jnp.asarray(0), jnp.asarray(0))
    y, r, rnorm, iters, _ = lax.while_loop(outer_cond, outer_body, state)
    x = x0 + M(y)
    return GmresResult(x=x, residual_norm=rnorm, iterations=iters,
                       converged=rnorm <= target)


def gmres_lockstep(
    matvec: Callable,
    b: jax.Array,
    *,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 60,
    maxiter: int = 1000,
    M: Optional[Callable] = None,
    recycle=None,
    collect_basis: bool = False,
) -> GmresResult:
    """Solve matvec(X) = b for a STACK of right-hand sides b of shape
    (nrhs, n), running one independent Arnoldi process per RHS in
    lockstep: each iteration applies the operator to the whole (nrhs, n)
    block in ONE call, so an operator whose pair sweep / gridding cost is
    shared across columns (ops/ewald.matvec_multi, the batched dense
    planes product) amortizes it. The loop runs until EVERY RHS meets its
    own target; already-converged columns keep iterating harmlessly
    (their residual only shrinks further). matvec and M map
    (nrhs, n) -> (nrhs, n).

    This replaces back-to-back reference solves that share a
    configuration — e.g. the Slip-Trapz rigid solve and its RFD solve
    (quaternion_integrator_multi_bodies.py:966-1007) — with one batched
    Krylov loop. Returns per-RHS x/residual/converged; `iterations` is
    the number of BATCHED sweeps executed (the cost-relevant count: one
    sweep serves all columns).

    recycle: a RecycleState used as a WARM START: the initial solution
    projects each RHS onto the recycled slow-mode directions (y0 =
    (C r0) @ U per column) — measured to collapse the remaining Krylov
    work to ~1 iteration on the bench geometry
    (tools/deflation_experiment.py). Because C is refreshed once per
    step while the operator drifts within it, a final true-residual
    sweep is always performed when recycling is active."""
    nrhs, n = b.shape
    dtype = b.dtype
    if M is None:
        M = lambda v: v
    cold_start = x0 is None
    if cold_start:
        x0 = jnp.zeros_like(b)

    m = int(min(restart, n, maxiter))
    max_cycles = max(1, -(-maxiter // m))

    b_norm = jnp.linalg.norm(b, axis=1)
    target = jnp.maximum(tol * b_norm, atol)                   # (nrhs,)

    def a_tilde(Y):
        return matvec(M(Y))

    def run_cycle(y, r, rnorm):
        safe = jnp.where(rnorm > 0, rnorm, 1.0)
        V = jnp.zeros((nrhs, m + 1, n), dtype).at[:, 0].set(r / safe[:, None])
        R = jnp.zeros((nrhs, m + 1, m), dtype)
        # raw (pre-Givens) Hessenberg of COLUMN 0, kept for recycle
        # harvesting (ops/gmres.harvest_recycle)
        Hraw0 = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros((nrhs, m), dtype)
        sn = jnp.zeros((nrhs, m), dtype)
        g = jnp.zeros((nrhs, m + 1), dtype).at[:, 0].set(rnorm)

        def inner_cond(state):
            j, V, R, Hraw0, cs, sn, g, res = state
            return (j < m) & jnp.any(res > target)

        def inner_body(state):
            j, V, R, Hraw0, cs, sn, g, res = state
            w = a_tilde(V[:, j])                               # (nrhs, n)
            # classical Gram-Schmidt, applied twice for stability. The
            # batched contractions MUST run at full f32: at the default
            # precision (TF32 on the GPU) the basis loses orthogonality
            # and the Givens residual estimate silently diverges from
            # the true residual.
            prec = jax.lax.Precision.HIGHEST
            mask = (jnp.arange(m + 1) <= j).astype(dtype)[None]
            h1 = jnp.einsum("bkn,bn->bk", V, w, precision=prec) * mask
            w = w - jnp.einsum("bkn,bk->bn", V, h1, precision=prec)
            h2 = jnp.einsum("bkn,bn->bk", V, w, precision=prec) * mask
            w = w - jnp.einsum("bkn,bk->bn", V, h2, precision=prec)
            h = h1 + h2
            wnorm = jnp.linalg.norm(w, axis=1)                 # (nrhs,)
            wsafe = jnp.where(wnorm > 0, wnorm, 1.0)
            V = V.at[:, j + 1].set(
                jnp.where(wnorm[:, None] > 0, w / wsafe[:, None], 0.0))
            h = h.at[:, j + 1].set(wnorm)
            Hraw0 = Hraw0.at[:, j].set(h[0])

            def apply_rot(i, hv):
                hi = hv[:, i]
                hip = hv[:, i + 1]
                hv = hv.at[:, i].set(cs[:, i] * hi + sn[:, i] * hip)
                return hv.at[:, i + 1].set(-sn[:, i] * hi + cs[:, i] * hip)

            h = lax.fori_loop(0, j, apply_rot, h)

            hj, hjp = h[:, j], h[:, j + 1]
            denom = jnp.sqrt(hj * hj + hjp * hjp)
            dsafe = jnp.where(denom > 0, denom, 1.0)
            c = jnp.where(denom > 0, hj / dsafe, 1.0)
            s = jnp.where(denom > 0, hjp / dsafe, 0.0)
            h = h.at[:, j].set(c * hj + s * hjp).at[:, j + 1].set(0.0)
            cs = cs.at[:, j].set(c)
            sn = sn.at[:, j].set(s)
            gj = g[:, j]
            g = g.at[:, j].set(c * gj).at[:, j + 1].set(-s * gj)
            # per-column: a no-progress rotation (denom == 0; zero RHS
            # column or singular operator) keeps the previous estimate
            # instead of zeroing it (see the single-RHS comment)
            res = jnp.where(denom > 0, jnp.abs(g[:, j + 1]), res)
            R = R.at[:, :, j].set(h)
            return (j + 1, V, R, Hraw0, cs, sn, g, res)

        state = (jnp.asarray(0), V, R, Hraw0, cs, sn, g, rnorm)
        j, V, R, Hraw0, cs, sn, g, res = lax.while_loop(
            inner_cond, inner_body, state)

        used = jnp.arange(m) < j
        Rm = R[:, :m, :m]
        eye = jnp.eye(m, dtype=bool) & ~used[None, :]
        Rm = jnp.where(eye[None], 1.0, Rm)
        # zero USED diagonals happen per-column: an identically-zero RHS
        # column (its whole Arnoldi process is zeros while the healthy
        # columns drive j forward) or a singular operator. Unit-diagonal
        # them AND zero their g entries: the direction contributes
        # y_m = 0 (no 0/0 NaN, no fabricated y_m); a genuinely singular
        # column keeps a nonzero residual estimate and reports
        # converged=False
        dz = jnp.diagonal(Rm, axis1=1, axis2=2) == 0.0   # (nrhs, m)
        Rm = jnp.where(jnp.eye(m, dtype=bool)[None] & dz[:, None, :],
                       1.0, Rm)
        gm = jnp.where(used[None] & ~dz, g[:, :m], 0.0)
        ym = jax.vmap(lambda Ri, gi: jax.scipy.linalg.solve_triangular(
            Ri, gi, lower=False))(Rm, gm)
        y = y + jnp.einsum("bkn,bk->bn", V[:, :m], ym,
                           precision=jax.lax.Precision.HIGHEST)
        return y, j, res, (V[0], Hraw0, j)

    def outer_cond(state):
        rnorm = state[2]
        cycles = state[4]
        return (cycles < max_cycles) & jnp.any(rnorm > target)

    r0 = b if cold_start else b - matvec(x0)
    y_init = jnp.zeros_like(b)
    r_init = r0
    if recycle is not None:
        valid = recycle.valid
        alpha0 = jnp.where(valid, _mm(r0, recycle.C.T),
                           jnp.zeros((nrhs, recycle.C.shape[0]), dtype))
        y_init = _mm(alpha0, recycle.U)
        r_init = r0 - _mm(alpha0, recycle.C)

    def outer_body(state):
        y, r, rnorm, iters, cycles, _ = state
        y, j, est, basis = run_cycle(y, r, rnorm)

        # skip the explicit true-residual sweep when every column's
        # Givens estimate converged (see the single-RHS comment) —
        # unless recycling warm-started the solve (C is only refreshed
        # once per step; the estimate cannot see its drift error)
        def true_resid(_):
            rr = r0 - a_tilde(y)
            return rr, jnp.linalg.norm(rr, axis=1)

        if recycle is None:
            r, rnorm = lax.cond(jnp.all(est <= target),
                                lambda _: (r, est), true_resid, None)
        else:
            r, rnorm = true_resid(None)
        return (y, r, rnorm, iters + j, cycles + 1, basis)

    basis0 = (jnp.zeros((m + 1, n), dtype), jnp.zeros((m + 1, m), dtype),
              jnp.asarray(0))
    state = (y_init, r_init, jnp.linalg.norm(r_init, axis=1),
             jnp.asarray(0), jnp.asarray(0), basis0)
    y, r, rnorm, iters, _, basis = lax.while_loop(outer_cond, outer_body,
                                                  state)
    if recycle is not None:
        # zero-iteration warm-started exit: the projected estimate
        # cannot see recycle drift — recompute the true residual once
        rnorm = lax.cond(
            iters == 0,
            lambda yv: jnp.linalg.norm(r0 - a_tilde(yv), axis=1),
            lambda yv: rnorm, y)
    x = x0 + M(y)
    result = GmresResult(x=x, residual_norm=rnorm, iterations=iters,
                         converged=rnorm <= target)
    if not collect_basis:
        return result
    return result, basis


# ---------------------------------------------------------------------------
# Krylov subspace recycling (GCRO-style deflation across solves and steps)
# ---------------------------------------------------------------------------


class RecycleState(NamedTuple):
    """Recycled deflation subspace, carried across the solves of a step
    and across steps (with the block-diagonal PC near-optimal, the
    remaining sweep-count lever is deflating the slow modes —
    tools/deflation_experiment.py measures it).

    U: (k, n) directions in the right-preconditioned y-space;
    C: (k, n) orthonormal rows with A~ U ~= C (refreshed once per step
       by ONE batched multi-RHS sweep, refresh_recycle);
    valid: False until the first harvest (solves then run undeflated)."""

    U: jax.Array
    C: jax.Array
    valid: jax.Array

    @staticmethod
    def empty(k, n, dtype=jnp.float32):
        return RecycleState(U=jnp.zeros((k, n), dtype),
                            C=jnp.zeros((k, n), dtype),
                            valid=jnp.asarray(False))


def refresh_recycle(a_tilde_multi, rec: RecycleState) -> RecycleState:
    """Re-biorthonormalize the recycle pair at a (drifted) operator:
    with AU^T = W S Vh (SVD), keep the numerically independent
    directions C_i = W_:,i and U' = U^T Vh^T S^-1 (so A~ U' = C), and
    ZERO the deficient slots — a zero (U, C) row is inert in every
    deflation formula, so partially-filled recycle spaces (harvests
    with fewer candidates than k slots) degrade gracefully instead of
    disabling recycling or amplifying noise through S^-1. One batched
    operator application (a_tilde_multi maps (k, n) -> (k, n); the
    lockstep engines share the pair/gridding sweeps across columns)."""
    AU = a_tilde_multi(rec.U)                    # (k, n)
    W, S, Vh = jnp.linalg.svd(AU.T, full_matrices=False)  # (n,k),(k,),(k,k)
    keep = S > 1e-4 * jnp.maximum(S[0], 1e-30)   # (k,) well-conditioned
    Sinv = jnp.where(keep, 1.0 / jnp.where(keep, S, 1.0), 0.0)
    C = (W * keep[None, :]).T                    # (k, n), zeroed slots
    Unew = _mm(Sinv[:, None] * Vh, rec.U)          # (k, n)
    Unew = Unew * keep[:, None]
    good = rec.valid & jnp.any(keep)
    return RecycleState(U=jnp.where(good, Unew, rec.U),
                        C=jnp.where(good, C, rec.C), valid=good)


def _deflate_setup(rec, r0):
    """Initial GCRO projection: y0 = alpha0 @ U, r = (I - C C^T) r0."""
    alpha0 = jnp.where(rec.valid, _mm(rec.C, r0), jnp.zeros(rec.C.shape[0],
                                                        r0.dtype))
    y0 = _mm(alpha0, rec.U)
    r = r0 - _mm(alpha0, rec.C)
    return y0, r


def gmres_deflated(
    matvec: Callable,
    b: jax.Array,
    rec: RecycleState,
    *,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 60,
    maxiter: int = 1000,
    M: Optional[Callable] = None,
    collect_basis: bool = False,
    harvest_k: int = 0,
):
    """Right-preconditioned GMRES with GCRO deflation through `rec`.

    Same contract as `gmres`, plus: the operator is deflated by
    projecting C out ((I - C C^T) A~), the solution is corrected through
    U, and — because C is refreshed only once per step while the
    operator drifts O(dt) within it — the cycle-end residual is ALWAYS
    the explicitly recomputed true residual (the Givens estimate cannot
    see the deflation inexactness). With collect_basis, also returns a
    new RecycleState harvested from the union of (U, Krylov basis) via
    an SVD of the assembled small matrix (accelerator-friendly; no nonsymmetric
    eigensolve)."""
    n = b.shape[0]
    dtype = b.dtype
    if M is None:
        M = lambda v: v
    cold_start = x0 is None
    if cold_start:
        x0 = jnp.zeros_like(b)
    k = rec.U.shape[0]
    m = int(min(restart, n, maxiter))
    max_cycles = max(1, -(-maxiter // m))
    b_norm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * b_norm, atol)

    def a_tilde(y):
        return matvec(M(y))

    C = jnp.where(rec.valid, rec.C, jnp.zeros_like(rec.C))

    def run_cycle(y, r, rnorm):
        V = jnp.zeros((m + 1, n), dtype).at[0].set(
            r / jnp.where(rnorm > 0, rnorm, 1.0))
        R = jnp.zeros((m + 1, m), dtype)
        Hraw = jnp.zeros((m + 1, m), dtype)
        Bp = jnp.zeros((m, k), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(rnorm)

        def inner_cond(state):
            j = state[0]
            res = state[-1]
            return (j < m) & (res > target)

        def inner_body(state):
            j, V, R, Hraw, Bp, cs, sn, g, res = state
            w = a_tilde(V[j])
            cc = _mm(C, w)                                   # (k,)
            w = w - _mm(cc, C)
            Bp = Bp.at[j].set(cc)
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            h1 = _mm(V, w) * mask
            w = w - _mm(V.T, h1)
            h2 = _mm(V, w) * mask
            w = w - _mm(V.T, h2)
            h = h1 + h2
            wnorm = jnp.linalg.norm(w)
            V = V.at[j + 1].set(
                jnp.where(wnorm > 0, w / jnp.where(wnorm > 0, wnorm, 1.0),
                          0.0))
            h = h.at[j + 1].set(wnorm)
            Hraw = Hraw.at[:, j].set(h)

            def apply_rot(i, hv):
                hi = hv[i]
                hip = hv[i + 1]
                hv = hv.at[i].set(cs[i] * hi + sn[i] * hip)
                return hv.at[i + 1].set(-sn[i] * hi + cs[i] * hip)

            h = lax.fori_loop(0, j, apply_rot, h)
            hj, hjp = h[j], h[j + 1]
            denom = jnp.sqrt(hj * hj + hjp * hjp)
            c = jnp.where(denom > 0, hj / jnp.where(denom > 0, denom, 1.0),
                          1.0)
            s = jnp.where(denom > 0, hjp / jnp.where(denom > 0, denom, 1.0),
                          0.0)
            h = h.at[j].set(c * hj + s * hjp).at[j + 1].set(0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            gj = g[j]
            g = g.at[j].set(c * gj).at[j + 1].set(-s * gj)
            res = jnp.where(denom > 0, jnp.abs(g[j + 1]), res)
            R = R.at[:, j].set(h)
            return (j + 1, V, R, Hraw, Bp, cs, sn, g, res)

        state = (jnp.asarray(0), V, R, Hraw, Bp, cs, sn, g, rnorm)
        j, V, R, Hraw, Bp, cs, sn, g, _res = lax.while_loop(
            inner_cond, inner_body, state)

        used = jnp.arange(m) < j
        Rm = R[:m, :m]
        Rm = jnp.where(jnp.eye(m, dtype=bool) & ~used[None, :], 1.0, Rm)
        dz = (jnp.diagonal(Rm) == 0.0)
        Rm = jnp.where(jnp.eye(m, dtype=bool) & dz[None, :], 1.0, Rm)
        gm = jnp.where(used & ~dz, g[:m], 0.0)
        ym = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        # GCRO correction: kill the C-components the inner solution
        # pushed back in (alpha update through U)
        y = y + _mm(V[:m].T, ym) - _mm(_mm(Bp.T, ym), rec.U)
        return y, j, (V, Hraw, Bp, jnp.asarray(j))

    r0 = b if cold_start else b - matvec(x0)
    y_defl, r_init = _deflate_setup(rec, r0)

    def outer_cond(state):
        y, r, rnorm, iters, cycles, _ = state
        return (cycles < max_cycles) & (rnorm > target)

    def outer_body(state):
        y, r, rnorm, iters, cycles, _ = state
        y, j, basis = run_cycle(y, r, rnorm)
        # deflation inexactness (C refreshed once per step, operator
        # drifts within it): ALWAYS recompute the true residual
        rr = r0 - a_tilde(y)
        return (y, rr, jnp.linalg.norm(rr), iters + j, cycles + 1, basis)

    basis0 = (jnp.zeros((m + 1, n), dtype), jnp.zeros((m + 1, m), dtype),
              jnp.zeros((m, k), dtype), jnp.asarray(0))
    state = (y_defl, r_init, jnp.linalg.norm(r_init), jnp.asarray(0),
             jnp.asarray(0), basis0)
    y, r, rnorm, iters, _, basis = lax.while_loop(outer_cond, outer_body,
                                                  state)
    # if the deflation-projected initial residual already met tol the
    # outer loop never ran and rnorm is the PROJECTED estimate — under
    # operator drift that can misreport convergence. One true-residual
    # sweep keeps the ALWAYS-true-residual contract when the recycle
    # directions did all the work.
    rnorm = lax.cond((iters == 0) & rec.valid,
                     lambda yv: jnp.linalg.norm(r0 - a_tilde(yv)),
                     lambda yv: rnorm, y)
    x = x0 + M(y)
    result = GmresResult(x=x, residual_norm=rnorm, iterations=iters,
                         converged=rnorm <= target)
    if not collect_basis:
        return result, None
    V, Hraw, Bp, j_used = basis
    rec_new = harvest_recycle(rec, V, Hraw, Bp, j_used,
                              harvest_k or k)
    return result, rec_new


def harvest_recycle(rec: RecycleState, V, Hraw, Bp, j_used, k):
    """New recycle directions from the union of the old U and the last
    Krylov cycle: with Q = [V_{m+1}, C^T] orthonormal,
      A~ [U, V_m] = Q G,  G = [[0, Hraw], [I_k, Bp^T]],
    so the smallest right-singular directions of G span the slowest
    modes seen so far. Unused Krylov columns get a large diagonal so the
    SVD never selects them; when rec is invalid (first step) the U block
    is likewise excluded."""
    m = Hraw.shape[1]
    kold = rec.U.shape[0]
    dtype = Hraw.dtype
    used = jnp.arange(m) < j_used
    BIG = jnp.asarray(1e8, dtype)
    # U slots participate only when valid AND non-degenerate (zero rows
    # from partially-filled harvests must not be re-selected as fake
    # "smallest" directions)
    u_live = rec.valid & (jnp.linalg.norm(rec.U, axis=1) > 1e-20)
    G = jnp.zeros((m + 1 + kold, kold + m), dtype)
    G = G.at[m + 1:, :kold].set(jnp.where(u_live, 1.0, BIG)
                                * jnp.eye(kold, dtype=dtype))
    G = G.at[:m + 1, kold:].set(jnp.where(used[None, :], Hraw, 0.0))
    G = G.at[m + 1:, kold:].set(jnp.where(used[:, None], Bp, 0.0).T)
    # exclude unused Krylov columns from the smallest-SV search: each
    # gets BIG on its OWN row (row j for column kold+j — disjoint from
    # the used columns' Hessenberg rows and from the U-block rows;
    # SHARED rows would make excluded columns near-parallel and
    # manufacture spurious tiny singular directions that the harvest
    # would then select)
    G = G.at[jnp.arange(m), kold + jnp.arange(m)].add(
        BIG * (~used).astype(dtype))
    _, svals, Vt = jnp.linalg.svd(G, full_matrices=False)
    Z = Vt[-k:]                                   # (k, kold + m)
    # drop directions the BIG padding leaked into the smallest set
    # (fewer than k genuine candidates): their singular values sit at
    # the BIG scale; zero rows are inert downstream
    genuine = svals[-k:] < 0.5 * BIG
    Z = Z * genuine[:, None]
    Unew = _mm(Z[:, :kold], rec.U) + _mm(Z[:, kold:], V[:m])
    # C is stale until the next refresh_recycle; carry the basis change
    # through valid=True (refresh re-biorthonormalizes at the new
    # operator before any deflated solve uses it)
    return RecycleState(U=Unew, C=rec.C, valid=jnp.asarray(True))
