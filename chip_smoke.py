#!/usr/bin/env python
"""Smoke test of the Brownian step on CUDA GPUs, through the library API.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: the sharded paths only

One card, in order:
  1. device     — JAX must see a GPU; prints device_kind, count, the JAX
                  version and nvidia-smi's name and power limit.
  2. kernels    — every hand-written kernel compiled at real width and
                  compared with the plain reference in float64 on the
                  card, with the kernel's and XLA's times (median of
                  chained calls, compile excluded).
  3. spectral   — bench.py's default cell: 98,304 blobs, triply periodic,
                  stochastic_Slip_Trapz, f32.
  4. multibody  — the wall-bounded direct engine at 49,152 blobs, and one
                  mobility solve at 1,024 bodies, f32 against f64.
  5. rollers (32,768), lubrication (4,096 spheres) and spectral_wall
     (2,048 bodies, cut from bench.py's 8,192 to bound compile time).

With --chips 4: the sharded spectral step (98,304 blobs) and the
row-sharded direct wall step (12,288 blobs), each against its
single-device twin in the same process.

Every check raises on failure, so any failed phase exits nonzero; no
phase catches its own failure. The last line of stdout is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CARD = "nvidia-smi: not read yet"


def say(msg):
    print(msg, flush=True)


def check(name, value, limit, note=""):
    """Print `name: value <= limit` beside the card; raise when it fails
    (NaN fails)."""
    ok = bool(value <= limit)
    say(f"  check {name}: {value:.3e} <= {limit:.1e} "
        f"{'ok' if ok else 'FAILED'}{note} | {CARD}")
    if not ok:
        raise AssertionError(f"{name}: {value} > {limit}")


def require(name, cond, detail=""):
    say(f"  check {name}: {'ok' if cond else 'FAILED'} {detail} | {CARD}")
    if not cond:
        raise AssertionError(f"{name} failed {detail}")


def peak_gb():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def rel_max(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def time_chain(fn, x, *args, reps=3, trials=5):
    """Median per-call ms of `reps` chained calls x -> fn(x, *args)
    (rescaled to unit max so the chain stays bounded), compile excluded.
    Large operands (plans) go in `args`, so they are arguments of the
    compiled chain and never constants baked into it."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def chain(x, args):
        def body(_, x):
            y = fn(x, *args)
            return y / (jnp.max(jnp.abs(y)) + 1e-30)

        return lax.fori_loop(0, reps, body, x)

    jax.block_until_ready(chain(x, args))
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x, args))
        times.append((time.perf_counter() - t0) / reps * 1e3)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device(n_chips):
    global CARD
    import jax

    devs = jax.devices()
    say(f"== device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a CUDA GPU; JAX found "
                         f"{devs[0].platform!r}")
    if len(devs) < n_chips:
        raise SystemExit(f"--chips {n_chips}: JAX sees {len(devs)} devices")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = out.stdout.strip().splitlines()
    say(lines[0])
    CARD = lines[0].strip()
    return devs


# ---------------------------------------------------------------------------
# 2. kernels
# ---------------------------------------------------------------------------


def pair_kernel_checks(n_bodies=4096, n_rollers=32768):
    """Pair kernel tt/tr/rt/rr on both wall domains, `grand`, and a 2-RHS
    tt, against the tiled XLA engine in f64 on the card."""
    import jax
    import jax.numpy as jnp

    import bench
    from rigidmultiblobswall_tpu.models import kinematics as kin
    from rigidmultiblobswall_tpu.ops import mobility as mob

    system, state = bench.build("multibody", n_bodies)
    r = kin.blob_positions(system, state)
    n = r.shape[0]
    eta, a = system.eta, system.blob_radius
    v = jnp.asarray(np.random.default_rng(1).normal(size=(n, 3)),
                    jnp.float32)
    say(f"-- pair kernel at {n} blobs")
    for domain in ("single_wall", "no_wall"):
        for coupling in ("tt", "tr", "rt", "rr"):
            kw = dict(coupling=coupling, domain=domain)

            def kern(x, kw=kw):
                return mob.pairwise_matvec(r, r, x, eta, a, method="pallas",
                                           **kw)

            def xla(x, kw=kw):
                return mob.pairwise_matvec(r, r, x, eta, a,
                                           method="generic", **kw)

            got = jax.jit(kern)(v)
            with jax.enable_x64(True):
                ref = jax.jit(lambda r64, v64, kw=kw: mob.pairwise_matvec(
                    r64, r64, v64, eta, a, method="generic", **kw))(
                    np.asarray(r, np.float64), np.asarray(v, np.float64))
                ref = np.asarray(ref)
            t_k = time_chain(kern, v)
            t_x = time_chain(xla, v)
            note = f" kernel {t_k:.3f} ms, XLA tiled {t_x:.3f} ms"
            if coupling == "tt":
                t_s = time_chain(lambda x, kw=kw: mob.pairwise_matvec(
                    r, r, x, eta, a, method="sfm", **kw), v)
                note += f", XLA SFM {t_s:.3f} ms"
            check(f"pair {coupling} {domain} rel L2", rel_l2(got, ref),
                  2e-5, note)

    # 2-RHS tt: one geometry sweep shared by both right-hand sides
    V = jnp.stack([v, -0.5 * v + 0.1])
    kw = dict(coupling="tt", domain="single_wall")
    got = jax.jit(lambda x: mob.pairwise_matvec_multi(
        r, r, x, eta, a, method="pallas", **kw))(V)
    with jax.enable_x64(True):
        ref = np.stack([np.asarray(jax.jit(lambda r64, v64: mob.pairwise_matvec(
            r64, r64, v64, eta, a, method="generic", **kw))(
            np.asarray(r, np.float64), np.asarray(V[b], np.float64)))
            for b in range(2)])
    t_k = time_chain(lambda x: mob.pairwise_matvec_multi(
        r, r, x, eta, a, method="pallas", **kw), V)
    t_x = time_chain(lambda x: mob.pairwise_matvec_multi(
        r, r, x, eta, a, method="generic", **kw), V)
    check("pair tt 2-RHS rel L2", rel_l2(got, ref), 2e-5,
          f" kernel {t_k:.3f} ms, XLA tiled {t_x:.3f} ms")

    # grand (U, W) = M (F, T) at the rollers' width
    sus, r0, _ = bench.build_rollers(n_rollers)
    rng = np.random.default_rng(2)
    FT = jnp.asarray(rng.normal(size=(r0.shape[0], 6)), jnp.float32)
    ra = sus.blob_radius

    def grand(x, method):
        u, w = mob.grand_mobility_matvec(r0, x[:, :3], x[:, 3:], sus.eta,
                                         ra, domain="single_wall",
                                         method=method)
        return jnp.concatenate([u, w], axis=1)

    got = jax.jit(functools.partial(grand, method="pallas"))(FT)
    with jax.enable_x64(True):
        ref = np.asarray(jax.jit(lambda r64, x64: jnp.concatenate(
            mob.grand_mobility_matvec(r64, x64[:, :3], x64[:, 3:], sus.eta,
                                      ra, domain="single_wall",
                                      method="generic"), axis=1))(
            np.asarray(r0, np.float64), np.asarray(FT, np.float64)))
    t_k = time_chain(functools.partial(grand, method="pallas"), FT)
    t_x = time_chain(functools.partial(grand, method="generic"), FT)
    check(f"pair grand {r0.shape[0]} rollers rel L2", rel_l2(got, ref),
          2e-5, f" kernel {t_k:.3f} ms, XLA tiled {t_x:.3f} ms")


def near_rows_layout_jnp(plan, forces, tile=16):
    """The near-field kernel's arithmetic as plain jnp over the same
    pre-gathered (cell, S) layout — XLA's own version of the kernel, for
    the timing comparison."""
    import jax.numpy as jnp
    from jax import lax

    from rigidmultiblobswall_tpu.ops import ewald

    p = plan.params
    cap = p.cell_capacity
    C, S = plan.src_ids.shape
    n = plan.positions.shape[0]
    f = forces.reshape(n, -1)
    nc = f.shape[1]
    f_pad = jnp.concatenate([f, jnp.zeros((1, nc), f.dtype)], axis=0)
    Cp = -(-C // tile) * tile
    tgt = jnp.pad(plan.tgt_xyz.reshape(C, cap, 3),
                  ((0, Cp - C), (0, 0), (0, 0)), constant_values=np.nan)
    src = jnp.pad(plan.src_pos, ((0, 0), (0, Cp - C), (0, 0)),
                  constant_values=np.nan)
    ids = jnp.pad(plan.src_ids, ((0, Cp - C), (0, 0)), constant_values=n)
    two_a = 2.0 * p.a
    mids = (0.5 * two_a, 0.5 * (two_a + p.r_cut))
    halfs = (0.5 * two_a, 0.5 * (p.r_cut - two_a))
    rc2 = p.r_cut * p.r_cut

    def tile_fn(c0):
        t = lax.dynamic_slice_in_dim(tgt, c0, tile, 0)
        s = lax.dynamic_slice_in_dim(src, c0, tile, 1)
        fs = f_pad[lax.dynamic_slice_in_dim(ids, c0, tile, 0)]  # (T,S,nc)
        d = [t[:, :, k, None] - s[k][:, None, :] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inside = (r2 < rc2) & (r2 > 0.0)
        r = jnp.sqrt(jnp.where(inside, r2, 1.0))
        near = r < two_a
        t0 = jnp.clip((r - mids[0]) / halfs[0], -1.0, 1.0)
        t1 = jnp.clip((r - mids[1]) / halfs[1], -1.0, 1.0)
        al = jnp.where(near, ewald._clenshaw(plan.cheb[0, 0], t0),
                       ewald._clenshaw(plan.cheb[1, 0], t1))
        be = jnp.where(near, ewald._clenshaw(plan.cheb[0, 1], t0),
                       ewald._clenshaw(plan.cheb[1, 1], t1))
        al = jnp.where(inside, al, 0.0)
        bf = jnp.where(inside, be / (r * r), 0.0)
        d = [jnp.where(inside, dk, 0.0) for dk in d]
        out = []
        for b in range(nc // 3):
            fx, fy, fz = (fs[:, None, :, 3 * b + q] for q in range(3))
            g = bf * (d[0] * fx + d[1] * fy + d[2] * fz)
            out += [jnp.sum(al * fq + g * dq, axis=2)
                    for fq, dq in zip((fx, fy, fz), d)]
        return jnp.stack(out, axis=-1)                   # (T, cap, nc)

    rows = lax.map(tile_fn, jnp.arange(0, Cp, tile))
    return rows.reshape(Cp * cap, nc)[:C * cap]


def spectral_checks(n_bodies=8192):
    """Near kernel on the bench `spectral` plan, the full ewald.matvec
    f32 against f64, and the layout neighbor forces."""
    import jax
    import jax.numpy as jnp

    import bench
    from rigidmultiblobswall_tpu.models import kinematics as kin, saddle
    from rigidmultiblobswall_tpu.ops import ewald, forces as force_ops

    system, state = bench.build("spectral", n_bodies)
    system = bench.size_capacities(system, state, log=say)
    r = kin.blob_positions(system, state)
    n = r.shape[0]
    plan = jax.jit(lambda x: saddle.maybe_dense_mobility(system, x))(r)
    require("near kernel layout built", plan.src_pos is not None)
    p = plan.params
    say(f"-- near field at {n} blobs: cells {plan.cell_dims} cap "
        f"{p.cell_capacity} S {plan.src_ids.shape[1]} grid {p.grid}")
    f = jnp.asarray(np.random.default_rng(3).normal(size=(n, 3)),
                    jnp.float32)
    params64 = dataclasses.replace(p, near_impl="xla")
    with jax.enable_x64(True):
        r64 = np.asarray(plan.positions, np.float64)
        f64 = np.asarray(f, np.float64)
        plan64 = jax.jit(lambda x: ewald.make_plan(params64, x))(r64)
        near_ref = np.asarray(jax.jit(ewald.real_matvec_xla)(plan64, f64))
        full_ref = np.asarray(jax.jit(ewald.matvec)(plan64, f64))

    def kern(x, pl_):
        return ewald.real_matvec_pallas(pl_, x)

    def xla_sweep(x, pl_):
        return ewald.real_matvec_xla(pl_, x)

    def jnp_layout(x, pl_):
        rows = near_rows_layout_jnp(pl_, x)
        return ewald._near_assemble(pl_, rows, x)

    got = jax.jit(kern)(f, plan)
    t_k = time_chain(kern, f, plan)
    t_x = time_chain(xla_sweep, f, plan)
    t_j = time_chain(jnp_layout, f, plan)
    check("near kernel rel max", rel_max(got, near_ref), 5e-5,
          f" kernel {t_k:.3f} ms, XLA lax.map sweep {t_x:.3f} ms, "
          f"XLA jnp over the layout {t_j:.3f} ms")
    check("near jnp-layout rel max",
          rel_max(jax.jit(jnp_layout)(f, plan), near_ref), 5e-5)

    full = jax.jit(ewald.matvec)(plan, f)
    t_m = time_chain(lambda x, pl_: ewald.matvec(pl_, x), f, plan)
    check(f"ewald.matvec f32 (precision {p.precision}) rel max",
          rel_max(full, full_ref), 5e-5, f" matvec {t_m:.3f} ms")
    # the same product with the gridding matmuls at "high" (TF32 on the
    # card): printed, not required — it is why the default is "highest"
    plan_hi = dataclasses.replace(
        plan, params=dataclasses.replace(p, precision="high"))
    err_hi = rel_max(jax.jit(ewald.matvec)(plan_hi, f), full_ref)
    say(f"  info ewald.matvec with precision 'high': rel max {err_hi:.3e} "
        f"(limit 5e-5) | {CARD}")

    # layout neighbor forces against the per-target gather path
    kw = dict(repulsion_strength=system.repulsion_strength,
              debye_length=system.debye_length,
              blob_radius=system.blob_radius,
              periodic_length=system.periodic_length,
              cutoff=system.blob_blob_cutoff,
              grid_dim=system.blob_blob_grid_dim,
              cell_capacity=system.blob_blob_cell_capacity)

    def forces_at(x, layout):
        return force_ops.blob_blob_forces_neighbor_list(x, layout=layout,
                                                        **kw)

    # f32 against f32: wrapping an f32 position into the box rounds it
    # by up to ulp(L)/2, which alone moves an exp(-r/debye) force by
    # ~1e-5 of the maximum; the f64 distance is printed beside it
    got = jax.jit(functools.partial(forces_at, layout=True))(r)
    ref = jax.jit(functools.partial(forces_at, layout=False))(r)
    with jax.enable_x64(True):
        ref64 = np.asarray(jax.jit(functools.partial(
            forces_at, layout=False))(np.asarray(r, np.float64)))
    t_l = time_chain(lambda x: x + 1e-9 * forces_at(x, True), r)
    t_g = time_chain(lambda x: x + 1e-9 * forces_at(x, False), r)
    check("neighbor forces layout vs per-target gather rel max",
          rel_max(got, ref), 1e-5,
          f" (vs f64 {rel_max(got, ref64):.1e}, f32 gather vs f64 "
          f"{rel_max(ref, ref64):.1e}) layout {t_l:.3f} ms, per-target "
          f"gather {t_g:.3f} ms")


def phase_kernels():
    say(f"== kernels | {CARD}")
    pair_kernel_checks()
    spectral_checks()
    say(f"  peak device memory {peak_gb():.2f} GB")


# ---------------------------------------------------------------------------
# 3-5. the Brownian step of each cell
# ---------------------------------------------------------------------------


def run_steps(name, system, state, n_timed=3, mesh=None):
    """First step (compile) + n_timed steps of bench.py's jitted step.
    Returns (final state, ms/step)."""
    import jax
    import jax.numpy as jnp

    import bench
    from rigidmultiblobswall_tpu.models import integrators, kinematics as kin
    from rigidmultiblobswall_tpu.ops import forces as force_ops

    if mesh is not None:
        system = dataclasses.replace(system, mesh=mesh)
    jit_step = bench.make_step(system)
    carry = integrators.init_carry(system, dtype=jnp.float32, state=state)
    t0 = time.perf_counter()
    s, c, aux = jit_step(state, jax.random.PRNGKey(0), carry)
    jax.block_until_ready(s.pos)
    compile_s = time.perf_counter() - t0
    auxes = [aux]
    t0 = time.perf_counter()
    for i in range(n_timed):
        s, c, aux = jit_step(s, jax.random.PRNGKey(i + 1), c)
        auxes.append(aux)
    jax.block_until_ready(s.pos)
    ms = (time.perf_counter() - t0) / max(n_timed, 1) * 1e3
    pos = np.asarray(s.pos)
    det = [int(a.det_iterations) for a in auxes]
    sto = [int(a.stoch_iterations) for a in auxes]
    rej = sum(int(a.rejections) for a in auxes)
    drops = sum(int(a.capacity_overflows) for a in auxes)
    drops += int(jax.jit(lambda st: force_ops.neighbor_list_overflow(
        system, kin.blob_positions(system, st)))(s))
    say(f"  {name}: first step {compile_s:.1f} s (compile included), "
        f"{ms:.1f} ms/step over {n_timed}, det_iters {det}, "
        f"stoch_iters {sto}, rejections {rej}, "
        f"peak {peak_gb():.2f} GB | {CARD}")
    require(f"{name} finite state", bool(np.all(np.isfinite(pos))))
    require(f"{name} det_iters > 0", min(det) > 0, str(det))
    if system.kT > 0:
        require(f"{name} stoch_iters > 0", min(sto) > 0, str(sto))
    require(f"{name} zero dropped particles", drops == 0, f"drops={drops}")
    return s, ms


def phase_spectral(n_bodies=8192):
    import bench

    say(f"== spectral | {CARD}")
    system, state = bench.build("spectral", n_bodies)
    system = bench.size_capacities(system, state, log=say)
    run_steps(f"spectral {system.num_blobs} blobs", system, state)


def phase_multibody(n_bodies=4096, n_solve=1024):
    import jax

    import bench
    from rigidmultiblobswall_tpu.models import solvers
    from rigidmultiblobswall_tpu.models.system import make_state

    say(f"== multibody | {CARD}")
    system, state = bench.build("multibody", n_bodies)
    run_steps(f"multibody {system.num_blobs} blobs", system, state)

    system, state = bench.build("multibody", n_solve)
    v32 = np.asarray(jax.jit(lambda st: solvers.solve_mobility_problem(
        system, st).velocities)(state))
    with jax.enable_x64(True):
        st64 = make_state(np.asarray(state.pos, np.float64),
                          np.asarray(state.quat, np.float64))
        v64 = np.asarray(jax.jit(lambda st: solvers.solve_mobility_problem(
            system, st, tol=1e-10).velocities)(st64))
    check(f"mobility solve {n_solve} bodies f32 vs f64 rel L2",
          rel_l2(v32, v64), 5 * system.solver_tolerance)


def phase_others(n_rollers=32768, n_lub=4096, n_wall=2048):
    import jax

    import bench
    from rigidmultiblobswall_tpu.models import lubrication as lub, rollers

    say(f"== rollers | {CARD}")
    sus, r0, scheme = bench.build_rollers(n_rollers)
    step = jax.jit(rollers.make_stepper(sus, scheme, bench.DT,
                                        max_rejections=3))
    carry = rollers.init_carry(sus, dtype=r0.dtype, positions=r0)
    t0 = time.perf_counter()
    r1, carry, aux = step(r0, jax.random.PRNGKey(0), carry)
    jax.block_until_ready(r1)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r2, _, aux2 = step(r1, jax.random.PRNGKey(1), carry)
    jax.block_until_ready(r2)
    say(f"  rollers {n_rollers}: first step {compile_s:.1f} s, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms/step, det_iters "
        f"{int(aux2.det_iterations)}, stoch_iters "
        f"{int(aux2.stoch_iterations)} | {CARD}")
    require("rollers finite", bool(np.all(np.isfinite(np.asarray(r2)))))
    require("rollers det_iters > 0", int(aux2.det_iterations) > 0)

    say(f"== lubrication | {CARD}")
    sol, ft_calc, pos0, quat0 = bench.build_lubrication(n_lub)
    lstep = jax.jit(lambda p, q, k: lub.step_trapezoidal(
        sol, p, q, k, ft_calc, omega=25.0, cut_torque=0.2))
    t0 = time.perf_counter()
    p1, q1, aux = lstep(pos0, quat0, jax.random.PRNGKey(0))
    jax.block_until_ready(p1)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p2, q2, aux = lstep(p1, q1, jax.random.PRNGKey(1))
    jax.block_until_ready(p2)
    overflow = int(jax.jit(
        lambda p: lub.compute_blocks(sol, p).overflow)(p2))
    say(f"  lubrication {n_lub}: first step {compile_s:.1f} s, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms/step, det_iters "
        f"{int(aux.det_iterations)}, neighbor overflow {overflow} | {CARD}")
    require("lubrication finite", bool(np.all(np.isfinite(np.asarray(p2)))))
    require("lubrication det_iters > 0", int(aux.det_iterations) > 0)
    require("lubrication neighbor overflow 0", overflow == 0)

    say(f"== spectral_wall | {CARD}")
    system, state = bench.build("spectral_wall", n_wall)
    system = bench.size_capacities(system, state, log=say)
    run_steps(f"spectral_wall {system.num_blobs} blobs", system, state,
              n_timed=1)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def parity(sharded, single, label, tol=5e-5):
    a = np.asarray(sharded, np.float64)
    b = np.asarray(single, np.float64)
    rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))
    check(f"{label} sharded vs single-device", rel, tol)


def phase_four(n_chips, n_spectral=8192, n_direct=1024):
    import bench
    from rigidmultiblobswall_tpu.models.system import make_state
    from rigidmultiblobswall_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_chips)
    say(f"== {n_chips} cards: mesh {dict(mesh.shape)} | {CARD}")
    for path, n_bodies in (("spectral", n_spectral),
                           ("multibody", n_direct)):
        system, state = bench.build(path, n_bodies)
        system = bench.size_capacities(system, state, log=say)
        pos = np.asarray(state.pos)
        quat = np.asarray(state.quat)
        out = {}
        for label, m in (("1 card", None), (f"{n_chips} cards", mesh)):
            s, ms = run_steps(f"{path} {system.num_blobs} blobs {label}",
                              system, make_state(pos, quat), mesh=m)
            out[label] = (np.asarray(s.pos), ms)
        (p1, ms1), (pn, msn) = out["1 card"], out[f"{n_chips} cards"]
        parity(pn, p1, f"{path} {system.num_blobs} blobs")
        say(f"  {path}: {ms1:.1f} ms/step on 1 card, {msn:.1f} ms/step on "
            f"{n_chips} | {CARD}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    devs = phase_device(args.chips)
    from rigidmultiblobswall_tpu.utils.cache import enable_compilation_cache

    say(f"compile cache: {enable_compilation_cache()}")
    if args.chips == 1:
        phase_kernels()
        phase_spectral()
        phase_multibody()
        phase_others()
    else:
        phase_four(args.chips)
    say(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
