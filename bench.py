#!/usr/bin/env python
"""Benchmark: one full Brownian timestep (stochastic_Slip_Trapz, the
reference's recommended scheme: 3 PC-GMRES rigid solves + 1 Lanczos
M^{1/2}z + 2 mobility products) on the flagship many-body suspension.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

vs_baseline: speedup over the reference's pure python/numpy backend
(numba/pycuda not installed), measured on a CPU host for the same step
composition. A reference Slip-Trapz step needs >= 3 dense wall-mobility
constructions + ~26 matvecs; with the generous best-case arrangement
(build dense once per configuration, reuse for all matvecs of that
configuration) the measured cost at 3072 blobs on that host is 3 x 21.9 s (dense build, mobility/mobility.py:1018) + 26 x 96 ms
(dense matvec) ~= 68.2 s. The O(N^2)/O(N^3)-scaled estimate is used for
other sizes. Override with BENCH_REF_STEP_MS. For the (default) spectral
path the same O(N^2) comparator applies: the reference has no working
spectral backend (its DPStokes/libMobility submodules are empty stubs),
so a reference user pays the pairwise-sweep cost per matvec regardless
of domain. (The repo-level north star is tracked separately in
BASELINE.md.)

Diagnostics, the device (JAX's device_kind and nvidia-smi's name and
power limit) and timings go to stderr; an INVALID run exits nonzero.
"""

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from rigidmultiblobswall_tpu.models import integrators
from rigidmultiblobswall_tpu.models.system import BodyType, System, make_state

# benchmark scale (one device): 8192 12-blob shells = 98,304 blobs —
# the north-star blob count (BASELINE.md) — on the O(N log N) spectral
# Ewald engine (ops/ewald.py). At this size the (3N,3N) mobility cannot
# be materialized (350 GB).
# BENCH_PATH=multibody benchmarks the wall-bounded direct O(N^2) engine
# instead (default 4096 bodies / 49k blobs: the dense matrix would be
# 87 GB; runs matrix-free on the fused pair kernel, ops/pair_kernels.py).
N_BODIES = int(os.environ.get(
    "BENCH_BODIES",
    8192 if os.environ.get("BENCH_PATH", "spectral").startswith("spectral")
    else 4096))
N_BLOBS_PER = 12
DT = 1e-3
SCHEME = os.environ.get("BENCH_SCHEME", "stochastic_Slip_Trapz")
# BENCH_PATH=rollers benchmarks the minimally-resolved microroller path
# (grand-mobility constrained-omega dynamics) instead of the multibody one
BENCH_PATH = os.environ.get("BENCH_PATH", "spectral")
N_ROLLERS = int(os.environ.get("BENCH_ROLLERS", 32768))
# BENCH_PATH=lubrication benchmarks the lubrication-corrected microroller
# suspension (BASELINE config 5: prescribed omega + torque cutoff,
# stochastic trapezoidal; the reference's Uniform_Rollers driver)
N_LUB = int(os.environ.get("BENCH_LUB_BODIES", 4096))
# f32-appropriate defaults; override toward the reference's 1e-8 with
# BENCH_TOL / BENCH_LANCZOS_TOL (f32-vs-f64 parity: chip_smoke.py, PERF.md)
SOLVER_TOL = float(os.environ.get("BENCH_TOL", 2e-4))
LANCZOS_TOL = float(os.environ.get("BENCH_LANCZOS_TOL", 5e-4))


def shell_vertices(n=12, radius=0.5):
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return radius * np.stack([np.cos(theta) * np.sin(phi),
                              np.sin(theta) * np.sin(phi),
                              np.cos(phi)], axis=1)


def build(path="multibody", n_bodies=None):
    """(System, State) of the `path` cell at n_bodies 12-blob shells
    (default: BENCH_BODIES or the path's default)."""
    n = n_bodies or N_BODIES
    t = BodyType(name="shell12", ref_config=shell_vertices(N_BLOBS_PER, 0.5),
                 count=n)
    periodic = path == "spectral"
    if path == "spectral_wall":
        # the reference's flagship geometry: a quasi-2D suspension above
        # the wall (rollers/sedimented layers), two body layers thick, on
        # the O(N log N) doubly-periodic wall engine (ops/ewald_wall.py)
        n_layers = int(os.environ.get("BENCH_WALL_LAYERS", 2))
        side = int(np.ceil((n / n_layers) ** 0.5))
        spacing = 1.6
        L = side * spacing
        system = System(
            types=(t,), eta=1.0, blob_radius=0.131, kT=0.05, g=0.1,
            domain="single_wall_spectral", periodic_length=(L, L, 0.0),
            spectral_tol=float(os.environ.get("BENCH_SPECTRAL_TOL", 1e-4)),
            # xy-grid cap: as in the periodic engine it trades FFT
            # volume against near-field cutoff; 512 keeps the wall grid
            # (512 x 512 x ~100 after z padding) near the periodic
            # engine's 256^3 volume
            spectral_grid_max=int(os.environ.get("BENCH_GRID_MAX", 512)),
            spectral_bucket_capacity=int(
                os.environ.get("BENCH_BUCKET_CAP", 0)),
            repulsion_strength=0.2, debye_length=0.2,
            repulsion_strength_wall=0.2, debye_length_wall=0.2,
            blob_blob_force_method="neighbor_list",
            blob_blob_cutoff=2 * 0.131 + 12 * 0.2,
            blob_blob_grid_dim=32, blob_blob_cell_capacity=96,
            solver_tolerance=SOLVER_TOL,
        )
        idx = np.arange(n)
        # layers close to the wall (microroller-realistic heights, a few
        # blob radii up) — the z grid scales with the slab height, so
        # needlessly tall configurations inflate the FFT volume
        pos = np.stack([
            (idx % side) * spacing,
            ((idx // side) % side) * spacing,
            0.8 + (idx // (side * side)) * 1.2,
        ], axis=1).astype(np.float32)
        rng = np.random.default_rng(0)
        pos[:, :2] += rng.uniform(-0.25, 0.25,
                                  size=(n, 2)).astype(np.float32)
        quat = rng.normal(size=(n, 4)).astype(np.float32)
        quat /= np.linalg.norm(quat, axis=1, keepdims=True)
        return system, make_state(pos, quat)
    side = int(np.ceil(n ** (1 / 3)))
    spacing = 1.6
    if periodic:
        # triply-periodic suspension on the O(N log N) spectral engine
        L = side * spacing
        system = System(
            types=(t,), eta=1.0, blob_radius=0.131, kT=0.05, g=0.0,
            domain="periodic_spectral", periodic_length=(L, L, L),
            spectral_tol=float(os.environ.get("BENCH_SPECTRAL_TOL", 1e-4)),
            # cap the FFT grid (trades wave volume against near-field
            # cutoff): the C=6 lockstep FFT transients grow with the
            # grid volume, not with N
            spectral_grid_max=int(os.environ.get("BENCH_GRID_MAX", 256)),
            # measured-optimal gridding bucket (mean occupancy x4/3 at
            # this density); drops are checked eagerly in main()
            spectral_bucket_capacity=int(
                os.environ.get("BENCH_BUCKET_CAP", 0)),
            repulsion_strength=0.2, debye_length=0.2,
            # O(N) linked-cell pair forces: the direct sweep would cost
            # 27 image boxes x O(N^2) per force evaluation. Cutoff
            # 2a + 12*debye keeps the dropped tail below exp(-12).
            # Capacity is sized from the actual occupancy in main().
            blob_blob_force_method="neighbor_list",
            blob_blob_cutoff=2 * 0.131 + 12 * 0.2,
            blob_blob_grid_dim=32, blob_blob_cell_capacity=96,
            solver_tolerance=SOLVER_TOL,
        )
    else:
        system = System(
            types=(t,), eta=1.0, blob_radius=0.131, kT=0.05, g=0.1,
            domain="single_wall", repulsion_strength_wall=0.2,
            debye_length_wall=0.2, repulsion_strength=0.2, debye_length=0.2,
            # f32-appropriate tolerances (f64 parity is verified in tests/)
            solver_tolerance=SOLVER_TOL,
        )
    # non-overlapping grid (above the wall, or filling the periodic box)
    idx = np.arange(n)
    z0 = 0.8 if periodic else 2.0
    pos = np.stack([
        (idx % side) * spacing,
        ((idx // side) % side) * spacing,
        z0 + (idx // (side * side)) * spacing,
    ], axis=1).astype(np.float32)
    rng = np.random.default_rng(0)
    if periodic:
        # de-align the lattice (a perfect lattice funnels whole body
        # columns into single gridding buckets; real suspensions don't)
        pos += rng.uniform(-0.25, 0.25, size=pos.shape).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return system, make_state(pos, quat)


def device_line():
    """The card's name and power limit as nvidia-smi reports them (one
    line per card), or a note that nvidia-smi is absent."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "nvidia-smi: not available"


def log_device():
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{jax.device_count()} "
          f"| {device_line()}", file=sys.stderr)


def invalid(metric):
    """Print the INVALID record and exit nonzero."""
    print(json.dumps({"metric": metric + "_INVALID", "value": -1,
                      "unit": "ms/step", "vs_baseline": 0.0}))
    sys.exit(1)


def build_rollers(n_rollers=None, mesh=None):
    """(RollerSuspension, r0 (N,3) f32, scheme) of the microroller cell:
    N single-blob bodies rolling above the wall with prescribed angular
    velocity (the reference's recommended
    stochastic_adams_bashforth_rollers, quaternion_integrator_rollers.py:251,
    with the constrained-omega torque solve :905-982)."""
    from rigidmultiblobswall_tpu.models import rollers

    n = n_rollers or N_ROLLERS
    scheme = os.environ.get("BENCH_ROLLER_SCHEME",
                            "stochastic_adams_bashforth_rollers")
    # BENCH_ROLLER_DOMAIN=single_wall_spectral routes the grand products
    # through the O(N log N) wall engine (ops/ewald_wall_rot)
    domain = os.environ.get("BENCH_ROLLER_DOMAIN", "single_wall")
    side = int(np.ceil(n ** 0.5))
    spectral_kw = {}
    if domain == "single_wall_spectral":
        spectral_kw = dict(
            periodic_length=(side * 1.6, side * 1.6, 0.0),
            spectral_wall_height=1.8,
            spectral_tol=float(os.environ.get("BENCH_SPECTRAL_TOL", 1e-4)),
            spectral_grid_max=int(os.environ.get("BENCH_GRID_MAX", 512)))
    sus = rollers.RollerSuspension(
        mesh=mesh,
        num_rollers=n, eta=1.0, blob_radius=0.5, kT=0.05, g=0.2,
        domain=domain, repulsion_strength=0.2, debye_length=0.2,
        repulsion_strength_wall=0.2, debye_length_wall=0.2,
        solver_tolerance=SOLVER_TOL, free_kinematics=False,
        omega_one_roller=(0.0, 10.0, 0.0), lanczos_max_iter=24,
        **spectral_kw)
    idx = np.arange(n)
    rng = np.random.default_rng(0)
    r0 = np.stack([(idx % side) * 1.6, (idx // side) * 1.6,
                   np.full(n, 1.2)], axis=1).astype(np.float32)
    r0[:, :2] += rng.uniform(-0.1, 0.1, size=(n, 2))
    return sus, jnp.asarray(r0), scheme


def bench_rollers():
    from rigidmultiblobswall_tpu.models import rollers

    sus, r0, scheme = build_rollers(mesh=_maybe_mesh())
    domain = sus.domain
    step = rollers.make_stepper(sus, scheme, DT, max_rejections=3)
    carry = rollers.init_carry(sus, dtype=jnp.float32, positions=r0)
    jit_step = jax.jit(step)
    r1, carry1, aux = jit_step(r0, jax.random.PRNGKey(0), carry)
    jax.block_until_ready(r1)
    diag = dict(finite=bool(np.all(np.isfinite(np.asarray(r1)))),
                det_iters=int(aux.det_iterations),
                stoch_iters=int(aux.stoch_iterations),
                rejections=int(aux.rejections))
    print("diagnostics:", diag, file=sys.stderr)
    if not diag["finite"]:
        invalid("roller_step_ms")

    n_iters = 3
    t0 = time.perf_counter()
    r, c = r0, carry
    for i in range(n_iters):
        r, c, aux = jit_step(r, jax.random.PRNGKey(i + 1), c)
    jax.block_until_ready(r)
    elapsed_ms = (time.perf_counter() - t0) / n_iters * 1e3

    # reference comparator (estimate): the same step on the reference's
    # python backend costs (det GMRES iters + Lanczos iters * 4 + 8 RFD/
    # velocity products) O(N^2) pairwise sweeps; per-sweep cost measured
    # at 3072 blobs on a CPU host = 95.8 ms, scaled by (N/3072)^2.
    n_rollers = sus.num_rollers
    n_sweeps = (diag["det_iters"] + 4 * diag["stoch_iters"] + 8)
    ref_ms = float(os.environ.get(
        "BENCH_REF_STEP_MS",
        n_sweeps * 95.8 * (n_rollers / 3072.0) ** 2))
    n_dev = jax.device_count()
    print(json.dumps({
        "metric": (f"roller_step_ms_{scheme}"
                   + ("_spectral" if domain == "single_wall_spectral"
                      else "")
                   + f"_{n_rollers}rollers_{n_dev}chip"),
        "value": round(elapsed_ms, 3),
        "unit": "ms/step",
        "vs_baseline": round(ref_ms / elapsed_ms, 1),
        "baseline_kind": ("env BENCH_REF_STEP_MS" if "BENCH_REF_STEP_MS"
                          in os.environ else
                          "measured@3072blobs,N^2-scaled estimate"),
    }))


def build_lubrication(n_bodies=None, mesh=None):
    """(LubSolver, ft_calc, pos0, quat0) of the lubrication-corrected
    uniform microrollers (BASELINE config 5, the reference's
    Lubrication_Examples/Uniform_Rollers/main_rollers.py): N spheres near
    the wall driven at prescribed omega about y with a torque cutoff."""
    from rigidmultiblobswall_tpu.models import lubrication as lub
    from rigidmultiblobswall_tpu.ops import forces

    n = n_bodies or N_LUB
    # the Uniform_Rollers physical parameters (examples/lubrication_rollers)
    eta, a = 0.957e-3, 1.0
    sol = lub.LubSolver(
        num_bodies=n, eta=eta, a=a, kT=0.0041419464, dt=DT,
        cutoff=4.5, cutoff_wall=4.5, debye_cut=1e-2, rf_delta=1e-3,
        solver_tolerance=SOLVER_TOL, max_neighbors=12, mesh=mesh,
        tables=lub.LubricationTables.load(lub.DEFAULT_TABLE_DIR))

    def ft_calc(pos):
        f = forces.blob_external_forces(
            pos, g=0.0025395, blob_radius=a,
            repulsion_strength_wall=0.0165677856, debye_length_wall=0.1)
        f = f + forces.blob_blob_forces(
            pos, repulsion_strength=0.0165677856, debye_length=0.1,
            blob_radius=a)
        return jnp.concatenate([f, jnp.zeros_like(f)], axis=1)

    side = int(np.ceil(n ** 0.5))
    idx = np.arange(n)
    rng = np.random.default_rng(0)
    pos0 = np.stack([(idx % side) * 2.4 * a, (idx // side) * 2.4 * a,
                     np.full(n, 1.3 * a)], axis=1).astype(np.float32)
    pos0[:, :2] += rng.uniform(-0.05, 0.05, size=(n, 2)) * a
    quat0 = jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (n, 1))
    return sol, ft_calc, jnp.asarray(pos0), quat0


def bench_lubrication():
    """Stochastic trapezoidal step of the lubrication cell — neighbor-list
    sparse Delta_R, R_Sup-preconditioned (I + M dR) GMRES,
    Torque_from_Omega constrained solve, Lanczos matrix roots."""
    from rigidmultiblobswall_tpu.models import lubrication as lub

    sol, ft_calc, pos0, quat0 = build_lubrication()
    n_lub = pos0.shape[0]
    jit_step = jax.jit(lambda p, q, k: lub.step_trapezoidal(
        sol, p, q, k, ft_calc, omega=25.0, cut_torque=0.2))
    p1, q1, aux = jit_step(pos0, quat0, jax.random.PRNGKey(0))
    jax.block_until_ready(p1)
    # neighbor-list capacity check: SparseDeltaR.overflow counts true
    # neighbors dropped past max_neighbors — a denser (user-overridden)
    # config would otherwise silently time a truncated Delta_R
    overflow = int(jax.jit(
        lambda p: lub.compute_blocks(sol, p).overflow)(pos0))
    diag = dict(finite=bool(np.all(np.isfinite(np.asarray(p1)))),
                det_iters=int(aux.det_iterations),
                stoch_iters=int(aux.stoch_iterations),
                rejections=int(aux.rejections_wall) + int(aux.rejections_jump),
                neighbor_overflow=overflow)
    print("diagnostics:", diag, file=sys.stderr)
    if not diag["finite"] or diag["det_iters"] == 0 or overflow > 0:
        invalid("lub_step_ms")

    n_iters = 3
    t0 = time.perf_counter()
    p, q = pos0, quat0
    auxes = []
    for i in range(n_iters):
        p, q, aux = jit_step(p, q, jax.random.PRNGKey(i + 1))
        auxes.append(aux)  # converted after timing: int() would sync per step
    jax.block_until_ready(p)
    elapsed_ms = (time.perf_counter() - t0) / n_iters * 1e3

    # reference comparator (estimate): each (I + M dR) GMRES iteration and
    # each Lanczos iteration costs one O(N^2) grand-mobility sweep on the
    # python backend (4 coupling blocks ~= 4 tt-sweeps of 95.8 ms at 3072
    # blobs on a CPU host), plus the sparse dR assembly (not counted).
    # Iteration counts are the per-step mean over the TIMED steps (the
    # warmup step's counts can differ from the steady state).
    n_sweeps = 4 * sum(int(a.det_iterations) + int(a.stoch_iterations)
                       for a in auxes) / n_iters
    ref_ms = float(os.environ.get(
        "BENCH_REF_STEP_MS", n_sweeps * 95.8 * (n_lub / 3072.0) ** 2))
    print(json.dumps({
        "metric": f"lub_step_ms_trapezoidal_{n_lub}spheres_"
                  f"{jax.device_count()}chip",
        "value": round(elapsed_ms, 3),
        "unit": "ms/step",
        "vs_baseline": round(ref_ms / elapsed_ms, 1),
        "baseline_kind": ("env BENCH_REF_STEP_MS" if "BENCH_REF_STEP_MS"
                          in os.environ else
                          "measured@3072blobs,N^2-scaled estimate"),
    }))


def _maybe_mesh():
    """All attached devices join a 1-D mesh (parallel/mesh.py): the
    spectral engine shards near-field cells + gridding planes and
    distributes the FFT; the direct engines row-shard the pair sweep.
    BENCH_MESH=0 forces single-device; on one device this is a no-op."""
    if os.environ.get("BENCH_MESH", "1") == "0" or jax.device_count() <= 1:
        return None
    from rigidmultiblobswall_tpu.parallel.mesh import make_mesh
    return make_mesh()


def size_capacities(system, state, log=None):
    """Spectral cells: grow the gridding capacity until no particle
    drops, and size the force-cell capacity from the ACTUAL occupancy
    (+25% drift margin) — overflow would silently weaken the far field
    or the repulsion. A no-op for the other engines."""
    from rigidmultiblobswall_tpu.models import kinematics, saddle
    from rigidmultiblobswall_tpu.ops import forces as force_ops

    system = saddle.auto_spectral_capacities(system, state, log=log)
    return force_ops.auto_force_cell_capacity(
        system, kinematics.blob_positions(system, state), log=log)


def make_step(system):
    """The jitted Brownian step of the cell (donating state and carry:
    the carried spectral plan holds GBs, and without donation the timed
    loop keeps three step generations live)."""
    step = integrators.make_stepper(
        system, SCHEME, DT,
        lanczos_tolerance=LANCZOS_TOL, lanczos_max_iter=32,
        lanczos_check_every=4,
        gmres_restart=60, gmres_maxiter=300, max_rejections=3)

    @functools.partial(jax.jit, donate_argnums=(0, 2))
    def jit_step(state, key, carry):
        return step(state, key, carry)

    return jit_step


def main():
    from rigidmultiblobswall_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    log_device()
    if BENCH_PATH == "rollers":
        bench_rollers()
        return
    if BENCH_PATH == "lubrication":
        bench_lubrication()
        return
    system, state = build(BENCH_PATH)
    mesh = _maybe_mesh()
    if mesh is not None:
        import dataclasses
        system = dataclasses.replace(system, mesh=mesh)
        print(f"mesh: {tuple(mesh.shape.items())}", file=sys.stderr)
    n_blobs = system.num_blobs
    system = size_capacities(system, state,
                             log=lambda m: print(m, file=sys.stderr))
    jit_step = make_step(system)
    # state=... seeds the carried cross-step spectral plan (each step then
    # refreshes it instead of re-sorting); no-op for other engines
    carry = integrators.init_carry(system, dtype=jnp.float32, state=state)

    key = jax.random.PRNGKey(0)
    pos0 = np.asarray(state.pos)
    # compile + warm up (donates the initial state/carry)
    state1, carry1, aux = jit_step(state, key, carry)
    jax.block_until_ready(state1.pos)
    # sanity: the step must be real (finite state, solver did work)
    pos1 = np.asarray(state1.pos)
    diag = dict(finite=bool(np.all(np.isfinite(pos1))),
                det_iters=int(aux.det_iterations),
                stoch_iters=int(aux.stoch_iterations),
                rejections=int(aux.rejections),
                max_disp=float(np.abs(pos1 - pos0).max()))
    print("diagnostics:", diag, file=sys.stderr)
    if not diag["finite"] or diag["det_iters"] == 0:
        invalid("brownian_step_ms")

    n_iters = 3
    t0 = time.perf_counter()
    s, c = state1, carry1
    for i in range(n_iters):
        s, c, aux = jit_step(s, jax.random.PRNGKey(i + 1), c)
    jax.block_until_ready(s.pos)
    elapsed_ms = (time.perf_counter() - t0) / n_iters * 1e3

    # measured reference-python-backend step estimate at 3072 blobs on a
    # CPU host (see module docstring); dense build and matvec scale ~N^2
    n_dev = jax.device_count()
    ref_3072_ms = 3 * 21_910.0 + 26 * 95.8
    ref_ms = float(os.environ.get(
        "BENCH_REF_STEP_MS", ref_3072_ms * (n_blobs / 3072.0) ** 2))
    print(json.dumps({
        "metric": (f"brownian_step_ms_{SCHEME}"
                   + {"spectral": "_spectral",
                      "spectral_wall": "_spectral_wall"}.get(BENCH_PATH, "")
                   + f"_{n_blobs}blobs_{n_dev}chip"),
        "value": round(elapsed_ms, 3),
        "unit": "ms/step",
        "vs_baseline": round(ref_ms / elapsed_ms, 1),
        # the comparator is the reference's python backend measured on a
        # CPU host at 3072 blobs and O(N^2)-scaled to this size, not a
        # same-N run
        "baseline_kind": ("env BENCH_REF_STEP_MS" if "BENCH_REF_STEP_MS"
                          in os.environ else
                          "measured@3072blobs,N^2-scaled estimate"),
    }))


if __name__ == "__main__":
    main()
