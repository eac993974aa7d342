"""Microbenchmark the wall-spectral engine pieces on the attached device.

Times plan build/refresh, near_matvec, wave_matvec, the full matvec and
its multi-RHS variant at the bench geometry (12-blob shells in a 2-layer
slab above the wall), f32.

Usage: python tools/wall_microbench.py [n_bodies] [n_rhs]
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rigidmultiblobswall_tpu.models import kinematics, saddle
from rigidmultiblobswall_tpu.models.system import BodyType, System, make_state
from rigidmultiblobswall_tpu.ops import ewald_wall  # noqa: E402


def _force(out):
    jax.block_until_ready(out)


def timeit(fn, *args, n=5, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    _force(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    _force(out)
    return (time.perf_counter() - t0) / n * 1e3


def shell_vertices(n=12, radius=0.5):
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return radius * np.stack([np.cos(theta) * np.sin(phi),
                              np.sin(theta) * np.sin(phi),
                              np.cos(phi)], axis=1)


def main():
    n_bodies = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    n_rhs = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    t = BodyType(name="shell12", ref_config=shell_vertices(), count=n_bodies)
    n_layers = 2
    side = int(np.ceil((n_bodies / n_layers) ** 0.5))
    L = side * 1.6
    system = System(
        types=(t,), eta=1.0, blob_radius=0.131, kT=0.05, g=0.1,
        domain="single_wall_spectral", periodic_length=(L, L, 0.0),
        spectral_tol=float(os.environ.get("BENCH_SPECTRAL_TOL", 1e-4)),
        spectral_grid_max=int(os.environ.get("BENCH_GRID_MAX", 512)))
    idx = np.arange(n_bodies)
    pos = np.stack([
        (idx % side) * 1.6, ((idx // side) % side) * 1.6,
        0.8 + (idx // (side * side)) * 1.2], axis=1).astype(np.float32)
    rng = np.random.default_rng(0)
    pos[:, :2] += rng.uniform(-0.25, 0.25, (n_bodies, 2)).astype(np.float32)
    quat = rng.normal(size=(n_bodies, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    state = make_state(pos, quat)
    system = saddle.auto_spectral_capacities(
        system, state, log=lambda m: print(m, file=sys.stderr))
    r = kinematics.blob_positions(system, state).astype(jnp.float32)
    n = r.shape[0]
    params = saddle.spectral_params(system)
    print(f"n_blobs={n} grid={params.grid} r_cut={params.r_cut:.3f} "
          f"support={params.support}")

    make = jax.jit(lambda rr: ewald_wall.make_wall_plan(params, rr))
    plan = make(r)
    _force(plan.pos_all)
    print(f"plan build        {timeit(make, r, n=3):9.1f} ms")
    upd = jax.jit(lambda pl, rr: ewald_wall.update_wall_plan(pl, rr))
    print(f"plan refresh      {timeit(upd, plan, r, n=3):9.1f} ms")

    f = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    fm = jnp.asarray(rng.normal(size=(n, 3 * n_rhs)), jnp.float32)
    near = jax.jit(lambda pl, ff: ewald_wall.near_matvec(pl, ff))
    wave = jax.jit(lambda pl, ff: ewald_wall.wave_matvec(pl, ff))
    full = jax.jit(lambda pl, ff: ewald_wall.matvec(pl, ff))
    print(f"near_matvec  1rhs {timeit(near, plan, f):9.1f} ms")
    print(f"wave_matvec  1rhs {timeit(wave, plan, f):9.1f} ms")
    print(f"full matvec  1rhs {timeit(full, plan, f):9.1f} ms")
    print(f"near_matvec {n_rhs}rhs {timeit(near, plan, fm):9.1f} ms")
    print(f"wave_matvec {n_rhs}rhs {timeit(wave, plan, fm):9.1f} ms")
    print(f"full matvec {n_rhs}rhs {timeit(full, plan, fm):9.1f} ms")
    print(f"polish modes: {plan.polish_idx.shape[0]}")


if __name__ == "__main__":
    main()
