"""Microbenchmark the spectral Ewald engine pieces on the attached device.

Times plan construction, wave_matvec (spread/FFT/interp), real_matvec
(cell-list near field), and the full matvec at production-like density
(12-blob shells on a grid, ~1% volume fraction), f32.

Usage: python tools/spectral_microbench.py [n_blobs]
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rigidmultiblobswall_tpu.ops import ewald  # noqa: E402


def _force(out):
    jax.block_until_ready(out)


def timeit(fn, *args, n=10, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    _force(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    _force(out)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    n_blobs = int(sys.argv[1]) if len(sys.argv) > 1 else 98304
    a = 0.26
    # bench-like density: bodies on a 1.6-spaced grid, 12 blobs/shell of
    # radius 0.5 -> here just uniform random blobs at equivalent density
    n_bodies = n_blobs // 12
    side = int(np.ceil(n_bodies ** (1 / 3)))
    L = side * 1.6
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, L, size=(n_blobs, 3)).astype(np.float32)
    f = rng.normal(size=(n_blobs, 3)).astype(np.float32)

    p = ewald.default_params(a, 1.0, (L, L, L), tol=1e-4)
    print(f"N={n_blobs} box={L:.1f} grid={p.grid} r_cut={p.r_cut:.2f} "
          f"xi={p.xi:.2f} support={p.support}", file=sys.stderr)

    pos_j = jnp.asarray(pos)
    f_j = jnp.asarray(f)

    # jit-able projections (the plan itself holds static fields)
    def _plan_arrays(x):
        pl = ewald.make_plan(p, x)
        return pl.cell_table, pl.cell_slot, pl.grid_tbl, pl.inv_idx

    make_arrays = jax.jit(_plan_arrays)
    jax.block_until_ready(make_arrays(pos_j))
    t_plan = timeit(make_arrays, pos_j, n=3, warmup=1)
    print(f"plan      {t_plan:8.2f} ms", flush=True)

    import dataclasses as dc

    variants = [] if os.environ.get("BENCH_SKIP_BASE") else [("base", p)]
    for spec in os.environ.get("BENCH_VARIANTS", "").split(";"):
        if not spec:
            continue
        name, *kvs = spec.split(",")
        kw = {}
        for kv in kvs:
            k, v = kv.split("=")
            kw[k] = type(getattr(p, k))(v) if not isinstance(
                getattr(p, k), str) else v
        variants.append((name, dc.replace(p, **kw)))

    for name, pv in variants:
        plan = ewald.make_plan(pv, pos_j)
        print(f"[{name}] cap_seg={plan.cap_seg} dropped={int(plan.n_dropped)} "
              f"prec={pv.precision} support={pv.support}", flush=True)
        # reduce the 200 MB grid output to a scalar: the timing is of
        # the spread, not of materialising its result
        t_spread = timeit(
            jax.jit(lambda pl_, ff: jnp.sum(ewald.spread(pl_, ff))),
            plan, f_j, n=3, warmup=1)
        print(f"[{name}] spread    {t_spread:8.2f} ms", flush=True)
        grid = ewald.spread(plan, f_j)
        t_interp = timeit(jax.jit(ewald.interpolate), plan, grid,
                          n=3, warmup=1)
        print(f"[{name}] interp    {t_interp:8.2f} ms", flush=True)
        def fft_part(pl_, g):
            gk = jnp.fft.rfftn(g, axes=(1, 2, 3))
            uk = ewald.k_scale(pl_, gk)
            return jnp.sum(jnp.fft.irfftn(uk, s=pl_.params.grid,
                                          axes=(1, 2, 3)))

        t_fft = timeit(jax.jit(fft_part), plan, grid, n=3, warmup=1)
        print(f"[{name}] fft+scale {t_fft:8.2f} ms", flush=True)
        t_wave = timeit(jax.jit(ewald.wave_matvec), plan, f_j, n=3, warmup=1)
        print(f"[{name}] wave      {t_wave:8.2f} ms "
              f"(fft+scale ~ {t_wave - t_spread - t_interp:.2f})", flush=True)
        t_real = timeit(jax.jit(ewald.real_matvec), plan, f_j, n=3, warmup=1)
        print(f"[{name}] real      {t_real:8.2f} ms", flush=True)
        print(f"[{name}] est matvec {t_wave + t_real:8.2f} ms; "
              f"est step (45 mv): {45 * (t_wave + t_real):8.1f} ms",
              flush=True)


if __name__ == "__main__":
    main()
