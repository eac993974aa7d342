#!/usr/bin/env python
"""Tile sweep of the Pallas GPU kernels, on the card.

For the pair kernel (ops/pair_kernels.py) and the spectral near-field
kernel (ops/ewald.py) this compiles every candidate tile shape at the
widths the benchmark cells use, checks it against the XLA version, and
prints the median time of chained calls (compile excluded). The winners
are the defaults in pair_kernels.TILES and EwaldParams.near_rows /
near_chunk.

    python tools/kernel_tiles.py                  # pair 12,288 + 49,152
                                                  # blobs, near 98,304
    python tools/kernel_tiles.py --pair 49152 --near-bodies 8192
"""

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PAIR_TILES = [(16, 32, 4), (32, 32, 4), (32, 16, 4), (16, 16, 2),
              (64, 32, 8)]
NEAR_TILES = [(8, 32), (16, 32), (16, 16), (8, 64)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", type=int, nargs="*", default=[12288, 49152],
                    help="blob counts for the pair kernel")
    ap.add_argument("--near-bodies", type=int, default=8192,
                    help="shells of the spectral cell (12 blobs each)")
    ap.add_argument("--couplings", nargs="*",
                    default=["tt", "rr", "tr", "grand"])
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import bench
    import chip_smoke as cs
    from rigidmultiblobswall_tpu.models import kinematics as kin, saddle
    from rigidmultiblobswall_tpu.ops import ewald, mobility as mob
    from rigidmultiblobswall_tpu.ops import pair_kernels

    cs.phase_device(1)
    for n in args.pair:
        system, state = bench.build("multibody", n // 12)
        q = mob.shift_heights(kin.blob_positions(system, state),
                              system.blob_radius) / system.blob_radius
        rng = np.random.default_rng(0)
        for coupling in args.couplings:
            nin = 6 if coupling == "grand" else 3
            v = jnp.asarray(rng.normal(size=(q.shape[0], nin)), jnp.float32)
            ref = None
            for tiles in PAIR_TILES:
                def fn(x, q, tiles=tiles, coupling=coupling):
                    return pair_kernels.pair_matvec_pallas(
                        q, q, x, coupling=coupling, tiles=tiles)

                out = np.asarray(jax.jit(fn)(v, q))
                ref = out if ref is None else ref
                err = cs.rel_l2(out, ref)
                ms = cs.time_chain(fn, v, q)
                cs.say(f"pair {coupling:5s} N={q.shape[0]:6d} "
                       f"tiles={tiles}: {ms:8.3f} ms (vs first tiles "
                       f"{err:.1e}) | {cs.CARD}")

    system, state = bench.build("spectral", args.near_bodies)
    system = bench.size_capacities(system, state, log=cs.say)
    r = kin.blob_positions(system, state)
    base = jax.jit(lambda x: saddle.maybe_dense_mobility(system, x))(r)
    f = jnp.asarray(np.random.default_rng(1).normal(size=(r.shape[0], 3)),
                    jnp.float32)
    ref = np.asarray(jax.jit(ewald.real_matvec_xla)(base, f))
    t_x = cs.time_chain(lambda x, p: ewald.real_matvec_xla(p, x), f, base)
    cs.say(f"near XLA sweep {t_x:8.3f} ms | {cs.CARD}")
    for rows, chunk in NEAR_TILES:
        params = dataclasses.replace(base.params, near_rows=rows,
                                     near_chunk=chunk, near_impl="pallas")
        plan = jax.jit(lambda x, params=params: ewald.make_plan(params, x))(r)

        def fn(x, p):
            return ewald.real_matvec_pallas(p, x)

        err = cs.rel_max(jax.jit(fn)(f, plan), ref)
        ms = cs.time_chain(fn, f, plan)
        cs.say(f"near rows={rows:3d} chunk={chunk:4d}: "
               f"{ms:8.3f} ms (vs XLA {err:.1e}) | {cs.CARD}")


if __name__ == "__main__":
    main()
