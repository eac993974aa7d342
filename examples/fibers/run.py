#!/usr/bin/env python
"""Free-fiber relaxation + Brownian fluctuation example — the
JAX version of the reference's Many_Free_Fibers.py demo
(reference: cRigid_cFibers/Many_Free_Fibers.py:103-309): a stack of
identical fibers, semi-implicit bending, midpoint stochastic scheme,
end-to-end distances written each save.

Run:  python examples/fibers/run.py [--fibers 10] [--links 10] [--steps 200]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import jax
import jax.numpy as jnp

from rigidmultiblobswall_tpu.models import fibers as fib


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--fibers", type=int, default=10)
    p.add_argument("--links", type=int, default=10)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--save-every", type=int, default=20)
    p.add_argument("--kT", type=float, default=0.004142)
    p.add_argument("--output", default=None)
    args = p.parse_args()

    # same physical setup as the reference demo: fiber length 2, Nlinks
    # links, a = ds/2, persistence length 4 L
    L_fib = 2.0
    ds = L_fib / args.links
    a = ds / 2.0
    k_bend = 4.0 * L_fib * args.kT
    sus = fib.FiberSuspension(
        num_fibers=args.fibers, num_links=args.links, ds=ds, a=a,
        k_bend=k_bend, eta=1.0, kT=args.kT, impl_c=1.0,  # BE like the demo
        hydrodynamics="batched")

    # stacked at z = 0, 5a, 10a, ... pointing along +y
    x0 = np.zeros((args.fibers, 3))
    x0[:, 2] = 5.0 * a * np.arange(args.fibers)
    state = fib.straight_fiber_state(sus, x0, [0.0, 1.0, 0.0])

    m0 = sus.m0
    dt = (ds**3 / m0) / k_bend  # alpha_fact = 1 (the demo's default)
    print(f"fibers={args.fibers} blobs/fiber={sus.num_blobs_per_fiber} "
          f"dt={dt:.3e} kT={args.kT}")

    out = args.output or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "end_to_end_distances.txt")
    state_f, traj, aux = fib.simulate(
        sus, state, jax.random.PRNGKey(0), dt=dt, n_steps=args.steps,
        save_every=args.save_every)
    e2e = jax.vmap(lambda s: fib.end_to_end_distance(sus, s))(traj)
    np.savetxt(out, np.asarray(e2e))
    print(f"mean end-to-end {float(jnp.mean(e2e[-1])):.4f} "
          f"(contour {ds * args.links:.4f}); wrote {out}")


if __name__ == "__main__":
    main()
