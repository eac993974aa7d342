"""Time the four grand-mobility block products on the attached device.

Counterpart of the reference's Mobility_Prod_Timing harness
(/root/reference/multi_bodies/examples/Mobility_Prod_Timing/main.py:46-80),
which times Mtt·F, Mtr·T, Mrt·F, Mrr·T with the pycuda wall kernels.
Here each block goes through `ops.mobility.pairwise_matvec` (the fused
pair kernel on the GPU in f32, XLA tiles elsewhere), plus the fused
grand product the reference harness does not have
(velocity_from_force_and_torque-style single sweep).

Usage: python tools/mobility_prod_timing.py [n_blobs] [--domain single_wall]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from rigidmultiblobswall_tpu.ops import mobility as mob  # noqa: E402


def _force(out):
    import jax

    jax.block_until_ready(out)


def timeit(fn, *args, n=5, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    _force(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    _force(out)
    return (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_blobs", nargs="?", type=int, default=98304)
    ap.add_argument("--domain", default="single_wall")
    ap.add_argument("--eta", type=float, default=1.0)
    ap.add_argument("--a", type=float, default=0.26)
    args = ap.parse_args()

    n = args.n_blobs
    rng = np.random.default_rng(0)
    side = max(n ** (1 / 3) * 1.0, 4.0)
    pos = rng.uniform(0, side, size=(n, 3)).astype(np.float32)
    pos[:, 2] += 2 * args.a  # keep blobs above the wall
    F = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    T = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    r = jnp.asarray(pos)

    import jax

    print(f"N={n} domain={args.domain} device={jax.devices()[0].platform}",
          file=sys.stderr)

    def block(coupling, vec):
        return mob.pairwise_matvec(r, r, vec, args.eta, args.a,
                                   coupling=coupling, domain=args.domain)

    jit_block = {c: jax.jit(lambda v, c=c: block(c, v))
                 for c in ("tt", "tr", "rt", "rr")}
    grand = jax.jit(lambda f, t: mob.grand_mobility_matvec(
        r, f, t, args.eta, args.a, domain=args.domain))

    # same report shape as the reference harness (main.py:58-80)
    for label, c, v in (("Mtt_x_F", "tt", F), ("Mtr_x_T", "tr", T),
                        ("Mrt_x_F", "rt", F), ("Mrr_x_T", "rr", T)):
        dt = timeit(jit_block[c], v)
        gpairs = n * n / dt / 1e9
        print(f"time {label}: {dt:.6f} (s)   [{gpairs:.1f} Gpairs/s]")
    dt = timeit(grand, F, T)
    print(f"time grand (fused U,W from F,T): {dt:.6f} (s)   "
          f"[{n * n / dt / 1e9:.1f} Gpairs/s per coupling-equivalent]")


if __name__ == "__main__":
    main()
