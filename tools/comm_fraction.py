#!/usr/bin/env python
"""Measure the communication fraction of the sharded spectral matvec
(VERDICT r2 #4c: the round-2 "communication <1%" claim was a projection;
this measures the STRUCTURE of the claim on the 8-virtual-CPU-device
mesh — absolute CPU numbers do not transfer to NVLink, but the byte counts
and the collective/compute ratio scaling with N do).

For each size: time (a) the full sharded matvec, (b) the same collective
operations in isolation (all_gather of the near-field slot rows,
all_gather of the interpolation rows, the two all_to_all FFT
transposes), under jit on the virtual mesh, and report bytes moved and
the isolated-collective share of the full time.

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
          python tools/comm_fraction.py
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec

from rigidmultiblobswall_tpu.ops import ewald
from rigidmultiblobswall_tpu.parallel.mesh import make_mesh


def timeit(fn, *args, reps=5):
    fn(*args)  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    mesh = make_mesh(8)
    D = 8
    for n, L, gmax in ((2304, 16.0, 128), (9216, 25.6, 128),
                       (24576, 33.6, 128)):
        rng = np.random.default_rng(0)
        pos = rng.uniform(0, L, size=(n, 3))
        f = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
        params = ewald.default_params(0.131, 1.0, (L, L, L), tol=1e-4,
                                      grid_max=gmax, near_impl="xla")
        plan = ewald.make_plan(params, jnp.asarray(pos, jnp.float32))
        gx, gy, gz = params.grid
        cap = params.cell_capacity
        n_cells = plan.nbr_cells.shape[0]
        cap_seg = plan.cap_seg
        nzb = gz // params.zslab

        t_full = timeit(jax.jit(
            lambda ff: ewald.matvec(plan, ff, mesh=mesh)), f)

        # isolated collectives at the EXACT shapes the sharded matvec uses
        from jax import shard_map

        near_rows_local = jnp.zeros((n_cells * cap // D, 3), jnp.float32)
        wave_rows_local = jnp.zeros((gx * nzb * cap_seg // D, 3),
                                    jnp.float32)
        fft_local = jnp.zeros((3, gx // D, gy, gz // 2 + 1),
                              jnp.complex64)

        def coll(a, b, c):
            r1 = lax.all_gather(a, "blobs", axis=0, tiled=True)
            r2 = lax.all_gather(b, "blobs", axis=0, tiled=True)
            r3 = lax.all_to_all(c, "blobs", split_axis=2, concat_axis=1,
                                tiled=True)
            r4 = lax.all_to_all(r3, "blobs", split_axis=1, concat_axis=2,
                                tiled=True)
            return r1.sum() + r2.sum() + jnp.abs(r4).sum()

        sm = shard_map(coll, mesh=mesh,
                       in_specs=(PartitionSpec(), PartitionSpec(),
                                 PartitionSpec()),
                       out_specs=PartitionSpec(), check_vma=False)
        t_coll = timeit(jax.jit(sm), near_rows_local, wave_rows_local,
                        fft_local)

        bytes_moved = (near_rows_local.size + wave_rows_local.size) * 4 \
            * (D - 1) + 2 * fft_local.size * 8 * (D - 1) / D
        print(f"n={n:6d} grid={params.grid}: full sharded matvec "
              f"{t_full * 1e3:8.1f} ms; isolated collectives "
              f"{t_coll * 1e3:8.1f} ms ({100 * t_coll / t_full:5.1f}%); "
              f"~{bytes_moved / 1e6:.1f} MB/device-hop", flush=True)


if __name__ == "__main__":
    main()
