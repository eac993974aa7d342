"""Multi-device execution: row-sharded O(N^2) pairwise products over a
flat 1-D device mesh.

The reference has no distributed backend (single process + in-process
GPU/OpenMP; SURVEY.md section 2.4). The equivalent here decomposes the
pair-interaction matrix into row blocks across devices:

  - blob positions and the input vector are replicated (small: O(N)),
  - each device computes its row block of the O(N^2) sweep locally,
  - results are all-gathered back to replicated layout (O(N) over the
    interconnect; NVLink joins the cards of one host all to all, so a
    flat mesh needs no topology mapping).

Body-level work (K products, 6x6 solves, GMRES recurrences) is O(B) and
stays replicated; every device executes it redundantly, which costs less
than communicating it. This keeps GMRES/Lanczos dot products trivially
consistent across devices.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "blobs") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def sharded_rows_apply(mesh: Mesh, axis_name: str, fn, n_rows: int, *args):
    """Run `fn(row_offset, n_local_rows, *args) -> (local_rows, ...)` with
    rows sharded across the mesh; returns the gathered (n_rows_padded, ...)
    array. `fn` must be shape-polymorphic in its first two (static) args.

    All *args are replicated.
    """
    n_dev = mesh.shape[axis_name]
    rows_per = -(-n_rows // n_dev)

    def shard_fn(*a):
        idx = jax.lax.axis_index(axis_name)
        out_local = fn(idx * rows_per, rows_per, *a)
        return jax.lax.all_gather(out_local, axis_name, axis=0, tiled=True)

    specs = tuple(P() for _ in args)
    wrapped = shard_map(shard_fn, mesh=mesh, in_specs=specs, out_specs=P(),
                        check_vma=False)
    return wrapped(*args)
