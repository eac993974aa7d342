"""rigidmultiblobswall_tpu: rigid multiblob Stokesian/Brownian dynamics in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of
BCAM-CFD/RigidMultiblobsWall (see /root/reference): suspensions of rigid
bodies discretized as rigidly-connected spheres ("blobs") in Stokes flow,
optionally above a single no-slip wall, with deterministic and stochastic
(Brownian) temporal integrators, articulated bodies, active slip, rollers
and lubrication corrections.

Design (accelerator-first, not a port):
  - functional core: pytree state {positions (B,3), quaternions (B,4)},
    pure step functions, `lax.scan` over time, explicit PRNG keys.
  - one XLA/Pallas implementation of every pairwise kernel replaces the
    reference's four backends (python/numba/C++/pycuda).
  - saddle-point mobility solves run fully in-XLA: matrix-free operator,
    batched per-body block-diagonal preconditioner, restarted GMRES and
    Lanczos M^{1/2}z as `lax.while_loop`s.
  - multi-device scaling via `jax.sharding.Mesh` + `shard_map` row-block
    decomposition of the O(N^2) pairwise products (see `parallel/`).
"""

__version__ = "0.1.0"


def enable_x64():
    """Enable float64 globally (useful for 1e-10 parity checks vs CPU)."""
    import jax

    jax.config.update("jax_enable_x64", True)
