"""Where the hand-written GPU kernels apply: one capability check.

The fused Pallas kernels (ops/pair_kernels.py, the near field in
ops/ewald.py) are written for the Triton route and compile for a CUDA
GPU in float32. Every dispatch site asks `use_kernel`:

- impl "auto" takes the kernel where it compiles and XLA elsewhere;
- impl "pallas" takes the kernel, and raises where it cannot compile
  (unless `interpret=True`, which runs it in the Pallas interpreter —
  tests only);
- any other impl takes the XLA path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def kernels_available(dtype) -> bool:
    """True when the Pallas GPU kernels compile here for `dtype`."""
    return (jax.default_backend() == "gpu"
            and jnp.dtype(dtype) == jnp.dtype(jnp.float32))


def require_kernels(dtype, *, interpret=False, what="Pallas kernel"):
    """Raise unless `what` can run: compiled on a GPU in f32, or in the
    Pallas interpreter."""
    if interpret or kernels_available(dtype):
        return
    raise ValueError(
        f"{what} needs a CUDA GPU and float32 (backend "
        f"{jax.default_backend()!r}, dtype {jnp.dtype(dtype).name}); "
        "use the 'auto' or XLA implementation here")


def use_kernel(impl, dtype, *, interpret=False, what="Pallas kernel"):
    """Resolve an implementation choice to kernel (True) or XLA (False)."""
    if impl == "auto":
        return interpret or kernels_available(dtype)
    if impl != "pallas":
        return False
    require_kernels(dtype, interpret=interpret, what=what)
    return True
