"""Matrix-free square-root action M^{1/2} z via the Lanczos algorithm.

Krylov method of Ando et al. (J. Chem. Phys. 137, 064106, 2012) with full
Gram-Schmidt reorthogonalization, convergence on the relative change of
successive noise iterates, and an optional preconditioner L with
M ~= L L^T applied to the output — matching the reference semantics
(/root/reference/stochastic_forcing/stochastic_forcing.py:112-264) as a
bounded `lax.while_loop` with identity-padded tridiagonal eigenproblems.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


def _mm(a, b):
    """Matrix product at full f32 precision: Krylov orthogonalisation
    loses basis orthogonality at TF32's three digits."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


class LanczosResult(NamedTuple):
    noise: jax.Array
    iterations: jax.Array
    converged: jax.Array


def stochastic_forcing_lanczos(
    mobility_mult: Callable,
    z: jax.Array,
    *,
    factor=1.0,
    tolerance: float = 1e-6,
    max_iter: int = 64,
    L_mult: Optional[Callable] = None,
    check_every: int = 1,
) -> LanczosResult:
    """Return factor * M^{1/2} z (flat vector of static size).

    mobility_mult: v -> M v for the SPD operator M.
    L_mult: optional map applied to the result (preconditioned variant:
        the Lanczos runs on P M P^T and the caller supplies L = P^{-1}).
    check_every: evaluate the noise (a small, serial eigh) and test
        convergence only every k-th iteration (k=1 matches the reference
        cadence; larger k trades a few extra matvecs for fewer eighs).
    """
    n = z.shape[0]
    dtype = z.dtype
    m = int(max_iter)

    v_norm = jnp.linalg.norm(z)
    safe_v_norm = jnp.where(v_norm > 0, v_norm, 1.0)

    V0 = jnp.zeros((m + 1, n), dtype).at[0].set(z / safe_v_norm)
    # identity padding keeps eigh well-posed; padded modes never couple to e1
    h_diag0 = jnp.ones(m, dtype)
    h_sup0 = jnp.zeros(m, dtype)

    def tridiag_noise(h_diag, h_sup, i, V):
        """noise_i = v_norm * factor * V^T Q sqrt(L)+ Q^T e1 using only the
        leading (i+1)-block; entries beyond it are decoupled padding."""
        sub_mask = jnp.arange(m) < i  # couple blocks 0..i only
        sub = jnp.where(sub_mask, h_sup, 0.0)
        T = jnp.diag(h_diag) + jnp.diag(sub[: m - 1], k=-1) + jnp.diag(sub[: m - 1], k=1)
        eig_vals, eig_vecs = jnp.linalg.eigh(T)
        sqrt_vals = jnp.sqrt(jnp.maximum(eig_vals, 0.0))
        e1_weights = eig_vecs[0, :]  # Q^T e1
        coeff = _mm(eig_vecs, sqrt_vals * e1_weights)
        return _mm(V[:m].T, coeff) * (v_norm * factor)

    def cond(state):
        i, V, h_diag, h_sup, noise, noise_old, converged = state
        return (i < m) & jnp.logical_not(converged)

    def body(state):
        i, V, h_diag, h_sup, noise_old_prev, noise_old, _ = state
        vi = V[i]
        w = mobility_mult(vi)
        w = w - jnp.where(i > 0, h_sup[jnp.maximum(i - 1, 0)], 0.0) * V[jnp.maximum(i - 1, 0)]
        hd = _mm(w, vi)
        w = w - hd * vi
        hs = jnp.linalg.norm(w)
        w = jnp.where(hs > 0, w / jnp.where(hs > 0, hs, 1.0),
                      jnp.zeros_like(w).at[0].set(1.0))

        h_diag = h_diag.at[i].set(hd)
        h_sup = h_sup.at[i].set(hs)

        # full reorthogonalization against the built basis
        mask = (jnp.arange(m + 1) <= i).astype(dtype)
        proj = _mm(V, w) * mask
        w = w - _mm(V.T, proj)
        V = V.at[i + 1].set(w)

        do_check = ((i + 1) % check_every == 0) | (i + 1 >= m)

        def checked(_):
            noise = tridiag_noise(h_diag, h_sup, i, V)
            noise_old_norm = jnp.linalg.norm(noise_old)
            diff = jnp.linalg.norm(noise - noise_old)
            eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
            conv = (i > 0) & (diff / jnp.maximum(noise_old_norm, eps)
                              < tolerance)
            return noise, conv

        def unchecked(_):
            return noise_old, jnp.asarray(False)

        noise, converged = lax.cond(do_check, checked, unchecked, None)
        return (i + 1, V, h_diag, h_sup, noise, noise, converged)

    zeros = jnp.zeros(n, dtype)
    state = (jnp.asarray(0), V0, h_diag0, h_sup0, zeros, zeros, jnp.asarray(False))
    i, V, h_diag, h_sup, noise, _, converged = lax.while_loop(cond, body, state)

    noise = jnp.where(v_norm > 0, noise, jnp.zeros_like(noise))
    if L_mult is not None:
        noise = L_mult(noise)
    return LanczosResult(noise=noise, iterations=i, converged=converged)
