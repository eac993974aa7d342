"""Rigid-body kinematics: blob positions and geometric K / K^T products.

The reference materializes per-body K matrices (3 nb x 6) and loops over
bodies (/root/reference/body/body.py:99-115,
multi_bodies/multi_bodies.py:290-371). Here K is never materialized for
products: K U = v + w x r_rel and K^T lam = (sum lam, sum r_rel x lam) are
batched einsums per body type, which XLA fuses. (A dense K builder is kept
for the small per-body preconditioner blocks.)
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..ops import quaternion as quat
from .system import State, System


def type_arrays(system: System, state: State, i: int):
    """(pos, quat) slices of type group i, shapes (c,3), (c,4)."""
    sl = system.body_slice(i)
    return state.pos[sl], state.quat[sl]


def blob_rel_positions(system: System, state: State, i: int):
    """Blob positions relative to body centers for type i: (c, nb, 3)."""
    _, q = type_arrays(system, state, i)
    R = quat.rotation_matrix(q)  # (c,3,3)
    ref = jnp.asarray(system.types[i].ref_config, dtype=state.pos.dtype)
    # full f32: at TF32's three digits blob positions would carry 1e-3
    # relative errors into every pair distance
    return jnp.einsum("cij,nj->cni", R, ref,
                      precision=lax.Precision.HIGHEST)


def blob_positions(system: System, state: State):
    """All blob coordinates, (N, 3), in type-group order
    (body/body.py:64-78)."""
    out = []
    for i, t in enumerate(system.types):
        p, _ = type_arrays(system, state, i)
        out.append((p[:, None, :] + blob_rel_positions(system, state, i))
                   .reshape(t.count * t.num_blobs, 3))
    return jnp.concatenate(out, axis=0)


def K_mul(system: System, state: State, U):
    """K U: body velocities (B,6) -> blob velocities (N,3).

    Per blob: v + w x r_rel (multi_bodies.py:328-347).
    """
    U = U.reshape(system.num_bodies, 6)
    out = []
    for i, t in enumerate(system.types):
        u_t = U[system.body_slice(i)]
        v, w = u_t[:, :3], u_t[:, 3:]
        r_rel = blob_rel_positions(system, state, i)  # (c,nb,3)
        vel = v[:, None, :] + jnp.cross(w[:, None, :], r_rel)
        out.append(vel.reshape(t.count * t.num_blobs, 3))
    return jnp.concatenate(out, axis=0)


def KT_mul(system: System, state: State, lam):
    """K^T lam: blob forces (N,3) -> body force-torques (B,6).

    Per body: (sum_b lam_b, sum_b r_rel x lam_b)
    (multi_bodies.py:350-371).
    """
    lam = lam.reshape(system.num_blobs, 3)
    out = []
    for i, t in enumerate(system.types):
        lam_t = lam[system.blob_slice(i)].reshape(t.count, t.num_blobs, 3)
        f = jnp.sum(lam_t, axis=1)
        r_rel = blob_rel_positions(system, state, i)
        tau = jnp.sum(jnp.cross(r_rel, lam_t), axis=1)
        out.append(jnp.concatenate([f, tau], axis=1))
    return jnp.concatenate(out, axis=0)


def K_dense(system: System, state: State, i: int):
    """Dense K matrices of type i: (c, 3 nb, 6) (body/body.py:99-115).
    Used only for the small per-body preconditioner solves."""
    t = system.types[i]
    r_rel = blob_rel_positions(system, state, i)  # (c,nb,3)
    c, nb = t.count, t.num_blobs
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r_rel.dtype), (c, nb, 3, 3))
    # rotation part: (K w) = w x r  ->  K[:, a, b] = -eps_{abc} r_c
    rx, ry, rz = r_rel[..., 0], r_rel[..., 1], r_rel[..., 2]
    zeros = jnp.zeros_like(rx)
    rot = jnp.stack([
        jnp.stack([zeros, rz, -ry], axis=-1),
        jnp.stack([-rz, zeros, rx], axis=-1),
        jnp.stack([ry, -rx, zeros], axis=-1),
    ], axis=-2)  # (c,nb,3,3)
    K = jnp.concatenate([eye, rot], axis=-1)  # (c,nb,3,6)
    return K.reshape(c, 3 * nb, 6)


def active_slip(system: System, state: State, dtype=None):
    """Prescribed active slip rotated to the lab frame, (N,3)
    (multi_bodies.py:118-140 set_slip_by_ID semantics)."""
    dtype = dtype or state.pos.dtype
    out = []
    for i, t in enumerate(system.types):
        if t.slip_ref is None:
            out.append(jnp.zeros((t.count * t.num_blobs, 3), dtype=dtype))
        else:
            _, q = type_arrays(system, state, i)
            R = quat.rotation_matrix(q)
            slip = jnp.einsum("cij,nj->cni", R,
                              jnp.asarray(t.slip_ref, dtype=dtype),
                              precision=lax.Precision.HIGHEST)
            out.append(slip.reshape(t.count * t.num_blobs, 3))
    return jnp.concatenate(out, axis=0)


def min_blob_height(system: System, state: State):
    """min_z over all blobs — the wall-crossing check reduces to
    min_blob_height > 0 (body/body.py:118-140)."""
    return jnp.min(blob_positions(system, state)[:, 2])


def valid_configuration(system: System, state: State, distance=0.0):
    if system.domain in ("no_wall", "periodic_spectral"):
        return jnp.asarray(True)
    return min_blob_height(system, state) > distance


def advance(state: State, velocities, dt) -> State:
    """Euler update of locations and orientations:
    x += v dt, q <- exp(w dt) q."""
    U = velocities.reshape(-1, 6)
    pos = state.pos + U[:, :3] * dt
    q = quat.step(state.quat, U[:, 3:], dt)
    return State(pos=pos, quat=q)
