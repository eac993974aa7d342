"""Scalar-field + matmul (SFM) fast path for the trans-trans mobility
product.

The blocked engine materializes 9 block entries per pair; this path
decomposes the product into 7 scalar pair fields and matmuls:

  core RPY:    u_i = (A@F)_i + B-term with d = q_i - q_j expanded into
               rank-1 structure over 16 right-hand-side columns
  wall (Swan-Brady, with R = q_i - q~_j, q~ the reflected source):
               f1 (isotropic), g2 (R (R.f) ), g3 (f_z R), g4 ((R.f) z-hat),
               f5 (f_z z-hat)

The Swan-Brady self correction equals the pair formula at the self image
R = (0,0,2h) (verified to machine eps), so wall fields need no diagonal
special case; only the core RPY A/B carry a self mask.

Restrictions: no pseudo-periodic images (the min-image shift breaks the
rank-1 expansion of d). The dispatcher falls back to the blocked engine
for periodic domains.

Fewer bytes per pair than the blocked engine (7 fields vs 9 block
entries + contraction), with the contraction as matmuls at full f32.

Status: on the GPU in f32 the fused pair kernel (ops/pair_kernels.py)
runs the product instead (PERF.md). SFM remains (a) the auto TT engine
on CPU / f64 runs and under a device mesh, and (b) the independent
same-math-different-decomposition oracle that cross-checks the pair
kernel in tests/test_sfm.py. Its rank-1 expansion amplifies rounding by
|q|^2, which costs about 8 bits in f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_HIGH = lax.Precision.HIGHEST


def _core_fields(qt, qs, self_mask):
    """RPY A (isotropic) and B (d (d.f)) scalar fields, (T, S)."""
    d = qt[:, None, :] - qs[None, :, :]
    r2 = jnp.sum(d * d, axis=-1)
    zero = self_mask | (r2 == 0.0)
    r2s = jnp.where(zero, 1.0, r2)
    r = jnp.sqrt(r2s)
    invr = 1.0 / r
    invr2 = invr * invr
    far = r > 2.0
    A_far = (1.0 + (2.0 / 3.0) * invr2) * invr
    B_far = (1.0 - 2.0 * invr2) * invr2 * invr
    A_near = (4.0 / 3.0) * (1.0 - 0.28125 * r)
    B_near = (4.0 / 3.0) * 0.09375 * invr
    A = jnp.where(far, A_far, A_near)
    B = jnp.where(far, B_far, B_near)
    A = jnp.where(zero, jnp.where(self_mask, 4.0 / 3.0, 0.0), A)
    B = jnp.where(zero, 0.0, B)
    return A, B


def _wall_fields(qt, qs_img, zs):
    """Swan-Brady wall fields, (T, S): f1, g2, g3, g4, f5 where the block is
    f1 I + g2 R R + g3 R z-hat^T + g4 z-hat R^T + f5 z-hat z-hat^T."""
    R = qt[:, None, :] - qs_img[None, :, :]
    R2 = jnp.sum(R * R, axis=-1)
    invR = 1.0 / jnp.sqrt(jnp.where(R2 == 0.0, 1.0, R2))
    invR2 = invR * invR
    invR3 = invR2 * invR
    invR5 = invR3 * invR2
    Rz = R[..., 2]
    ez = Rz * invR
    ez2 = ez * ez
    h_hat = zs[None, :] / jnp.where(Rz == 0.0, 1.0, Rz)
    hh = h_hat * (1.0 - h_hat)

    f1 = -(3.0 * (1.0 + 2.0 * hh * ez2) * invR
           + 2.0 * (1.0 - 3.0 * ez2) * invR3
           - 2.0 * (1.0 - 5.0 * ez2) * invR5) / 3.0
    f2 = -(3.0 * (1.0 - 6.0 * hh * ez2) * invR
           - 6.0 * (1.0 - 5.0 * ez2) * invR3
           + 10.0 * (1.0 - 7.0 * ez2) * invR5) / 3.0
    f3 = ez * (3.0 * h_hat * (1.0 - 6.0 * (1.0 - h_hat) * ez2) * invR
               - 6.0 * (1.0 - 5.0 * ez2) * invR3
               + 10.0 * (2.0 - 7.0 * ez2) * invR5) * 2.0 / 3.0
    f4 = ez * (3.0 * h_hat * invR - 10.0 * invR5) * 2.0 / 3.0
    f5 = -(3.0 * h_hat * h_hat * ez2 * invR + 3.0 * ez2 * invR3
           + (2.0 - 15.0 * ez2) * invR5) * 4.0 / 3.0

    g2 = f2 * invR2
    g3 = f3 * invR
    g4 = f4 * invR
    return f1, g2, g3, g4, f5


def _rank1_rhs(q, F):
    """16 RHS columns for a (d (d.f))-type field with left/right point q:
    [F(3), s(1), q x F outer (9), s*q (3)], s = q.f."""
    s = jnp.sum(q * F, axis=-1, keepdims=True)  # (S,1)
    G = (q[:, :, None] * F[:, None, :]).reshape(q.shape[0], 9)
    return jnp.concatenate([F, s, G, s * q], axis=1)  # (S,16)


def _rank1_assemble(qt, Y):
    """Assemble sum_j B (d.f) d from Y = field @ rhs16, (T,16) -> (T,3)."""
    YF = Y[:, 0:3]
    Ys = Y[:, 3]
    YG = Y[:, 4:13].reshape(-1, 3, 3)
    Yp = Y[:, 13:16]
    qdotYF = jnp.sum(qt * YF, axis=-1)
    return (qt * (qdotYF - Ys)[:, None]
            - jnp.einsum("tb,tab->ta", qt, YG, precision=_HIGH) + Yp)


def tt_matvec_sfm(q_src, q_tgt, vec, zs, *, wall, self_interaction,
                  row_tile, mesh=None, shard_axis="blobs"):
    """Core SFM product in normalized coordinates (positions already
    divided by a, heights already shifted; damping applied by the caller).
    Returns (Nt,3) in units of 1/(8 pi eta a) (caller scales)."""
    n_src = q_src.shape[0]
    n_tgt = q_tgt.shape[0]
    dtype = vec.dtype
    F = vec.reshape(n_src, 3)

    rhs_core = _rank1_rhs(q_src, F)  # (S,16)
    if wall:
        q_img = q_src * jnp.asarray([1.0, 1.0, -1.0], dtype=dtype)
        rhs_wall2 = _rank1_rhs(q_img, F)  # (S,16)
        fz = F[:, 2:3]
        rhs_g3 = jnp.concatenate([fz, fz * q_img], axis=1)  # (S,4)
        st = jnp.sum(q_img * F, axis=-1, keepdims=True)
        rhs_g4 = jnp.concatenate([F, st], axis=1)  # (S,4)

    n_tiles = -(-n_tgt // row_tile)
    if mesh is not None:
        n_dev = mesh.shape[shard_axis]
        n_tiles = -(-n_tiles // n_dev) * n_dev
    n_pad = n_tiles * row_tile
    q_tgt_pad = jnp.pad(q_tgt, ((0, n_pad - n_tgt), (0, 0)),
                        constant_values=1.0)
    src_ids = jnp.arange(n_src)

    def tile_fn(i0, q_tgt_pad):
        qt = lax.dynamic_slice(q_tgt_pad, (i0, 0), (row_tile, 3))
        rows = i0 + jnp.arange(row_tile)
        self_mask = (rows[:, None] == src_ids[None, :]) & self_interaction
        A, B = _core_fields(qt, q_src, self_mask)
        out = jnp.dot(A, F, precision=_HIGH)
        out = out + _rank1_assemble(qt, jnp.dot(B, rhs_core, precision=_HIGH))
        if wall:
            f1, g2, g3, g4, f5 = _wall_fields(qt, q_img, zs)
            out = out + jnp.dot(f1, F, precision=_HIGH)
            out = out + _rank1_assemble(
                qt, jnp.dot(g2, rhs_wall2, precision=_HIGH))
            Y3 = jnp.dot(g3, rhs_g3, precision=_HIGH)  # (T,4)
            out = out + qt * Y3[:, 0:1]
            out = out - Y3[:, 1:4]
            Y4 = jnp.dot(g4, rhs_g4, precision=_HIGH)  # (T,4)
            z_extra = jnp.sum(qt * Y4[:, 0:3], axis=-1) - Y4[:, 3]
            z_extra = z_extra + jnp.dot(f5, F[:, 2], precision=_HIGH)
            out = out.at[:, 2].add(z_extra)
        return out

    tile_starts = jnp.arange(0, n_pad, row_tile)
    if mesh is None:
        out = lax.map(lambda i0: tile_fn(i0, q_tgt_pad), tile_starts)
    else:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        def shard_fn(starts, q_tgt_pad):
            local = lax.map(lambda i0: tile_fn(i0, q_tgt_pad), starts)
            return lax.all_gather(local, shard_axis, axis=0, tiled=True)

        out = shard_map(shard_fn, mesh=mesh, in_specs=(P(shard_axis), P()),
                        out_specs=P(), check_vma=False)(tile_starts, q_tgt_pad)
    return out.reshape(n_pad, 3)[:n_tgt]
