"""Blob-level mobility matrix-vector products and dense builders.

One JAX/XLA implementation replaces the reference's four backends
(python/numba/C++/pycuda dispatch, /root/reference/multi_bodies/multi_bodies.py:207-287).
The O(N^2) pair sweep is row-tiled with `lax.map` so peak memory stays at
(tile, N, 3, 3). On the GPU in f32 the hot products run on the fused
pair kernel instead (ops/pair_kernels.py, chosen by `_use_pair_kernel`).

Supported domains (reference names): 'no_wall', 'single_wall', 'in_plane'.
Couplings: 'tt' (trans-force), 'tr' (trans-torque), 'rt' (rot-force),
'rr' (rot-torque).

Pseudo-periodic boundaries: if a component of `periodic_length` is > 0 the
displacement is projected to the minimum image and the +-1 neighbor boxes
are summed, matching mobility_numba.py:140-192.

Wall overlap regularization (mobility/mobility.py:52-119, :1150-1163):
products use z_eff = max(z, a) and M <- B^T M(z_eff) B with diagonal
damping B_ii = min(z_i/a, 1).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from . import backend, rpy

_PREF_POW = {"tt": 1, "tr": 2, "rt": 2, "rr": 3}

# ---------------------------------------------------------------------------
# Regularization near the wall
# ---------------------------------------------------------------------------


def shift_heights(r_vectors, blob_radius):
    """z_effective = max(z, a) (mobility/mobility.py:52-64)."""
    z = jnp.maximum(r_vectors[..., 2], blob_radius)
    return r_vectors.at[..., 2].set(z)


def damping_factors(r_vectors, blob_radius):
    """Per-blob damping B_ii = min(z/a, 1) (mobility/mobility.py:67-84)."""
    return jnp.minimum(r_vectors[..., 2] / blob_radius, 1.0)


# ---------------------------------------------------------------------------
# Pair-block dispatch per (coupling, domain)
# ---------------------------------------------------------------------------


def _block(coupling, domain, d, zt, zs, self_mask):
    """3x3 mobility block for displacement d=(rt-rs)/a, heights zt, zs in
    units of a. Wall corrections use the image-projected in-plane
    displacement and the raw vertical image distance rz = zt + zs."""
    if domain == "in_plane":
        # the reference's in_plane family covers trans-force and
        # trans-torque only (mobility/mobility.py:85-91); both zero the z
        # row and column of the block (mobility_numba.py:291-435,:689-830)
        if coupling == "tt":
            m = rpy.rpy_tt_in_plane(d, self_mask)
            return m + rpy.wall_tt_in_plane(d[..., 0], d[..., 1], zt + zs,
                                            zs, self_mask)
        if coupling == "tr":
            m = rpy.rpy_cross(d, self_mask)
            m = m + rpy.wall_trans_torque(d[..., 0], d[..., 1], zt + zs,
                                          zt, self_mask)
            return m * rpy._z_coupling_mask(m.dtype)
        raise NotImplementedError("in_plane supports 'tt' and 'tr' only")

    if domain == "free_surface":
        if coupling != "tt":
            raise NotImplementedError("free_surface only supports 'tt'")
        return rpy.free_surface_tt(d, zt + zs, self_mask)

    if coupling == "tt":
        m = rpy.rpy_tt(d, self_mask)
        if domain == "single_wall":
            m = m + rpy.wall_tt(d[..., 0], d[..., 1], zt + zs, zs, self_mask)
    elif coupling == "rr":
        m = rpy.rpy_rr(d, self_mask)
        if domain == "single_wall":
            m = m + rpy.wall_rr(d[..., 0], d[..., 1], zt + zs, zs, self_mask)
    elif coupling == "tr":
        m = rpy.rpy_cross(d, self_mask)
        if domain == "single_wall":
            m = m + rpy.wall_trans_torque(d[..., 0], d[..., 1], zt + zs, zt, self_mask)
    elif coupling == "rt":
        m = rpy.rpy_cross(d, self_mask)
        if domain == "single_wall":
            m = m + rpy.wall_rot_force(d[..., 0], d[..., 1], zt + zs, zs, self_mask)
    else:
        raise ValueError(f"unknown coupling {coupling!r}")
    return m


def _box_offsets(periodic_length) -> Sequence[tuple]:
    """Static list of image-box offsets; (0,0,0) is always first."""
    axes = []
    for L in periodic_length:
        axes.append((-1, 0, 1) if L > 0 else (0,))
    offsets = [(0, 0, 0)]
    for bx in axes[0]:
        for by in axes[1]:
            for bz in axes[2]:
                if (bx, by, bz) != (0, 0, 0):
                    offsets.append((bx, by, bz))
    return offsets


def _min_image(d, periodic_length):
    """Project displacements into the extended unit cell, truncation form
    d - trunc(d/L + sign(d)/2) * L (mobility_numba.py:58-66)."""
    for axis, L in enumerate(periodic_length):
        if L > 0:
            comp = d[..., axis]
            shift = jnp.trunc(comp / L + 0.5 * jnp.sign(comp)) * L
            d = d.at[..., axis].add(-shift)
    return d


def _default_row_tile(n_src, n_tgt, itemsize=8, budget_bytes=1 << 26):
    per_row = max(n_src, 1) * 9 * itemsize
    tile = max(budget_bytes // per_row, 8)
    return int(min(tile, max(n_tgt, 1)))


def _use_pair_kernel(method, dtype, mesh, domain, periodic_length,
                     coupling="tt"):
    """Whether a pairwise product runs on the fused pair kernel
    (ops/pair_kernels.py). It covers the four couplings of the no_wall
    and single_wall domains without periodic images, on one device;
    under a mesh the row-sharded XLA sweep runs instead. method='pallas'
    outside that scope raises instead of falling back."""
    covered = (mesh is None and coupling in ("tt", "tr", "rt", "rr")
               and domain in ("no_wall", "single_wall")
               and all(L <= 0 for L in periodic_length))
    if not covered:
        if method == "pallas":
            raise ValueError(
                f"the pair kernel does not cover coupling={coupling!r}, "
                f"domain={domain!r}, periodic_length={periodic_length}"
                + (" under a mesh" if mesh is not None else ""))
        return False
    return backend.use_kernel(method, dtype, what="the pair kernel")


# ---------------------------------------------------------------------------
# Generic tiled pairwise product
# ---------------------------------------------------------------------------


def pairwise_matvec(
    r_src,
    r_tgt,
    vec,
    eta,
    a,
    *,
    coupling="tt",
    domain="single_wall",
    periodic_length=(0.0, 0.0, 0.0),
    self_interaction=True,
    row_tile=None,
    mesh=None,
    shard_axis="blobs",
    method="auto",
):
    """u_i = sum_j M^{coupling}_ij v_j over all (target, source) pairs.

    r_src, r_tgt: (Ns,3), (Nt,3); vec: (Ns,3). Returns (Nt,3).
    `self_interaction` must be True when r_src is r_tgt (square product)
    and False for source!=target evaluations.

    If `mesh` is given, target rows are sharded over `shard_axis`: each
    device computes its row block of the O(N^2) sweep against replicated
    sources and the result is all-gathered (the device-mesh replacement for
    the reference's absent distributed backend; SURVEY.md section 2.4).
    """
    periodic_length = tuple(float(x) for x in periodic_length)
    n_src = r_src.shape[0]
    n_tgt = r_tgt.shape[0]
    dtype = jnp.result_type(r_src.dtype, vec.dtype)
    vec = vec.reshape(n_src, 3).astype(dtype)

    wall = domain in ("single_wall", "in_plane")
    if wall:
        damp_s = damping_factors(r_src, a).astype(dtype)
        damp_t = damping_factors(r_tgt, a).astype(dtype)
        r_src = shift_heights(r_src, a)
        r_tgt = shift_heights(r_tgt, a)
        vec = vec * damp_s[:, None]

    inva = 1.0 / a
    q_src = r_src.astype(dtype) * inva
    q_tgt = r_tgt.astype(dtype) * inva
    zs = q_src[:, 2]

    if row_tile is None:
        row_tile = _default_row_tile(n_src, n_tgt, jnp.dtype(dtype).itemsize)
        if mesh is not None:
            # at least one tile per device
            row_tile = min(row_tile, -(-n_tgt // mesh.shape[shard_axis]))

    # fast path 1: direct-block fused Pallas kernel (all four couplings)
    # on the GPU in f32 — pair blocks stay in registers
    if _use_pair_kernel(method, dtype, mesh, domain, periodic_length,
                        coupling):
        from . import pair_kernels

        out = pair_kernels.pair_matvec_pallas(
            q_src, q_tgt, vec, coupling=coupling,
            wall=(domain == "single_wall"),
            self_interaction=self_interaction)
        out = out / (8.0 * jnp.pi * eta * a ** _PREF_POW[coupling])
        if wall:
            out = out * damp_t[:, None]
        return out

    # fast path 2: scalar-field + matmul decomposition of the TT product
    # for CPU / f64 / sharded runs (no pseudo-periodic images: the min-image
    # shift breaks the expansion)
    use_sfm = (method == "sfm" or (
        method == "auto" and coupling == "tt"
        and domain in ("no_wall", "single_wall")
        and all(L <= 0 for L in periodic_length)))
    if use_sfm:
        from . import mobility_sfm

        out = mobility_sfm.tt_matvec_sfm(
            q_src, q_tgt, vec, zs, wall=wall,
            self_interaction=self_interaction, row_tile=row_tile,
            mesh=mesh, shard_axis=shard_axis)
        out = out / (8.0 * jnp.pi * eta * a)
        if wall:
            out = out * damp_t[:, None]
        return out

    n_tiles = -(-n_tgt // row_tile)
    if mesh is not None:
        n_dev = mesh.shape[shard_axis]
        n_tiles = -(-n_tiles // n_dev) * n_dev
    n_pad = n_tiles * row_tile
    q_tgt_pad = jnp.pad(q_tgt, ((0, n_pad - n_tgt), (0, 0)), constant_values=1.0)

    offsets = _box_offsets(periodic_length)
    Lvec = jnp.asarray(periodic_length, dtype=dtype)
    src_ids = jnp.arange(n_src)

    def tile_fn(i0, q_tgt_pad, q_src, zs, vec):
        rt = lax.dynamic_slice(q_tgt_pad, (i0, 0), (row_tile, 3))
        rows = i0 + jnp.arange(row_tile)
        d0 = rt[:, None, :] - q_src[None, :, :]
        d0 = _min_image(d0 * a, periodic_length) * inva  # project in physical units
        zt = rt[:, 2][:, None]
        zsb = zs[None, :]
        acc = jnp.zeros((row_tile, 3), dtype=dtype)
        for box in offsets:
            if box == (0, 0, 0):
                self_mask = (rows[:, None] == src_ids[None, :]) & self_interaction
                d = d0
            else:
                self_mask = jnp.zeros((row_tile, n_src), dtype=bool)
                d = d0 + jnp.asarray(box, dtype=dtype) * Lvec * inva
            m = _block(coupling, domain, d, zt, zsb, self_mask)
            acc = acc + jnp.einsum(
                "tsab,sb->ta", m, vec, precision=lax.Precision.HIGHEST
            )
        return acc

    tile_starts = jnp.arange(0, n_pad, row_tile)
    if mesh is None:
        out = lax.map(lambda i0: tile_fn(i0, q_tgt_pad, q_src, zs, vec),
                      tile_starts)
    else:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        def shard_fn(starts, q_tgt_pad, q_src, zs, vec):
            local = lax.map(
                lambda i0: tile_fn(i0, q_tgt_pad, q_src, zs, vec), starts)
            return lax.all_gather(local, shard_axis, axis=0, tiled=True)

        out = shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(shard_axis), P(), P(), P(), P()),
            out_specs=P(), check_vma=False,
        )(tile_starts, q_tgt_pad, q_src, zs, vec)
    out = out.reshape(n_pad, 3)[:n_tgt]

    norm = 1.0 / (8.0 * jnp.pi * eta * a ** _PREF_POW[coupling])
    out = out * norm
    if wall:
        out = out * damp_t[:, None]
    return out


def pairwise_matvec_multi(r_src, r_tgt, vec, eta, a, *, coupling="tt",
                          domain="single_wall",
                          periodic_length=(0.0, 0.0, 0.0),
                          self_interaction=True, method="auto",
                          mesh=None, shard_axis="blobs", **kw):
    """Stacked pairwise products, vec (B, Ns, 3) -> (B, Nt, 3), sharing
    ONE pair-geometry sweep across the B right-hand sides on the fused
    direct Pallas path (the condensed block coefficients are applied to
    every column; see pair_kernels.pair_matvec_pallas). Falls back to
    per-RHS products where the direct path doesn't apply."""
    B = vec.shape[0]
    single_kw = dict(coupling=coupling, domain=domain,
                     periodic_length=periodic_length,
                     self_interaction=self_interaction, method=method,
                     mesh=mesh, shard_axis=shard_axis, **kw)
    periodic_length = tuple(float(x) for x in periodic_length)
    dtype = jnp.result_type(r_src.dtype, vec.dtype)
    use_direct = B > 1 and _use_pair_kernel(
        method, dtype, mesh, domain, periodic_length, coupling)
    if not use_direct:
        return jnp.stack([
            pairwise_matvec(r_src, r_tgt, vec[b], eta, a, **single_kw)
            for b in range(B)])

    from . import pair_kernels

    n_src = r_src.shape[0]
    n_tgt = r_tgt.shape[0]
    v = vec.astype(jnp.float32)
    wall = domain == "single_wall"
    if wall:
        damp_s = damping_factors(r_src, a).astype(jnp.float32)
        damp_t = damping_factors(r_tgt, a).astype(jnp.float32)
        r_src = shift_heights(r_src, a)
        r_tgt = shift_heights(r_tgt, a)
        v = v * damp_s[None, :, None]
    inva = 1.0 / a
    V = jnp.moveaxis(v, 0, 1).reshape(n_src, 3 * B)      # b-major columns
    out = pair_kernels.pair_matvec_pallas(
        r_src.astype(jnp.float32) * inva, r_tgt.astype(jnp.float32) * inva,
        V, coupling=coupling, wall=wall, self_interaction=self_interaction)
    out = out / (8.0 * jnp.pi * eta * a ** _PREF_POW[coupling])
    if wall:
        out = out * damp_t[:, None]
    return jnp.moveaxis(out.reshape(n_tgt, B, 3), 1, 0)


# ---------------------------------------------------------------------------
# Reference-named convenience products (square, same blobs as src and tgt)
# ---------------------------------------------------------------------------


def _square_product(coupling):
    def product(r_vectors, vec, eta, a, **kw):
        return pairwise_matvec(
            r_vectors, r_vectors, vec, eta, a, coupling=coupling,
            self_interaction=True, **kw,
        )

    return product


mobility_trans_times_force = _square_product("tt")
mobility_trans_times_torque = _square_product("tr")
mobility_rot_times_force = _square_product("rt")
mobility_rot_times_torque = _square_product("rr")


def mobility_trans_times_force_torque(r_vectors, force, torque, eta, a, **kw):
    return (mobility_trans_times_force(r_vectors, force, eta, a, **kw)
            + mobility_trans_times_torque(r_vectors, torque, eta, a, **kw))


def mobility_rot_times_force_torque(r_vectors, force, torque, eta, a, **kw):
    return (mobility_rot_times_force(r_vectors, force, eta, a, **kw)
            + mobility_rot_times_torque(r_vectors, torque, eta, a, **kw))


def grand_mobility_matvec(r_vectors, force, torque, eta, a, **kw):
    """(U, W) = M_grand (F, T) for single-blob bodies (rollers path).

    On the GPU in f32 the four coupling blocks are evaluated in ONE fused
    Pallas pass over the pair geometry (the reference computes four
    separate pycuda products, mobility_pycuda.py:1266); elsewhere it runs
    the four tiled XLA products."""
    domain = kw.get("domain", "single_wall")
    periodic_length = tuple(float(x) for x in
                            kw.get("periodic_length", (0.0, 0.0, 0.0)))
    if _use_pair_kernel(kw.get("method", "auto"),
                        jnp.result_type(r_vectors.dtype, force.dtype),
                        kw.get("mesh"), domain, periodic_length):
        from . import pair_kernels

        n = r_vectors.shape[0]
        wall = domain == "single_wall"
        F = force.reshape(n, 3).astype(jnp.float32)
        T = torque.reshape(n, 3).astype(jnp.float32)
        r = r_vectors.astype(jnp.float32)
        if wall:
            damp = damping_factors(r, a)
            r = shift_heights(r, a)
            F = F * damp[:, None]
            T = T * damp[:, None]
        q = r * (1.0 / a)
        vin = jnp.concatenate([F, T * (1.0 / a)], axis=1)
        out = pair_kernels.pair_matvec_pallas(
            q, q, vin, coupling="grand", wall=wall, self_interaction=True)
        pref = 1.0 / (8.0 * jnp.pi * eta * a)
        u = out[:, :3] * pref
        w = out[:, 3:] * (pref / a)
        if wall:
            u = u * damp[:, None]
            w = w * damp[:, None]
        return u, w
    u = mobility_trans_times_force_torque(r_vectors, force, torque, eta, a, **kw)
    w = mobility_rot_times_force_torque(r_vectors, force, torque, eta, a, **kw)
    return u, w


# ---------------------------------------------------------------------------
# Source-target products with per-blob radii (velocity-field evaluation,
# radii variants). Reference: mobility_numba.py:1480-1658 and the
# shift/damping wrapper mobility/mobility.py:830-905.
# ---------------------------------------------------------------------------


def source_target_matvec(
    r_src,
    r_tgt,
    vec,
    radius_src,
    radius_tgt,
    eta,
    *,
    wall=True,
    domain=None,
    periodic_length=(0.0, 0.0, 0.0),
    row_tile=None,
):
    """u_i = sum_j M_tt(target_i, source_j) f_j with per-blob radii.

    Physical-units RPY for unequal radii plus, for domain='single_wall',
    the finite-size wall image system with per-blob-radius overlap
    regularization, or for domain='free_surface' the reflected image
    (mobility_numba.py:1941-2092).
    """
    if domain is not None:
        wall = domain == "single_wall"
    else:
        domain = "single_wall" if wall else "no_wall"
    free_surface = domain == "free_surface"
    periodic_length = tuple(float(x) for x in periodic_length)
    n_src = r_src.shape[0]
    n_tgt = r_tgt.shape[0]
    dtype = jnp.result_type(r_src.dtype, vec.dtype)
    vec = vec.reshape(n_src, 3).astype(dtype)
    radius_src = jnp.broadcast_to(jnp.asarray(radius_src, dtype), (n_src,))
    radius_tgt = jnp.broadcast_to(jnp.asarray(radius_tgt, dtype), (n_tgt,))

    if wall:
        damp_s = jnp.minimum(r_src[:, 2] / radius_src, 1.0).astype(dtype)
        # zero-radius targets (tracers) never damp
        damp_t = jnp.where(radius_tgt > 0,
                           jnp.minimum(r_tgt[:, 2] / jnp.where(radius_tgt > 0,
                                                               radius_tgt, 1.0), 1.0),
                           1.0).astype(dtype)
        r_src = r_src.at[:, 2].set(jnp.maximum(r_src[:, 2], radius_src))
        r_tgt = r_tgt.at[:, 2].set(jnp.maximum(r_tgt[:, 2], radius_tgt))
        vec = vec * damp_s[:, None]

    if row_tile is None:
        row_tile = _default_row_tile(n_src, n_tgt, jnp.dtype(dtype).itemsize)
    n_tiles = -(-n_tgt // row_tile)
    n_pad = n_tiles * row_tile
    r_tgt_pad = jnp.pad(r_tgt.astype(dtype), ((0, n_pad - n_tgt), (0, 0)),
                        constant_values=1.0)
    rad_tgt_pad = jnp.pad(radius_tgt, (0, n_pad - n_tgt), constant_values=1.0)

    offsets = _box_offsets(periodic_length)
    Lvec = jnp.asarray(periodic_length, dtype=dtype)
    zs = r_src[:, 2].astype(dtype)
    r_src = r_src.astype(dtype)

    def tile_fn(i0):
        rt = lax.dynamic_slice(r_tgt_pad, (i0, 0), (row_tile, 3))
        at = lax.dynamic_slice(rad_tgt_pad, (i0,), (row_tile,))[:, None]
        d0 = _min_image(rt[:, None, :] - r_src[None, :, :], periodic_length)
        acc = jnp.zeros((row_tile, 3), dtype=dtype)
        bs = radius_src[None, :]
        for box in offsets:
            d = d0 if box == (0, 0, 0) else d0 + jnp.asarray(box, dtype) * Lvec
            m = rpy.rpy_tt_radii(d, at, bs)
            if wall:
                rz = rt[:, 2][:, None] + zs[None, :]
                m = m + rpy.wall_tt_radii(d[..., 0], d[..., 1], rz,
                                          rt[:, 2][:, None], zs[None, :],
                                          at, bs)
            elif free_surface:
                rz = rt[:, 2][:, None] + zs[None, :]
                d_img = d.at[..., 2].set(rz)
                refl = jnp.asarray([1.0, 1.0, -1.0], dtype=dtype)
                m = m + rpy.rpy_tt_radii(d_img, at, bs) * refl
            acc = acc + jnp.einsum("tsab,sb->ta", m, vec,
                                   precision=lax.Precision.HIGHEST)
        return acc

    out = lax.map(tile_fn, jnp.arange(0, n_pad, row_tile))
    out = out.reshape(n_pad, 3)[:n_tgt]
    out = out / (8.0 * jnp.pi * eta)
    if wall:
        out = out * damp_t[:, None]
    return out


def single_wall_self_mobility_with_rotation(height, eta, a):
    """6x6 single-blob self mobility (trans+rot blocks with coupling)
    above the wall, from the Swan-Brady expansions — the reference's
    single_wall_self_mobility_with_rotation (mobility/mobility.py:739-774).
    height: scalar or (...,) z coordinates. Returns (...,6,6)."""
    h = jnp.asarray(height) / a
    he = jnp.maximum(h, 1.0)
    damp = jnp.clip(h, 0.0, 1.0)
    f_tt = 1.0 / (6.0 * jnp.pi * eta * a)
    f_rr = 1.0 / (6.0 * jnp.pi * eta * a**3)
    f_rt = 1.0 / (6.0 * jnp.pi * eta * a**2)
    tt_para = f_tt * (1 - 9 / (16 * he) + 2 / (16 * he**3)
                      - 1 / (16 * he**5)) * damp
    tt_perp = f_tt * (1 - 9 / (8 * he) + 1 / (2 * he**3)
                      - 1 / (8 * he**5)) * damp
    rr_para = f_rr * (0.75 - 15 / (64 * he**3)) * damp
    rr_perp = f_rr * (0.75 - 3 / (32 * he**3)) * damp
    rt_para = f_rt * (3 / (32 * he**4)) * damp
    z = jnp.zeros_like(he)
    rows = [
        jnp.stack([tt_para, z, z, z, rt_para, z], axis=-1),
        jnp.stack([z, tt_para, z, -rt_para, z, z], axis=-1),
        jnp.stack([z, z, tt_perp, z, z, z], axis=-1),
        jnp.stack([z, -rt_para, z, rr_para, z, z], axis=-1),
        jnp.stack([rt_para, z, z, z, rr_para, z], axis=-1),
        jnp.stack([z, z, z, z, z, rr_perp], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def mobility_radii_trans_times_force(r_vectors, vec, radii, eta, *,
                                     domain="single_wall",
                                     periodic_length=(0.0, 0.0, 0.0),
                                     row_tile=None):
    """Square TT product with per-blob radii (the reference's
    radii_* kernel family, mobility/mobility.py:1369-1375): the
    source-target kernel with sources == targets (its r=0 branch IS the
    self mobility 4/(3 max(a,b)))."""
    return source_target_matvec(
        r_vectors, r_vectors, vec, radii, radii, eta, domain=domain,
        periodic_length=periodic_length, row_tile=row_tile)


def dense_mobility_radii(r_vectors, radii, eta, *, domain="single_wall"):
    """Dense (3n,3n) TT mobility with per-blob radii — the dense analog
    of `mobility_radii_trans_times_force` (reference radii dense
    builders, mobility/mobility.py:87-119, :1369-1375). Same math as
    source_target_matvec with sources == targets (its r=0 branch is the
    self mobility), materialized for per-body preconditioner blocks and
    the dense-algebra utility solves. No periodic images."""
    n = r_vectors.shape[0]
    dtype = r_vectors.dtype
    radii = jnp.broadcast_to(jnp.asarray(radii, dtype), (n,))
    wall = domain in ("single_wall",)
    free_surface = domain == "free_surface"
    if wall:
        damp = jnp.minimum(r_vectors[:, 2] / radii, 1.0).astype(dtype)
        r_vectors = r_vectors.at[:, 2].set(
            jnp.maximum(r_vectors[:, 2], radii))
    d = r_vectors[:, None, :] - r_vectors[None, :, :]
    at = radii[:, None]
    bs = radii[None, :]
    m = rpy.rpy_tt_radii(d, at, bs)
    if wall:
        zt = r_vectors[:, 2][:, None]
        zs = r_vectors[:, 2][None, :]
        m = m + rpy.wall_tt_radii(d[..., 0], d[..., 1], zt + zs,
                                  zt, zs, at, bs)
    elif free_surface:
        zt = r_vectors[:, 2][:, None]
        zs = r_vectors[:, 2][None, :]
        d_img = d.at[..., 2].set(zt + zs)
        refl = jnp.asarray([1.0, 1.0, -1.0], dtype=dtype)
        m = m + rpy.rpy_tt_radii(d_img, at, bs) * refl
    m = m / (8.0 * jnp.pi * eta)
    if wall:
        m = m * damp[:, None, None, None] * damp[None, :, None, None]
    return m.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n)


# ---------------------------------------------------------------------------
# Dense mobility matrices (for per-body preconditioner blocks and the
# dense-algebra schemes). No periodic images (matches reference dense
# builders, mobility/mobility.py:967-1116).
# ---------------------------------------------------------------------------


def _dense(coupling, r_vectors, eta, a, domain):
    n = r_vectors.shape[0]
    dtype = r_vectors.dtype
    wall = domain in ("single_wall", "in_plane")
    if wall:
        damp = damping_factors(r_vectors, a).astype(dtype)
        r_vectors = shift_heights(r_vectors, a)
    q = r_vectors * (1.0 / a)
    d = q[:, None, :] - q[None, :, :]
    self_mask = jnp.eye(n, dtype=bool)
    zt = q[:, 2][:, None]
    zs = q[:, 2][None, :]
    m = _block(coupling, domain, d, zt, zs, self_mask)
    m = m / (8.0 * jnp.pi * eta * a ** _PREF_POW[coupling])
    if wall:
        m = m * damp[:, None, None, None] * damp[None, :, None, None]
    # (N,N,3,3) -> (3N,3N)
    return m.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n)


def dense_mobility_tiled(r_vectors, eta, a, *, domain="single_wall",
                         coupling="tt", periodic_length=(0.0, 0.0, 0.0),
                         row_tile=None):
    """Materialize the mobility as nine (N,N) component matrices, shape
    (3,3,N,N), with the row-tiled engine (bounded peak memory), including
    periodic images and wall regularization.

    Component layout (not interleaved (3N,3N)): the (N,N) planes keep
    the long axes minor, so every plane is one dense matrix. Used by the
    materialized-operator fast path (models/saddle.maybe_dense_mobility):
    at fixed positions every GMRES/Lanczos iteration becomes nine dense
    matvecs instead of recomputing the O(N^2) pair fields."""
    periodic_length = tuple(float(x) for x in periodic_length)
    n = r_vectors.shape[0]
    dtype = r_vectors.dtype
    wall = domain in ("single_wall", "in_plane")
    if wall:
        damp = damping_factors(r_vectors, a).astype(dtype)
        r_vectors = shift_heights(r_vectors, a)
    q = r_vectors.astype(dtype) * (1.0 / a)
    zs = q[:, 2]
    if row_tile is None:
        row_tile = _default_row_tile(n, n, jnp.dtype(dtype).itemsize)
    n_tiles = -(-n // row_tile)
    n_pad = n_tiles * row_tile
    q_pad = jnp.pad(q, ((0, n_pad - n), (0, 0)), constant_values=1.0)
    offsets = _box_offsets(periodic_length)
    Lvec = jnp.asarray(periodic_length, dtype=dtype)
    src_ids = jnp.arange(n)
    inva = 1.0 / a

    def tile_fn(i0):
        rt = lax.dynamic_slice(q_pad, (i0, 0), (row_tile, 3))
        rows = i0 + jnp.arange(row_tile)
        d0 = rt[:, None, :] - q[None, :, :]
        d0 = _min_image(d0 * a, periodic_length) * inva
        zt = rt[:, 2][:, None]
        acc = jnp.zeros((row_tile, n, 3, 3), dtype=dtype)
        for box in offsets:
            if box == (0, 0, 0):
                self_mask = rows[:, None] == src_ids[None, :]
                d = d0
            else:
                self_mask = jnp.zeros((row_tile, n), dtype=bool)
                d = d0 + jnp.asarray(box, dtype=dtype) * Lvec * inva
            acc = acc + _block(coupling, domain, d, zt, zs[None, :], self_mask)
        # (T,N,3,3) -> (3,3,T,N): the copy keeps (T,N) minor, no padding
        return acc.transpose(2, 3, 0, 1)

    m = lax.map(tile_fn, jnp.arange(0, n_pad, row_tile))  # (tiles,3,3,T,N)
    m = jnp.moveaxis(m, 0, 2).reshape(3, 3, n_pad, n)[:, :, :n, :]
    m = m / (8.0 * jnp.pi * eta * a ** _PREF_POW[coupling])
    if wall:
        m = m * damp[None, None, :, None] * damp[None, None, None, :]
    return m  # (3,3,N,N) component planes


def rotne_prager_tensor(r_vectors, eta, a):
    """Dense unbounded RPY trans-trans mobility (3N,3N)."""
    return _dense("tt", r_vectors, eta, a, "no_wall")


def single_wall_fluid_mobility(r_vectors, eta, a):
    """Dense single-wall (Swan-Brady) trans-trans mobility (3N,3N),
    including the overlap regularization."""
    return _dense("tt", r_vectors, eta, a, "single_wall")


def dense_mobility(r_vectors, eta, a, domain="single_wall", coupling="tt"):
    return _dense(coupling, r_vectors, eta, a, domain)
