"""Blob and body force kernels.

One XLA implementation replaces the reference's python/numba/C++/pycuda
force backends (/root/reference/multi_bodies/multi_bodies_functions.py:153-345,
multi_bodies/forces_numba.py). All functions are pure and jit-friendly.

Default physics (overridable at the model layer, mirroring the reference's
user-defined-function override seam):
  - one-blob force: gravity + exponential wall repulsion derived from
    U(z) = U0 + U0 (a-z)/b for z < a, U0 exp(-(z-a)/b) otherwise.
  - blob-blob force: soft exponential/linear repulsion from
    U(r) = U0 + U0 (2a-r)/b for r < 2a, U0 exp(-(r-2a)/b) otherwise.
  - body-body force: Yukawa potential U = eps exp(-r/b)/r.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
from jax import lax

from .mobility import _box_offsets, _min_image


def blob_external_forces(r_vectors, *, g=0.0, blob_mass=1.0, blob_radius=1.0,
                         repulsion_strength_wall=0.0, debye_length_wall=1.0):
    """Gravity + wall repulsion per blob; returns (N,3)
    (multi_bodies_functions.py:153-189)."""
    n = r_vectors.shape[0]
    f = jnp.zeros((n, 3), dtype=r_vectors.dtype)
    f = f.at[:, 2].add(-g * blob_mass)
    h = r_vectors[:, 2]
    amp = repulsion_strength_wall / debye_length_wall
    fz = jnp.where(
        h > blob_radius,
        amp * jnp.exp(-(h - blob_radius) / debye_length_wall),
        amp,
    )
    return f.at[:, 2].add(fz)


def blob_blob_forces(r_vectors, *, repulsion_strength=0.0, debye_length=1.0,
                     blob_radius=1.0, periodic_length=(0.0, 0.0, 0.0),
                     row_tile=None):
    """Pairwise soft repulsion, O(N^2) sweep sharing the mobility engine's
    tiling and periodic-image handling (multi_bodies_functions.py:297-345,
    forces_numba.py:13-74). Returns (N,3)."""
    periodic_length = tuple(float(x) for x in periodic_length)
    n = r_vectors.shape[0]
    dtype = r_vectors.dtype
    if repulsion_strength == 0.0:
        return jnp.zeros((n, 3), dtype=dtype)

    if row_tile is None:
        row_tile = int(min(max(1 << 26 // (max(n, 1) * 8), 8), n))
    n_tiles = -(-n // row_tile)
    n_pad = n_tiles * row_tile
    r_pad = jnp.pad(r_vectors, ((0, n_pad - n), (0, 0)), constant_values=1e30)

    offsets = _box_offsets(periodic_length)
    Lvec = jnp.asarray(periodic_length, dtype=dtype)
    ids = jnp.arange(n)
    eps_over_b = repulsion_strength / debye_length
    two_a = 2.0 * blob_radius

    def tile_fn(i0):
        ri = lax.dynamic_slice(r_pad, (i0, 0), (row_tile, 3))
        rows = i0 + jnp.arange(row_tile)
        d0 = _min_image(ri[:, None, :] - r_vectors[None, :, :], periodic_length)
        acc = jnp.zeros((row_tile, 3), dtype=dtype)
        for box in offsets:
            if box == (0, 0, 0):
                skip = rows[:, None] == ids[None, :]
                d = d0
            else:
                skip = jnp.zeros((row_tile, n), dtype=bool)
                d = d0 + jnp.asarray(box, dtype=dtype) * Lvec
            r2 = jnp.sum(d * d, axis=-1)
            r2 = jnp.where(skip | (r2 == 0.0), 1.0, r2)
            rnorm = jnp.sqrt(r2)
            mag = jnp.where(
                rnorm > two_a,
                eps_over_b * jnp.exp(-(rnorm - two_a) / debye_length) / rnorm,
                eps_over_b / rnorm,
            )
            mag = jnp.where(skip, 0.0, mag)
            # force on blob i from j points along r_i - r_j (repulsion)
            acc = acc + jnp.sum(mag[..., None] * d, axis=1)
        return acc

    out = lax.map(tile_fn, jnp.arange(0, n_pad, row_tile))
    return out.reshape(n_pad, 3)[:n]


def blob_blob_forces_neighbor_list(r_vectors, *, repulsion_strength=0.0,
                                   debye_length=1.0, blob_radius=1.0,
                                   periodic_length=(0.0, 0.0, 0.0),
                                   cutoff=None, grid_dim=16,
                                   cell_capacity=32, row_tile=4096,
                                   z_extent=None, layout=True):
    """Linked-cell O(N * 27 * capacity) pair force — the static-shape
    equivalent of the reference's kd-tree O(N) variant
    (forces_numba.py:142-241; cutoff d_max = 2a + 30 b per
    doc/README.md:488-490).

    XLA needs static shapes, so the scipy cKDTree becomes a fixed-size
    cell table: blobs are bucketed into at most grid_dim^3 cells of edge
    >= cutoff (sort + scatter), and each blob interacts with the 27
    neighboring cells. Exact (vs the direct O(N^2) sum, up to the
    exp(-30) ~ 1e-13 tail beyond the cutoff) as long as no cell holds
    more than cell_capacity blobs; overflowing blobs are dropped from the
    source side, so size cell_capacity to the expected density.

    Periodic dims require floor(L / cutoff) >= 4 cells (otherwise the
    wrapped 27-cell stencil would double-count); smaller boxes fall back
    to the direct sweep. layout=False keeps qualifying boxes on the
    per-target gather path (the reference the layout path is checked
    against)."""
    periodic_length = tuple(float(x) for x in periodic_length)
    n = r_vectors.shape[0]
    dtype = r_vectors.dtype
    if repulsion_strength == 0.0:
        return jnp.zeros((n, 3), dtype=dtype)
    rc = float(cutoff) if cutoff is not None else (
        2.0 * float(blob_radius) + 30.0 * float(debye_length))

    # static per-dim cell counts
    dims = []
    for L in periodic_length:
        if L > 0:
            nd = int(L // rc)
            if nd < 4:
                return blob_blob_forces(
                    r_vectors, repulsion_strength=repulsion_strength,
                    debye_length=debye_length, blob_radius=blob_radius,
                    periodic_length=periodic_length)
            dims.append(min(nd, int(grid_dim)))
        else:
            dims.append(int(grid_dim))
    nx, ny, nz = dims
    n_cells = nx * ny * nz

    # boxes that admit the pre-gathered (cell, 27*cap) layout take it:
    # the generic path below gathers source rows PER TARGET (27*capacity
    # gathers per blob, a padded-gather temporary of N*27*cap*3 values),
    # the layout path gathers the sources once per cell and reduces dense
    # (cell, cap, 27*cap) tiles. Fully periodic boxes qualify directly;
    # xy-periodic wall slabs qualify when the caller declares a static z
    # extent (blobs bin into ceil(z_extent/cutoff) data cells + one empty
    # guard cell, so the stencil's z wrap only ever touches empty cells).
    if layout and all(L > 0 for L in periodic_length):
        return _neighbor_forces_layout(
            r_vectors, periodic_length, dims, int(cell_capacity),
            float(repulsion_strength), float(debye_length),
            float(blob_radius))
    if (layout and z_extent is not None and z_extent > 0
            and periodic_length[0] > 0 and periodic_length[1] > 0
            and periodic_length[2] == 0):
        cs_z = 1.001 * rc
        nz_w = max(int(math.ceil(float(z_extent) / cs_z)), 1) + 1
        vbox = (periodic_length[0], periodic_length[1], nz_w * cs_z)
        return _neighbor_forces_layout(
            r_vectors, vbox, (dims[0], dims[1], nz_w),
            int(cell_capacity), float(repulsion_strength),
            float(debye_length), float(blob_radius),
            z_clip=(nz_w - 1) * cs_z * 0.999)

    # per-dim coordinates projected to the box / data extent
    cols, cells = [], []
    for d, (L, nd) in enumerate(zip(periodic_length, dims)):
        x = r_vectors[:, d]
        if L > 0:
            x = x - jnp.floor(x / L) * L
            cs = L / nd
            lo = jnp.asarray(0.0, dtype)
        else:
            lo = jnp.min(x)
            extent = jnp.max(x) - lo
            cs = jnp.maximum(extent / nd, rc) * (1.0 + 1e-6)
        c = jnp.clip(jnp.floor((x - lo) / cs).astype(jnp.int32), 0, nd - 1)
        cols.append(x)
        cells.append(c)
    r_proj = jnp.stack(cols, axis=1)
    cx, cy, cz = cells
    cid = (cx * ny + cy) * nz + cz

    # fixed-capacity cell table by sort + scatter; overflow -> dump slot
    order = jnp.argsort(cid)
    sc = cid[order]
    slot = jnp.arange(n) - jnp.searchsorted(sc, sc, side="left")
    addr = jnp.where(slot < cell_capacity, sc * cell_capacity + slot,
                     n_cells * cell_capacity)
    table = jnp.full((n_cells * cell_capacity + 1,), n, dtype=jnp.int32)
    table = table.at[addr].set(order.astype(jnp.int32))

    # 27-cell stencil with wrap (periodic) or edge mask (open dims)
    offs = jnp.asarray([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                        for k in (-1, 0, 1)], dtype=jnp.int32)  # (27,3)

    def neighbor_cids(c3):
        # c3: (T,3) cell coords -> (T,27) cell ids + validity
        cand = c3[:, None, :] + offs[None, :, :]
        valid = jnp.ones(cand.shape[:2], dtype=bool)
        out = []
        for d, (L, nd) in enumerate(zip(periodic_length, dims)):
            cd = cand[:, :, d]
            if L > 0:
                cd = jnp.mod(cd, nd)
            else:
                valid = valid & (cd >= 0) & (cd < nd)
                cd = jnp.clip(cd, 0, nd - 1)
            out.append(cd)
        ncid = (out[0] * ny + out[1]) * nz + out[2]
        return ncid, valid

    eps_over_b = repulsion_strength / debye_length
    two_a = 2.0 * blob_radius
    r_pad = jnp.concatenate(
        [r_proj, jnp.full((1, 3), 1e30, dtype=dtype)], axis=0)
    row_tile = int(min(row_tile, n))
    n_tiles = -(-n // row_tile)
    n_pad = n_tiles * row_tile

    def tile_fn(i0):
        rows = i0 + jnp.arange(row_tile)
        rows_c = jnp.minimum(rows, n - 1)
        ri = r_proj[rows_c]                                  # (T,3)
        c3 = jnp.stack([cx[rows_c], cy[rows_c], cz[rows_c]], axis=1)
        ncid, valid = neighbor_cids(c3)                      # (T,27)
        base = ncid * cell_capacity
        cand = table[base[:, :, None] + jnp.arange(cell_capacity)]
        cand = cand.reshape(row_tile, -1)                    # (T,27*cap)
        mask = (valid[:, :, None]
                & jnp.ones((1, 1, cell_capacity), bool)).reshape(
                    row_tile, -1)
        mask = mask & (cand < n) & (cand != rows_c[:, None])
        rj = r_pad[cand]                                     # (T,27*cap,3)
        d = _min_image(ri[:, None, :] - rj, periodic_length)
        r2 = jnp.sum(d * d, axis=-1)
        r2 = jnp.where(~mask | (r2 == 0.0), 1.0, r2)
        rnorm = jnp.sqrt(r2)
        mag = jnp.where(
            rnorm > two_a,
            eps_over_b * jnp.exp(-(rnorm - two_a) / debye_length) / rnorm,
            eps_over_b / rnorm)
        mag = jnp.where(mask, mag, 0.0)
        return jnp.sum(mag[..., None] * d, axis=1)

    out = lax.map(tile_fn, jnp.arange(0, n_pad, row_tile))
    return out.reshape(n_pad, 3)[:n]


def _neighbor_forces_layout(r_vectors, periodic_length, dims, cap,
                            repulsion_strength, debye_length, blob_radius,
                            tile_cells=16, z_clip=None):
    """Linked-cell pair forces on a pre-gathered (cell, 27*cap) source
    layout (ops/cells.py, shared with the spectral near field): the
    sources of every cell are gathered once, and each tile of cells
    reduces a dense (cells, cap, 27*cap) block of the reference's soft
    exp/linear repulsion (multi_bodies_functions.py:297-345), which XLA
    fuses into one reduction. Exact vs the generic path (the same
    27-cell stencil defines which pairs interact); overflowing blobs
    lose their force as targets too (neighbor_list_overflow counts
    them)."""
    from . import cells

    dtype = r_vectors.dtype
    n = r_vectors.shape[0]
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    box = jnp.asarray(periodic_length, dtype)
    pos = r_vectors
    if z_clip is None:
        pos = pos - jnp.floor(pos / box) * box
    else:
        # wall slab: xy wraps, z clips into the data cells (the top
        # guard cell stays empty so the stencil's z wrap is inert)
        xy = pos[:, :2] - jnp.floor(pos[:, :2] / box[:2]) * box[:2]
        pos = jnp.concatenate(
            [xy, jnp.clip(pos[:, 2:3], 0.0, z_clip)], axis=1)

    cell_table, cell_slot, _, _ = cells.cell_bin(pos, box, dims, cap)
    nbr = cells.neighbor_table(dims)
    TC = min(tile_cells, n_cells)
    S = 27 * cap
    n_cells_pad = -(-n_cells // TC) * TC
    wrap = cells.wrap_counts(dims)
    src_ids = cells.padded_source_ids(cell_table, nbr, n, dims, cap,
                                      n_cells_pad, S)
    src = cells.gather_src_pos(pos, src_ids, wrap, box, dims, cap,
                               n_cells_pad, S)           # (3, C, S)
    tgt = cells.gather_tgt_xyz(pos, cell_table, cap, n_cells_pad, n_cells)
    tgt = tgt.reshape(n_cells_pad, cap, 3)
    eps_over_b = repulsion_strength / debye_length
    two_a = 2.0 * blob_radius

    def tile_fn(c0):
        t = lax.dynamic_slice_in_dim(tgt, c0, TC, 0)         # (TC, cap, 3)
        s = lax.dynamic_slice_in_dim(src, c0, TC, 1)         # (3, TC, S)
        d = [t[:, :, k, None] - s[k][:, None, :] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inside = (r2 > 0.0) & (r2 < 1e30)    # scrubs self + NaN pads
        r = jnp.sqrt(jnp.where(inside, r2, 1.0))
        mag = jnp.where(r > two_a,
                        eps_over_b * jnp.exp((two_a - r) / debye_length) / r,
                        eps_over_b / r)
        mag = jnp.where(inside, mag, 0.0)
        # where, not multiply: 0 * NaN would poison the row sums
        return jnp.stack([jnp.sum(jnp.where(inside, mag * dk, 0.0), axis=2)
                          for dk in d], axis=-1)             # (TC, cap, 3)

    rows = lax.map(tile_fn, jnp.arange(0, n_cells_pad, TC))
    rows = rows.reshape(n_cells_pad * cap, 3)
    rows = jnp.concatenate([rows, jnp.zeros((1, 3), rows.dtype)], axis=0)
    return rows[cell_slot]


def neighbor_list_overflow(system, r_blobs):
    """In-jit overflow count of the linked-cell force layout at the
    given configuration (the same binning blob_blob_forces_neighbor_list
    performs): nonzero means blobs silently lost repulsion this step.
    Returns int32 0 when the neighbor-list path is not in use (or the
    box is too small and the direct sweep runs instead)."""
    from . import cells

    if system.blob_blob_force_method != "neighbor_list":
        return jnp.asarray(0, jnp.int32)
    rc = system.blob_blob_cutoff or (
        2.0 * system.blob_radius + 30.0 * system.debye_length)
    periodic_length = tuple(float(x) for x in system.periodic_length)
    dims = []
    for L in periodic_length:
        if L > 0:
            nd = int(L // rc)
            if nd < 4:
                return jnp.asarray(0, jnp.int32)  # direct-sweep fallback
            dims.append(min(nd, int(system.blob_blob_grid_dim)))
        else:
            dims.append(0)                        # resolved below
    cap = int(system.blob_blob_cell_capacity)
    if all(d > 0 for d in dims):
        box = jnp.asarray(periodic_length, r_blobs.dtype)
        pos = r_blobs - jnp.floor(r_blobs / box) * box
        _, _, _, n_dropped = cells.cell_bin(pos, box, tuple(dims), cap)
        return n_dropped
    if (dims[0] > 0 and dims[1] > 0 and periodic_length[2] == 0.0
            and system.spectral_wall_height > 0):
        # xy-periodic wall slab: reproduce the fixed z_extent binning of
        # the layout branch (blob_blob_forces_neighbor_list wall case).
        # Count BOTH failure modes: cell overflow (blobs whose repulsion
        # the layout path zeroes entirely) and blobs above the slab,
        # whose z is clamped to z_clip before pair distances — their
        # repulsion is evaluated at a wrong (closer) position.
        cs_z = 1.001 * rc
        nz_w = max(int(math.ceil(
            float(system.spectral_wall_height) / cs_z)), 1) + 1
        z_clip = (nz_w - 1) * cs_z * 0.999
        box = jnp.asarray(
            [periodic_length[0], periodic_length[1], nz_w * cs_z],
            r_blobs.dtype)
        xy = r_blobs[:, :2] - jnp.floor(r_blobs[:, :2] / box[:2]) * box[:2]
        n_above = jnp.sum(r_blobs[:, 2] > z_clip).astype(jnp.int32)
        pos = jnp.concatenate(
            [xy, jnp.clip(r_blobs[:, 2:3], 0.0, z_clip)], axis=1)
        _, _, _, n_dropped = cells.cell_bin(
            pos, box, (dims[0], dims[1], nz_w), cap)
        return n_dropped + n_above
    # remaining open-boundary layouts size cells from the data extent
    # and drop only source contributions on overflow; not monitored
    return jnp.asarray(0, jnp.int32)


def auto_force_cell_capacity(system, r_blobs, *, margin=1.25, log=None):
    """Size the linked-cell force capacity from the ACTUAL occupancy at
    the given configuration (host-side, call once at startup like
    saddle.auto_spectral_capacities): a cell holding more blobs than
    `blob_blob_cell_capacity` silently drops them — overflow blobs lose
    their source contributions on the generic path, and the layout
    path drops them as targets too (their repulsion is zeroed entirely).
    Returns a System with the capacity set to max-occupancy * margin,
    rounded to 8; a no-op for other force methods."""
    import dataclasses

    import numpy as _np

    if system.blob_blob_force_method != "neighbor_list":
        return system
    rb = _np.asarray(r_blobs)
    rc = system.blob_blob_cutoff or (
        2.0 * system.blob_radius + 30.0 * system.debye_length)
    L3 = _np.asarray(system.periodic_length, _np.float64)
    dims = []
    for d in range(3):
        if L3[d] > 0:
            nd = int(L3[d] // rc)
            if nd < 4:
                return system       # falls back to the direct sweep
            dims.append(min(nd, system.blob_blob_grid_dim))
        else:
            dims.append(system.blob_blob_grid_dim)
    dims = _np.asarray(dims)
    x = rb.copy()
    occs = []
    for d in range(3):
        if L3[d] > 0:
            x[:, d] = x[:, d] % L3[d]
            cs = L3[d] / dims[d]
            lo = 0.0
        else:
            lo = x[:, d].min()
            cs = max((x[:, d].max() - lo) / dims[d], rc) * (1 + 1e-6)
        occs.append(_np.clip((x[:, d] - lo) // cs, 0,
                             dims[d] - 1).astype(int))
    cid = (occs[0] * dims[1] + occs[1]) * dims[2] + occs[2]
    occ = int(_np.bincount(cid).max())
    cap = -(-int(occ * margin) // 8) * 8
    if log is not None:
        log(f"force cells: dims={tuple(int(v) for v in dims)} "
            f"max_occ={occ} capacity={cap}")
    if cap <= system.blob_blob_cell_capacity:
        return system
    return dataclasses.replace(system, blob_blob_cell_capacity=cap)


def body_body_forces_torques(locations, *, repulsion_strength=0.0,
                             debye_length=1.0,
                             periodic_length=(0.0, 0.0, 0.0)):
    """Yukawa body-body force (zero torque), returns (B,6) as (force,torque)
    per body (multi_bodies_functions.py:359-408)."""
    periodic_length = tuple(float(x) for x in periodic_length)
    nb = locations.shape[0]
    dtype = locations.dtype
    if repulsion_strength == 0.0 or nb < 2:
        return jnp.zeros((nb, 6), dtype=dtype)
    d = _min_image(locations[:, None, :] - locations[None, :, :], periodic_length)
    r2 = jnp.sum(d * d, axis=-1)
    skip = jnp.eye(nb, dtype=bool) | (r2 == 0.0)
    r = jnp.sqrt(jnp.where(skip, 1.0, r2))
    eps = repulsion_strength
    b = debye_length
    mag = ((eps / b) + (eps / r)) * jnp.exp(-r / b) / r2
    mag = jnp.where(skip, 0.0, mag)
    force = jnp.sum(mag[..., None] * d, axis=1)
    out = jnp.zeros((nb, 6), dtype=dtype)
    return out.at[:, :3].set(force)


def blob_blob_energy(r_vectors, *, repulsion_strength=0.0, debye_length=1.0,
                     blob_radius=1.0, periodic_length=(0.0, 0.0, 0.0)):
    """Total pair potential energy (used by the MCMC sampler)."""
    periodic_length = tuple(float(x) for x in periodic_length)
    n = r_vectors.shape[0]
    d = _min_image(r_vectors[:, None, :] - r_vectors[None, :, :], periodic_length)
    r2 = jnp.sum(d * d, axis=-1)
    skip = jnp.eye(n, dtype=bool) | (r2 == 0.0)
    r = jnp.sqrt(jnp.where(skip, 1.0, r2))
    two_a = 2.0 * blob_radius
    u0 = repulsion_strength
    b = debye_length
    u = jnp.where(r > two_a, u0 * jnp.exp(-(r - two_a) / b),
                  u0 + u0 * (two_a - r) / b)
    u = jnp.where(skip, 0.0, u)
    return 0.5 * jnp.sum(u)
