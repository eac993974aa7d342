"""Shared fixed-capacity linked-cell layouts (static-shape neighbor lists).

One implementation of the cell machinery used by BOTH short-range pair
sweeps — the spectral engine's near field (ops/ewald.py) and the
linked-cell blob-blob forces (ops/forces.py) — so their pair semantics
and memory behavior stay in lockstep:

- `cell_bin`: sort+scatter particles into a padded (cell, capacity)
  table with an overflow sentinel and a collision-free inverse
  (particle -> flat slot row), plus the overflow count;
- `neighbor_table` / `wrap_counts`: the 27-cell stencil with periodic
  wrap bookkeeping (host-static table, device wrap counts);
- `padded_source_ids` + `gather_src_pos` / `gather_tgt_xyz`: the
  pre-gathered (cell, S >= 27*capacity) source layout consumed by the
  near-field kernel (ops/ewald.py) and the layout force sweep: one
  gather per configuration, then dense per-cell tiles. `gather_src_pos`
  switches to per-COMPONENT gathers past a size threshold, so no
  (C*S, 3) temporary with a size-3 minor dimension is ever built at
  large sizes.

Replaces the reference's scipy cKDTree neighbor searches
(multi_bodies/forces_numba.py:203, Lubrication/Lub_Solver.py:108-116)
with static-shape machinery XLA can compile.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def cell_bin(pos, box, dims, cap):
    """Bin wrapped positions into a fixed-capacity padded cell table.

    Returns (cell_table, cell_slot, cid, n_dropped):
      cell_table: (n_cells * cap,) int32 particle ids, pad = n
      cell_slot:  (n,) flat (cell, slot) row per particle; dropped ->
                  n_cells * cap (one past the end)
      cid:        (n,) int32 cell id per particle
      n_dropped:  scalar int32 capacity overflows
    """
    nx, ny, nz = dims
    n = pos.shape[0]
    n_cells = nx * ny * nz
    csize = box / jnp.asarray(dims, pos.dtype)
    c3 = jnp.clip((pos / csize).astype(jnp.int32), 0,
                  jnp.asarray(dims, jnp.int32) - 1)
    cid = (c3[:, 0] * ny + c3[:, 1]) * nz + c3[:, 2]
    order = jnp.argsort(cid)
    sc = cid[order]
    slot = jnp.arange(n) - jnp.searchsorted(sc, sc, side="left")
    in_cap = slot < cap
    addr = jnp.where(in_cap, sc * cap + slot, n_cells * cap)
    cell_table = jnp.full((n_cells * cap + 1,), n, dtype=jnp.int32)
    cell_table = cell_table.at[addr].set(order.astype(jnp.int32))[:-1]
    slot_of = jnp.full((n,), cap, jnp.int32).at[order].set(
        jnp.where(in_cap, slot, cap).astype(jnp.int32))
    cell_slot = jnp.where(slot_of < cap, cid * cap + slot_of,
                          n_cells * cap)
    n_dropped = jnp.sum(~in_cap).astype(jnp.int32)
    return cell_table, cell_slot, cid, n_dropped


def neighbor_table(dims):
    """Host-static (n_cells, 27) int32 neighbor-cell ids with periodic
    wrap."""
    nx, ny, nz = dims
    cc = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                              indexing="ij"), axis=-1).reshape(-1, 3)
    o27 = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for k in (-1, 0, 1)])
    nb3 = (cc[:, None, :] + o27[None, :, :]) % np.array(dims)
    return jnp.asarray((nb3[:, :, 0] * ny + nb3[:, :, 1]) * nz
                       + nb3[:, :, 2], jnp.int32)


def wrap_counts(dims):
    """Device (n_cells, 27, 3) int32 periodic wrap counts (-1/0/+1) of
    each stencil neighbor — resolves image shifts into the pre-gathered
    source positions so kernels need no min-image math. Built from tiny
    1-D device arithmetic (no (C,27,3) host constant)."""
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    idx = jnp.arange(n_cells, dtype=jnp.int32)
    c3 = jnp.stack([idx // (ny * nz), (idx // nz) % ny, idx % nz],
                   axis=-1)
    o27 = jnp.asarray([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], jnp.int32)
    raw = c3[:, None, :] + o27[None, :, :]
    return jnp.floor_divide(raw, jnp.asarray(dims, jnp.int32))


def padded_source_ids(cell_table, nbr, n, dims, cap, C_pad, S):
    """(C_pad, S) int32 source particle ids per cell (pad = n).

    `nbr` may be a row-subset of the full stencil table (target-cell
    pruning: the wall engine skips image-only cells as targets); rows
    are padded from nbr's own row count up to C_pad."""
    n_cells = int(np.prod(dims))
    n_rows = nbr.shape[0]
    ids2 = cell_table.reshape(n_cells, cap)
    sids = ids2[nbr].reshape(n_rows, 27 * cap)
    return jnp.pad(sids, ((0, C_pad - n_rows), (0, S - 27 * cap)),
                   constant_values=n)


def gather_src_pos(pos, src_ids, wrap, box, dims, cap, C_pad, S):
    """Pre-gathered near-field source positions (3, C_pad, S), NaN pad,
    wrap shifts resolved. See module docstring for the two gather
    strategies. `wrap` may be a row-subset of wrap_counts(dims) when the
    caller prunes target cells; its row count defines the live rows."""
    dtype = pos.dtype
    n_rows = wrap.shape[0]

    def shift_comp(d):
        sh = wrap[:, :, d].astype(dtype) * box[d]        # (C, 27)
        sh = jnp.broadcast_to(sh[:, :, None], (n_rows, 27, cap)
                              ).reshape(n_rows, 27 * cap)
        return jnp.pad(sh, ((0, C_pad - n_rows), (0, S - 27 * cap)))

    if C_pad * S <= (8 << 20):
        pos_nan = jnp.concatenate(
            [pos, jnp.full((1, 3), jnp.nan, dtype)], axis=0)
        spos = pos_nan[src_ids]                          # (C_pad, S, 3)
        shift = jnp.stack([shift_comp(d) for d in range(3)], axis=-1)
        return jnp.moveaxis(spos + shift, -1, 0)         # (3, C_pad, S)

    comps = []
    for d in range(3):
        pc = jnp.concatenate(
            [pos[:, d], jnp.full((1,), jnp.nan, dtype)])
        comps.append(pc[src_ids] + shift_comp(d))        # (C_pad, S)
    return jnp.stack(comps)                              # (3, C_pad, S)


def gather_tgt_xyz(pos, cell_table, cap, C_pad, n_cells):
    """Target slot positions (C_pad * cap, 3), NaN pad, via
    per-component gathers (same layout rationale as gather_src_pos)."""
    dtype = pos.dtype
    cols = []
    for d in range(3):
        pc = jnp.concatenate(
            [pos[:, d], jnp.full((1,), jnp.nan, dtype)])
        t = jnp.pad(pc[cell_table], (0, (C_pad - n_cells) * cap),
                    constant_values=jnp.nan)
        cols.append(t)
    return jnp.stack(cols, axis=-1)                      # (C_pad*cap, 3)
