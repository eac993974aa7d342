"""Lubrication-corrected dynamics for sphere suspensions near a wall.

Accelerator re-design of the reference Lub_Solver + Lubrication_Class
(/root/reference/Lubrication/Lub_Solver.py:24-1079,
Lubrication/Lubrication_Class.cc:35-700):

  * tabulated resistance scalar functions (Wang-Swan, Jeffrey-Onishi,
    multiblob-consistent, wall) are loaded as device arrays and evaluated
    with vectorized linear interpolation + the analytic near-field
    lubrication asymptotics;
  * the pairwise + wall resistance correction Delta_R = R_Sup - R_MB is
    precomputed per step as per-pair 6x6 blocks: dense-masked for small B
    or on a fixed-capacity neighbor list (`max_neighbors`, O(B K) memory
    with an overflow counter) — the static-shape replacement for the reference's
    cKDTree + scipy-COO sparse assembly;
  * the lubrication-corrected mobility solve
    U = (I + M dR)^{-1}(X + M Xm) runs by right-preconditioned in-XLA
    GMRES with the grand RPY wall mobility applied matrix-free (one fused
    Pallas pass over all four coupling blocks) and a batched
    block-diagonal R_Sup preconditioner with isolated-particle bypass
    replacing the reference's CHOLMOD factorization;
  * `torque_from_omega` solves for the torques that constrain every
    body's angular velocity (the Uniform_Rollers prescribed-spin mode,
    with optional torque-norm cutoff), and `step_trapezoidal` accepts
    omega/cut_torque like Update_Bodies_Trap;
  * Brownian noise uses Lanczos square roots of Delta_R and M, and RFD
    drift, with Euler-Maruyama and stochastic trapezoidal updates and
    wall/jump rejection.

Table files are numeric data in the reference format
(Lubrication/Resistance_Coefs/*.txt); pass their directory to
`LubricationTables.load`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import mobility as mob
from ..ops import quaternion as quat
from ..ops.gmres import gmres
from ..ops.lanczos import stochastic_forcing_lanczos

# Resistance-scalar tables are NUMERIC DATA (published near-field
# hydrodynamic functions: Jeffrey & Onishi 1984 pair scalars, resolved
# 2562-blob wall scalars; reference Lubrication/Resistance_Coefs/*.txt,
# loaded by Lubrication_Class.cc:54-100). The framework vendors them as
# a packaged .npz (tools/vendor_lub_tables.py regenerates it from a
# reference checkout). RMB_TPU_LUB_TABLES overrides with a directory of
# reference-format text tables. DEFAULT_TABLE_DIR is None when the
# packaged data is in use (kept for API compatibility).
DEFAULT_TABLE_DIR = os.environ.get("RMB_TPU_LUB_TABLES")
_PACKAGED_TABLES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "lubrication_tables.npz")


def _read_pair_table(path):
    """Alternating 11/12 rows of (x, X_A, Y_A, Y_B, X_C, Y_C)
    (Lubrication_Class.cc:62-100)."""
    vals = np.fromstring(open(path).read(), sep=" ")
    vals = vals[: (len(vals) // 6) * 6].reshape(-1, 6)
    rows_11 = vals[0::2]
    rows_12 = vals[1::2]
    return rows_11[:, 0].copy(), rows_11[:, 1:].copy(), rows_12[:, 1:].copy()


def _read_wall_table(path, reverse=False):
    vals = np.fromstring(open(path).read(), sep=" ")
    vals = vals[: (len(vals) // 6) * 6].reshape(-1, 6)
    if reverse:
        vals = vals[::-1]
    return vals[:, 0].copy(), vals[:, 1:].copy()


@dataclasses.dataclass(frozen=True)
class LubricationTables:
    ws_x: np.ndarray
    ws_11: np.ndarray
    ws_12: np.ndarray
    jo_x: np.ndarray
    jo_11: np.ndarray
    jo_12: np.ndarray
    mb_x: np.ndarray
    mb_11: np.ndarray
    mb_12: np.ndarray
    wall_sup_x: np.ndarray
    wall_sup: np.ndarray
    wall_mb_x: np.ndarray
    wall_mb: np.ndarray

    @classmethod
    def load(cls, directory=None):
        """Tables from `directory` (reference text format) when given or
        when RMB_TPU_LUB_TABLES is set; the packaged .npz otherwise."""
        directory = directory or DEFAULT_TABLE_DIR
        if directory is None:
            return cls.load_packaged()
        return cls.load_from_dir(directory)

    @classmethod
    def load_packaged(cls):
        with np.load(_PACKAGED_TABLES) as z:
            return cls(**{k: z[k].copy() for k in z.files})

    @classmethod
    def load_from_dir(cls, directory):
        ws = _read_pair_table(os.path.join(directory, "mob_scalars_WS.txt"))
        jo = _read_pair_table(os.path.join(directory, "res_scalars_JO.txt"))
        mb = _read_pair_table(os.path.join(directory, "res_scalars_MB_1.txt"))
        wsup = _read_wall_table(
            os.path.join(directory,
                         "mob_scalars_wall_MB_2562_eig_thresh.txt"),
            reverse=True)
        wmb = _read_wall_table(
            os.path.join(directory, "res_scalars_wall_MB.txt"))
        return cls(ws_x=ws[0], ws_11=ws[1], ws_12=ws[2],
                   jo_x=jo[0], jo_11=jo[1], jo_12=jo[2],
                   mb_x=mb[0], mb_11=mb[1], mb_12=mb[2],
                   wall_sup_x=wsup[0], wall_sup=wsup[1],
                   wall_mb_x=wmb[0], wall_mb=wmb[1])


def _interp_scalars(x_grid, table, r):
    """Vectorized linear interpolation of the 5 scalar columns at r; edge
    values clamp to the first/last row (Lubrication_Class.cc:141-230)."""
    xg = jnp.asarray(x_grid)
    tb = jnp.asarray(table)
    idx = jnp.clip(jnp.searchsorted(xg, r) - 1, 0, len(x_grid) - 2)
    xl = xg[idx]
    xr = xg[idx + 1]
    w = jnp.clip((r - xl) / (xr - xl), 0.0, 1.0)
    vals = tb[idx] * (1 - w[..., None]) + tb[idx + 1] * w[..., None]
    vals = jnp.where((r < xg[0])[..., None], tb[0], vals)
    vals = jnp.where((r > xg[-1])[..., None], tb[-1], vals)
    return vals  # (..., 5): X_A, Y_A, Y_B, X_C, Y_C


def _pair_matrix(scal_11, scal_12, r_hat, mob_factor):
    """Assemble the 12x12 two-sphere matrix from 2x5 scalars
    (Lubrication_Class.cc:165-252). r_hat (...,3)."""
    X11A, Y11A, Y11B, X11C, Y11C = [scal_11[..., k] for k in range(5)]
    X12A, Y12A, Y12B, X12C, Y12C = [scal_12[..., k] for k in range(5)]
    mf0, mf1, mf2 = mob_factor

    sq = r_hat[..., :, None] * r_hat[..., None, :]
    eye = jnp.eye(3, dtype=r_hat.dtype)
    sh = eye - sq
    zeros = jnp.zeros_like(r_hat[..., 0])
    # vortMat in the reference after the -1 flip equals +[r_hat x]
    rx, ry, rz = r_hat[..., 0], r_hat[..., 1], r_hat[..., 2]
    vort = jnp.stack([
        jnp.stack([zeros, -rz, ry], axis=-1),
        jnp.stack([rz, zeros, -rx], axis=-1),
        jnp.stack([-ry, rx, zeros], axis=-1),
    ], axis=-2)

    def A(x, y):
        return mf0 * (x[..., None, None] * sq + y[..., None, None] * sh)

    def B(y, sign):
        return sign * mf1 * y[..., None, None] * vort

    def C(x, y):
        return mf2 * (x[..., None, None] * sq + y[..., None, None] * sh)

    row0 = [A(X11A, Y11A), B(Y11B, -1.0), A(X12A, Y12A), B(Y12B, 1.0)]
    row1 = [B(Y11B, 1.0), C(X11C, Y11C), B(Y12B, 1.0), C(X12C, Y12C)]
    row2 = [A(X12A, Y12A), B(Y12B, -1.0), A(X11A, Y11A), B(Y11B, 1.0)]
    row3 = [B(Y12B, -1.0), C(X12C, Y12C), B(Y11B, -1.0), C(X11C, Y11C)]
    rows = [jnp.concatenate(r, axis=-1) for r in (row0, row1, row2, row3)]
    return jnp.concatenate(rows, axis=-2)  # (...,12,12)


def _at_scalars(r_norm, dtype):
    """Analytic near-field (asymptotic) two-sphere resistance scalars
    (Lubrication_Class.cc:253-306)."""
    eps = r_norm - 2.0
    le = jnp.log(1.0 / eps)
    X11A = 0.995419 + 0.25 / eps + 0.225 * le + 0.0267857 * eps * le
    X12A = -0.350153 - 0.25 / eps - 0.225 * le - 0.0267857 * eps * le
    Y11A = 0.998317 + 0.166667 * le
    Y12A = -0.273652 - 0.166667 * le
    Y11B = -(2.0 / 3.0) * (0.23892 - 0.25 * le - 0.125 * eps * le)
    Y12B = -(2.0 / 3.0) * (-0.162268e-2 + 0.25 * le + 0.125 * eps * le)
    X11C = (4.0 / 3.0) * (1.0518 - 0.125 * eps * le)
    X12C = (4.0 / 3.0) * (-0.150257 + 0.125 * eps * le)
    Y11C = (4.0 / 3.0) * (0.702834 + 0.2 * le + 0.188 * eps * le)
    Y12C = (4.0 / 3.0) * (-0.27464e-1 + 0.05 * le + 0.062 * eps * le)
    s11 = jnp.stack([X11A, Y11A, Y11B, X11C, Y11C], axis=-1)
    s12 = jnp.stack([X12A, Y12A, Y12B, X12C, Y12C], axis=-1)
    return s11.astype(dtype), s12.astype(dtype)


def pair_resistance_sup(r_norm, r_hat, mob_factor, tables, debye_cut):
    """Exact ('super') pair resistance: AT asymptotics for r<2.006, the
    inverse of the interpolated WS mobility for r<2.1, interpolated JO
    resistance otherwise (Lubrication_Class.cc:481-525)."""
    dtype = r_hat.dtype
    eps = r_norm - 2.0
    r_norm = jnp.where(eps < debye_cut, 2.0 + debye_cut, r_norm)

    AT_cut = 2.0 + 0.006 - 1e-8
    WS_cut = 2.0 + 0.1 + 1e-8

    # branch 1: analytic asymptotics
    s11_at, s12_at = _at_scalars(jnp.maximum(r_norm, 2.0 + 1e-8), dtype)
    R_at = _pair_matrix(s11_at, s12_at, r_hat, mob_factor)

    # branch 2: inverse of WS mobility (scalars are mobilities -> assemble
    # with reciprocal prefactors and invert the 12x12)
    s11_ws = _interp_scalars(tables.ws_x, tables.ws_11, r_norm).astype(dtype)
    s12_ws = _interp_scalars(tables.ws_x, tables.ws_12, r_norm).astype(dtype)
    inv_factor = tuple(1.0 / f for f in mob_factor)
    M_ws = _pair_matrix(s11_ws, s12_ws, r_hat, inv_factor)
    R_ws = jnp.linalg.inv(M_ws)

    # branch 3: interpolated JO resistance
    s11_jo = _interp_scalars(tables.jo_x, tables.jo_11, r_norm).astype(dtype)
    s12_jo = _interp_scalars(tables.jo_x, tables.jo_12, r_norm).astype(dtype)
    R_jo = _pair_matrix(s11_jo, s12_jo, r_hat, mob_factor)

    sel_at = (r_norm <= AT_cut)[..., None, None]
    sel_ws = ((r_norm > AT_cut) & (r_norm <= WS_cut))[..., None, None]
    return jnp.where(sel_at, R_at, jnp.where(sel_ws, R_ws, R_jo))


def pair_resistance_mb(r_norm, r_hat, mob_factor, tables, debye_cut):
    """Multiblob-consistent pair resistance (interpolated MB tables,
    Lubrication_Class.cc:527-552)."""
    dtype = r_hat.dtype
    eps = r_norm - 2.0
    r_norm = jnp.where(eps < debye_cut, 2.0 + debye_cut, r_norm)
    s11 = _interp_scalars(tables.mb_x, tables.mb_11, r_norm).astype(dtype)
    s12 = _interp_scalars(tables.mb_x, tables.mb_12, r_norm).astype(dtype)
    return _pair_matrix(s11, s12, r_hat, mob_factor)


def wall_resistance_sup(h, mob_factor, tables, debye_cut, dtype):
    """Wall resistance from resolved-sphere mobility tables with near-field
    lubrication asymptotics (Lubrication_Class.cc:307-411). h = z/a."""
    eps0 = h - 1.0
    eps = jnp.maximum(eps0, debye_cut)
    h_eff = 1.0 + eps
    s = _interp_scalars(tables.wall_sup_x, tables.wall_sup, h_eff)
    Xa_t, Ya_t, Yb_t, Xc_t, Yc_t = [s[..., k].astype(dtype) for k in range(5)]
    # far-field closed forms beyond the table (:336-342)
    far = h_eff > jnp.asarray(tables.wall_sup_x[-1], dtype)
    Xa_t = jnp.where(far, 1.0 - (9.0 / 8.0) / h_eff, Xa_t)
    Ya_t = jnp.where(far, 1.0 - (9.0 / 16.0) / h_eff, Ya_t)
    Yb_t = jnp.where(far, 0.0, Yb_t)
    Xc_t = jnp.where(far, 0.75, Xc_t)
    Yc_t = jnp.where(far, 0.75, Yc_t)

    le = jnp.log(eps)
    Xa_asym = 1.0 / eps - 0.2 * le + 0.971280
    Ya_asym = -(8.0 / 15.0) * le + 0.9588
    Yb_asym = (4.0 / 3.0) * (-(-(0.1) * le - 0.1895) - 0.4576 * eps)
    Xc_asym = (4.0 / 3.0) * (1.2020569 - 3.0 * (jnp.pi**2 / 6.0 - 1.0) * eps)
    Yc_asym = (4.0 / 3.0) * (-0.4 * le + 0.3817 + 1.4578 * eps)

    denom = Ya_t * Yc_t - Yb_t * Yb_t
    RXa = 1.0 / Xa_t
    RYa = Yc_t / denom
    RYb = -Yb_t / denom
    RXc = 1.0 / Xc_t
    RYc = Ya_t / denom

    Xa = jnp.where(h_eff > 1.1, RXa, Xa_asym)
    Ya = jnp.where(h_eff > 1.01, RYa, Ya_asym)
    Yb = jnp.where(h_eff > 1.1, RYb, Yb_asym)
    Xc = jnp.where(h_eff > 1.01, RXc, Xc_asym)
    Yc = jnp.where(h_eff > 1.1, RYc, Yc_asym)
    XcPlus = jnp.maximum(Xc - 4.0 / 3.0, 0.0)
    YcPlus = jnp.maximum(Yc - 4.0 / 3.0, 0.0)
    return _wall_6x6(Xa, Ya, Yb, YcPlus, XcPlus, mob_factor, dtype)


def wall_resistance_mb(h, mob_factor, tables, debye_cut, dtype):
    """Wall resistance from multiblob resistance tables
    (Lubrication_Class.cc:413-479). h = z/a."""
    eps = jnp.maximum(h - 1.0, debye_cut)
    h_eff = 1.0 + eps
    s = _interp_scalars(tables.wall_mb_x, tables.wall_mb, h_eff)
    Xa, Ya, Yb, Xc, Yc = [s[..., k].astype(dtype) for k in range(5)]
    far = h_eff > jnp.asarray(tables.wall_mb_x[-1], dtype)
    Xa = jnp.where(far, 1.0 / (1.0 - (9.0 / 8.0) / h_eff), Xa)
    Ya = jnp.where(far, 1.0 / (1.0 - (9.0 / 16.0) / h_eff), Ya)
    Yb = jnp.where(far, 0.0, Yb)
    Xc = jnp.where(far, 4.0 / 3.0, Xc)
    Yc = jnp.where(far, 4.0 / 3.0, Yc)
    return _wall_6x6(Xa, Ya, Yb, Yc - 4.0 / 3.0, Xc - 4.0 / 3.0,
                     mob_factor, dtype)


def _wall_6x6(Xa, Ya, Yb, YcPlus, XcPlus, mob_factor, dtype):
    """Rows per Lubrication_Class.cc:392-404: diag(Ya-1, Ya-1, Xa-1) on
    translation, (YcPlus, YcPlus, XcPlus) on rotation, +-Yb coupling."""
    mf0, mf1, mf2 = mob_factor
    z = jnp.zeros_like(Xa)
    rows = [
        jnp.stack([mf0 * (Ya - 1.0), z, z, z, mf1 * Yb, z], axis=-1),
        jnp.stack([z, mf0 * (Ya - 1.0), z, -mf1 * Yb, z, z], axis=-1),
        jnp.stack([z, z, mf0 * (Xa - 1.0), z, z, z], axis=-1),
        jnp.stack([z, -mf1 * Yb, z, mf2 * YcPlus, z, z], axis=-1),
        jnp.stack([mf1 * Yb, z, z, z, mf2 * YcPlus, z], axis=-1),
        jnp.stack([z, z, z, z, z, mf2 * XcPlus], axis=-1),
    ]
    return jnp.stack(rows, axis=-2).astype(dtype)


# ---------------------------------------------------------------------------
# Delta_R block assembly and application
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LubSolver:
    """Static configuration (Lub_Solver.py:29-96)."""

    num_bodies: int
    eta: float = 1.0
    a: float = 1.0
    kT: float = 0.0
    dt: float = 1e-3
    cutoff: float = 4.5           # pair cutoff in units of a (Lub_Cut)
    cutoff_wall: float = 4.5      # wall cutoff in units of a
    debye_cut: float = 1e-2       # firm_delta: clamp of the gap
    rf_delta: float = 1e-3
    periodic_length: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    solver_tolerance: float = 1e-6
    lanczos_max_iter: int = 100
    # if set, Delta_R is assembled on a fixed-capacity neighbor list
    # (O(B K) memory, the static-shape replacement for the reference's cKDTree+COO
    # sparse path); None keeps the dense-masked O(B^2) blocks
    max_neighbors: Optional[int] = None
    use_pc: bool = True           # precondition (I + M dR) like Lub_Solver
    tables: Optional[LubricationTables] = None
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)

    @property
    def mob_factor(self):
        return (6.0 * np.pi * self.eta * self.a,
                6.0 * np.pi * self.eta * self.a**2,
                6.0 * np.pi * self.eta * self.a**3)

    @property
    def mobility_kwargs(self):
        kw = dict(domain="single_wall", periodic_length=self.periodic_length)
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        return kw


class DeltaRBlocks(NamedTuple):
    diag: jax.Array     # (B,6,6) summed self blocks + wall blocks
    offdiag: jax.Array  # (B,B,6,6) masked pair coupling blocks
    diag_sup: jax.Array = None   # (B,6,6) R_Sup diagonal blocks (for PC)
    diag_mb: jax.Array = None    # (B,6,6) R_MB diagonal blocks (for PC)
    isolated: jax.Array = None   # (B,) no neighbors and far from wall


class SparseDeltaR(NamedTuple):
    """Delta_R on a fixed-capacity neighbor list: O(B K) memory, the
    static-shape equivalent of the reference's cKDTree + C++ COO assembly
    (Lub_Solver.py:98-186, Lubrication_Class.cc:554-700)."""

    idx: jax.Array       # (B,K) neighbor indices (self-padded)
    mask: jax.Array      # (B,K) True where a real in-range neighbor
    diag: jax.Array      # (B,6,6) Delta_R diagonal blocks incl. wall
    off: jax.Array       # (B,K,6,6) Delta_R coupling blocks j->idx[j,k]
    diag_sup: jax.Array  # (B,6,6)
    diag_mb: jax.Array   # (B,6,6)
    isolated: jax.Array  # (B,)
    overflow: jax.Array  # () int32: true neighbors beyond capacity K


def _wall_blocks(sol: LubSolver, pos, dtype):
    """(W_sup, W_mb, wall_on) per body."""
    h = pos[:, 2] / sol.a
    W_sup = wall_resistance_sup(h, sol.mob_factor, sol.tables,
                                sol.debye_cut, dtype)
    W_mb = wall_resistance_mb(h, sol.mob_factor, sol.tables,
                              sol.debye_cut, dtype)
    wall_on = h < sol.cutoff_wall
    on = wall_on[:, None, None]
    return jnp.where(on, W_sup, 0.0), jnp.where(on, W_mb, 0.0), wall_on


def compute_delta_r_blocks(sol: LubSolver, pos) -> DeltaRBlocks:
    """Delta_R = R_Sup - R_MB as per-pair blocks (Set_R_Mats,
    Lub_Solver.py:98-275). Dense-masked over all pairs; use
    `compute_delta_r_sparse` (sol.max_neighbors) for large B."""
    dtype = pos.dtype
    B = sol.num_bodies
    tables = sol.tables

    d = mob._min_image(pos[:, None, :] - pos[None, :, :],
                       tuple(sol.periodic_length)) / sol.a
    r2 = jnp.sum(d * d, axis=-1)
    self_mask = jnp.eye(B, dtype=bool)
    r_norm = jnp.sqrt(jnp.where(self_mask, 4.0, r2))
    # reference: r_hat = -(r_j - r_k)/|.| points from j to k
    r_hat = -d / r_norm[..., None]
    in_range = (~self_mask) & (r_norm < sol.cutoff)

    R_sup = pair_resistance_sup(r_norm, r_hat, sol.mob_factor, tables,
                                sol.debye_cut)
    R_mb = pair_resistance_mb(r_norm, r_hat, sol.mob_factor, tables,
                              sol.debye_cut)
    keep = in_range[..., None, None]
    R_sup = jnp.where(keep, R_sup, 0.0)
    R_mb = jnp.where(keep, R_mb, 0.0)
    dR = R_sup - R_mb

    diag = jnp.sum(dR[:, :, 0:6, 0:6], axis=1)       # sum_k jj blocks
    offdiag = dR[:, :, 0:6, 6:12]                    # jk blocks

    W_sup, W_mb, wall_on = _wall_blocks(sol, pos, dtype)
    diag_sup = jnp.sum(R_sup[:, :, 0:6, 0:6], axis=1) + W_sup
    diag_mb = jnp.sum(R_mb[:, :, 0:6, 0:6], axis=1) + W_mb
    diag = diag + W_sup - W_mb
    isolated = (~jnp.any(in_range, axis=1)) & (~wall_on)
    return DeltaRBlocks(diag=diag, offdiag=offdiag, diag_sup=diag_sup,
                        diag_mb=diag_mb, isolated=isolated)


def compute_delta_r_sparse(sol: LubSolver, pos) -> SparseDeltaR:
    """Delta_R on a fixed-capacity neighbor list (K = sol.max_neighbors).

    Neighbor search is an O(B^2) distance sweep (only (B,B) scalars, never
    (B,B,6,6) blocks) keeping the K nearest in-range bodies per row; the
    `overflow` counter reports true neighbors dropped past capacity so a
    driver can fail loudly rather than silently truncate."""
    K = int(sol.max_neighbors)
    dtype = pos.dtype
    B = sol.num_bodies
    L = tuple(sol.periodic_length)

    d_all = mob._min_image(pos[:, None, :] - pos[None, :, :], L) / sol.a
    r2 = jnp.sum(d_all * d_all, axis=-1)
    self_mask = jnp.eye(B, dtype=bool)
    in_range = (~self_mask) & (r2 < sol.cutoff * sol.cutoff)
    counts = jnp.sum(in_range, axis=1)
    overflow = jnp.maximum(jnp.max(counts) - K, 0).astype(jnp.int32)

    r2_sort = jnp.where(in_range, r2, jnp.inf)
    order = jnp.argsort(r2_sort, axis=1)[:, :K]                 # (B,K)
    mask = jnp.take_along_axis(in_range, order, axis=1)         # (B,K)
    idx = jnp.where(mask, order, jnp.arange(B)[:, None])        # self-pad

    pos_k = pos[idx]                                            # (B,K,3)
    d = mob._min_image(pos[:, None, :] - pos_k, L) / sol.a
    r_norm = jnp.sqrt(jnp.where(mask, jnp.sum(d * d, axis=-1), 16.0))
    r_hat = -d / r_norm[..., None]

    R_sup = pair_resistance_sup(r_norm, r_hat, sol.mob_factor, sol.tables,
                                sol.debye_cut)
    R_mb = pair_resistance_mb(r_norm, r_hat, sol.mob_factor, sol.tables,
                              sol.debye_cut)
    keep = mask[..., None, None]
    R_sup = jnp.where(keep, R_sup, 0.0)
    R_mb = jnp.where(keep, R_mb, 0.0)
    dR = R_sup - R_mb

    W_sup, W_mb, wall_on = _wall_blocks(sol, pos, dtype)
    diag_sup = jnp.sum(R_sup[:, :, 0:6, 0:6], axis=1) + W_sup
    diag_mb = jnp.sum(R_mb[:, :, 0:6, 0:6], axis=1) + W_mb
    diag = jnp.sum(dR[:, :, 0:6, 0:6], axis=1) + W_sup - W_mb
    off = dR[:, :, 0:6, 6:12]
    isolated = (~jnp.any(mask, axis=1)) & (~wall_on)
    return SparseDeltaR(idx=idx, mask=mask, diag=diag, off=off,
                        diag_sup=diag_sup, diag_mb=diag_mb,
                        isolated=isolated, overflow=overflow)


def compute_blocks(sol: LubSolver, pos):
    """Dense-masked or neighbor-list Delta_R per sol.max_neighbors."""
    if sol.max_neighbors is not None:
        return compute_delta_r_sparse(sol, pos)
    return compute_delta_r_blocks(sol, pos)


def delta_r_mult(blocks, X):
    """Delta_R @ X for X (6B,) in interleaved [F_1 T_1 F_2 T_2 ...]
    layout (dense-masked or neighbor-list blocks)."""
    B = blocks.diag.shape[0]
    x = X.reshape(B, 6)
    out = jnp.einsum("bij,bj->bi", blocks.diag, x)
    if isinstance(blocks, SparseDeltaR):
        xk = x[blocks.idx] * blocks.mask[..., None]
        out = out + jnp.einsum("bkij,bkj->bi", blocks.off, xk)
    else:
        out = out + jnp.einsum("bkij,kj->bi", blocks.offdiag, x)
    return out.reshape(-1)


def delta_r_sub_mult(blocks, v3, rows=slice(3, 6), cols=slice(0, 3)):
    """Apply a 3x3 sub-block family of Delta_R (e.g. the rot-trans
    coupling used by the Torque_from_Omega preconditioner,
    Lub_Solver.py:962-975) to a (3B,) vector."""
    B = blocks.diag.shape[0]
    v = v3.reshape(B, 3)
    out = jnp.einsum("bij,bj->bi", blocks.diag[:, rows, cols], v)
    if isinstance(blocks, SparseDeltaR):
        vk = v[blocks.idx] * blocks.mask[..., None]
        out = out + jnp.einsum("bkij,bkj->bi", blocks.off[:, :, rows, cols],
                               vk)
    else:
        out = out + jnp.einsum("bkij,kj->bi", blocks.offdiag[:, :, rows, cols],
                               v)
    return out.reshape(-1)


def make_lub_pc(sol: LubSolver, blocks):
    """Right preconditioner for (I + M dR): the in-XLA replacement for the
    reference's CHOLMOD-factorized R_Sup PC with isolated-particle bypass
    (Lubrucation_solve, Lub_Solver.py:541-588; IpMDR_PC :426-443).

    Instead of a sparse Cholesky of the full R_Sup, factor its 6x6
    block diagonal batched (one vmapped Cholesky over bodies): the wall
    lubrication and the summed near-contact pair stiffness — the terms
    that blow up the (I + M dR) spectrum — live on that diagonal.
    PC(X) = R_MB,diag (R_Sup,diag + small I)^{-1} X, identity on isolated
    bodies (where R_MB = 0 and the reference bypasses too)."""
    small = 6.0 * np.pi * sol.eta * sol.a * sol.solver_tolerance
    A = blocks.diag_sup + small * jnp.eye(6, dtype=blocks.diag_sup.dtype)
    chol = jax.vmap(jnp.linalg.cholesky)(A)
    iso = blocks.isolated[:, None]

    def pc(X):
        x = X.reshape(-1, 6)
        y = jax.vmap(
            lambda c, b: jax.scipy.linalg.cho_solve((c, True), b))(chol, x)
        y = jnp.einsum("bij,bj->bi", blocks.diag_mb, y)
        return jnp.where(iso, x, y).reshape(-1)

    return pc


def wall_mobility_mult(sol: LubSolver, pos, X):
    """Grand RPY wall mobility times interleaved (F,T) vector
    (Lub_Solver.py:277-307)."""
    B = sol.num_bodies
    ft = X.reshape(B, 6)
    u, w = mob.grand_mobility_matvec(pos, ft[:, 0:3], ft[:, 3:6], sol.eta,
                                     sol.a, **sol.mobility_kwargs)
    return jnp.concatenate([u, w], axis=1).reshape(-1)


def lub_solve(sol: LubSolver, pos, blocks, X=None, Xm=None,
              x0=None, maxiter=1000, restart=100):
    """U = (I + M dR)^{-1} (X + M Xm) by right-preconditioned GMRES
    (Lubrucation_solve, Lub_Solver.py:518-604). Returns (U, iterations)."""
    n = 6 * sol.num_bodies
    dtype = pos.dtype
    rhs = jnp.zeros(n, dtype)
    if Xm is not None:
        rhs = rhs + wall_mobility_mult(sol, pos, Xm.reshape(-1))
    if X is not None:
        rhs = rhs + X.reshape(-1)

    def op(v):
        return v + wall_mobility_mult(sol, pos, delta_r_mult(blocks, v))

    pc = make_lub_pc(sol, blocks) if sol.use_pc else None
    rhs_norm = jnp.linalg.norm(rhs)
    safe = jnp.where(rhs_norm > 0, rhs_norm, 1.0)
    if x0 is not None:
        x0 = x0 / safe
    res = gmres(op, rhs / safe, x0=x0, tol=sol.solver_tolerance,
                restart=restart, maxiter=maxiter, M=pc)
    return res.x * rhs_norm, res.iterations


def lub_rfd_solve(sol: LubSolver, pos, blocks: DeltaRBlocks, X,
                  maxiter=1000, restart=100):
    """(I + dR M)^{-1} X — the transposed system (Lub_Solver.py:478-517)."""
    def op(v):
        return v + delta_r_mult(blocks, wall_mobility_mult(sol, pos, v))

    rhs_norm = jnp.linalg.norm(X)
    safe = jnp.where(rhs_norm > 0, rhs_norm, 1.0)
    res = gmres(op, X.reshape(-1) / safe, tol=sol.solver_tolerance,
                restart=restart, maxiter=maxiter)
    return res.x * rhs_norm, res.iterations


def torque_from_omega(sol: LubSolver, pos, blocks, omega, F,
                      cut_torque=None, maxiter=100, restart=100):
    """Torques that (approximately) constrain every body's angular
    velocity to `omega` given forces F — the reference's
    Torque_from_Omega (Lub_Solver.py:890-1025), used by the
    Uniform_Rollers driver (BASELINE config 5).

    Solves for (V, T):  -(I + M dR) [V; 0] + M [0; T] = (I + M dR)[0; w]
    - M [F; 0], preconditioned with the batched block factorization of
    (6 pi eta a I + dR_tt) replacing the reference's sparse CHOLMOD
    (:962-975). omega: (3,) or (B,3). Returns (T, VO_guess)."""
    B = sol.num_bodies
    dtype = pos.dtype
    omega = jnp.asarray(omega, dtype)
    if omega.ndim == 0:
        # reference convention: scalar spins about y_hat (:927-929)
        omega = jnp.stack([jnp.zeros_like(omega), omega,
                           jnp.zeros_like(omega)])
    omega = jnp.broadcast_to(omega.reshape(-1, 3)[-1] if omega.ndim == 1
                             else omega, (B, 3))
    F = F.reshape(B, 3).astype(dtype)
    c1 = 6.0 * np.pi * sol.eta * sol.a
    c2 = 8.0 * np.pi * sol.eta * sol.a ** 3

    def ipmdr(v):
        return v + wall_mobility_mult(sol, pos, delta_r_mult(blocks, v))

    def pack(V, T):
        return jnp.concatenate([V, T], axis=1).reshape(-1)

    zeros3 = jnp.zeros((B, 3), dtype)
    rhs = ipmdr(pack(zeros3, omega)) - wall_mobility_mult(
        sol, pos, pack(F, zeros3))

    def op(vt):
        x = vt.reshape(B, 6)
        V, T = x[:, 0:3], x[:, 3:6]
        out = ipmdr(pack(-V, zeros3)) + wall_mobility_mult(
            sol, pos, pack(zeros3, T))
        return out

    # PC: V-block from batched (c1 I + dR_tt,diag) factors; T-block
    # c2 ab_rot + dR_rt V (Lub_Solver.py:955-975)
    Vmat = blocks.diag[:, 0:3, 0:3] + c1 * jnp.eye(3, dtype=dtype)
    chol = jax.vmap(jnp.linalg.cholesky)(Vmat)

    def pc(ab):
        x = ab.reshape(B, 6)
        a = -c1 * x[:, 0:3]
        v = jax.vmap(lambda c, b: jax.scipy.linalg.cho_solve((c, True), b))(
            chol, a)
        t = c2 * x[:, 3:6] + delta_r_sub_mult(blocks, v.reshape(-1)).reshape(
            B, 3)
        return pack(v, t)

    rhs_norm = jnp.linalg.norm(rhs)
    safe = jnp.where(rhs_norm > 0, rhs_norm, 1.0)
    x0 = pack(zeros3, c2 * omega) / safe
    res = gmres(op, rhs / safe, x0=x0, tol=sol.solver_tolerance,
                restart=restart, maxiter=maxiter, M=pc)
    vt = (res.x * rhs_norm).reshape(B, 6)
    T = vt[:, 3:6]
    if cut_torque is not None:
        Tn = jnp.linalg.norm(T, axis=1)
        scale = jnp.where(Tn > 0, jnp.minimum(Tn, cut_torque)
                          / jnp.where(Tn > 0, Tn, 1.0), 1.0)
        T = T * scale[:, None]
    vo_guess = pack(vt[:, 0:3], omega)
    return T, vo_guess, res.iterations


def mobility_root_rhs(sol: LubSolver, pos, blocks: DeltaRBlocks, key):
    """sqrt(2kT/dt) (dR^{1/2} W1, M^{1/2} W2) via Lanczos on the shifted
    Delta_R and on M (Lub_Solver.py:373-407; the reference uses CHOLMOD
    for dR^{1/2} — here both roots are matrix-free)."""
    n = 6 * sol.num_bodies
    dtype = pos.dtype
    k1, k2 = jax.random.split(key)
    W1 = jax.random.normal(k1, (n,), dtype)
    W2 = jax.random.normal(k2, (n,), dtype)
    small = 6.0 * jnp.pi * sol.eta * sol.a * sol.solver_tolerance
    factor = jnp.sqrt(2.0 * sol.kT / sol.dt)

    res_dr = stochastic_forcing_lanczos(
        lambda v: delta_r_mult(blocks, v) + small * v, W1, factor=factor,
        tolerance=sol.solver_tolerance, max_iter=sol.lanczos_max_iter)
    res_m = stochastic_forcing_lanczos(
        lambda v: wall_mobility_mult(sol, pos, v), W2, factor=factor,
        tolerance=sol.solver_tolerance, max_iter=sol.lanczos_max_iter)
    iters = res_dr.iterations + res_m.iterations
    return res_dr.noise, res_m.noise, iters


def rfd_rhs(sol: LubSolver, pos, blocks: DeltaRBlocks, key):
    """RFD divergence RHS pair (Lub_Mobility_RFD_RHS,
    Lub_Solver.py:309-342). Returns (RHS_Xm, RHS_X, gmres_its)."""
    n = 6 * sol.num_bodies
    dtype = pos.dtype
    W = jax.random.normal(key, (n,), dtype)
    Wrfd = W.reshape(sol.num_bodies, 6)[:, 0:3]
    Qp = pos + (sol.rf_delta / 2.0) * Wrfd
    Qm = pos - (sol.rf_delta / 2.0) * Wrfd

    blocks_p = compute_blocks(sol, Qp)
    blocks_m = compute_blocks(sol, Qm)

    UWrfd, its = lub_rfd_solve(sol, pos, blocks, W)
    MUW = wall_mobility_mult(sol, pos, UWrfd)
    rhs_xm = (delta_r_mult(blocks_m, MUW) - delta_r_mult(blocks_p, MUW)) / sol.rf_delta

    MpW = wall_mobility_mult(sol, Qp, UWrfd)
    MmW = wall_mobility_mult(sol, Qm, UWrfd)
    rhs_x = (MpW - MmW) / sol.rf_delta
    return rhs_xm, rhs_x, its


# ---------------------------------------------------------------------------
# Time stepping
# ---------------------------------------------------------------------------


class LubStepAux(NamedTuple):
    velocities: jax.Array
    det_iterations: jax.Array
    stoch_iterations: jax.Array
    rejections_wall: jax.Array
    rejections_jump: jax.Array


def _check_jump(sol: LubSolver, pos_new, pos_old):
    """Wall + max-displacement rejection (Lub_Solver.py:1027-1079)."""
    wall_bad = jnp.any(pos_new[:, 2] < 0.0)
    disp = mob._min_image(pos_new - pos_old, tuple(sol.periodic_length))
    jump_bad = jnp.any(jnp.linalg.norm(disp, axis=1) > 2.0 * sol.a)
    return wall_bad, jump_bad


def step_euler_maruyama(sol: LubSolver, pos, quats, key, ft_calc):
    """Lubrication-corrected EM step (Update_Bodies,
    Lub_Solver.py:641-663, :722-747). ft_calc(pos) -> (B,6) interleaved.
    Rejected steps keep the old state (single-shot, as the reference)."""
    dtype = pos.dtype
    blocks = compute_blocks(sol, pos)
    FT = ft_calc(pos).reshape(-1)
    k1, k2 = jax.random.split(key)
    stoch_its = jnp.asarray(0)
    if sol.kT > 0:
        root_xm, root_x, it_l = mobility_root_rhs(sol, pos, blocks, k1)
        drift_xm, drift_x, it_d = rfd_rhs(sol, pos, blocks, k2)
        rhs_xm = root_xm + sol.kT * drift_xm + FT
        rhs_x = root_x + sol.kT * drift_x
        stoch_its = it_l
    else:
        rhs_xm = FT
        rhs_x = None
    vel, its = lub_solve(sol, pos, blocks, X=rhs_x, Xm=rhs_xm)
    v = vel.reshape(sol.num_bodies, 6)
    pos_new = pos + sol.dt * v[:, 0:3]
    quat_new = quat.step(quats, v[:, 3:6], sol.dt)
    wall_bad, jump_bad = _check_jump(sol, pos_new, pos)
    reject = wall_bad | jump_bad
    pos_out = jnp.where(reject, pos, pos_new)
    quat_out = jnp.where(reject, quats, quat_new)
    aux = LubStepAux(velocities=v, det_iterations=its,
                     stoch_iterations=stoch_its,
                     rejections_wall=wall_bad.astype(jnp.int32),
                     rejections_jump=(jump_bad & ~wall_bad).astype(jnp.int32))
    return pos_out, quat_out, aux


def step_trapezoidal(sol: LubSolver, pos, quats, key, ft_calc,
                     omega=None, cut_torque=None):
    """Stochastic trapezoidal update (Update_Bodies_Trap,
    Lub_Solver.py:749-888). If `omega` is given, per-body torques that
    constrain the angular velocity are solved for and injected before the
    predictor (and reused in the corrector, the reference's
    second_order=False path, :838-851), optionally norm-capped at
    `cut_torque` — the Uniform_Rollers prescribed-spin mode."""
    dtype = pos.dtype
    blocks = compute_blocks(sol, pos)
    FT = ft_calc(pos).reshape(-1)
    vo_guess = None
    torque_its = jnp.asarray(0)
    if omega is not None:
        ftr = FT.reshape(sol.num_bodies, 6)
        T_omega, vo_guess, torque_its = torque_from_omega(
            sol, pos, blocks, omega, ftr[:, 0:3], cut_torque=cut_torque)
        FT = ftr.at[:, 3:6].add(T_omega).reshape(-1)
    k1, k2 = jax.random.split(key)

    root_xm, root_x, it_l = mobility_root_rhs(sol, pos, blocks, k1)
    m_half = root_x + wall_mobility_mult(sol, pos, root_xm)

    vel_p, its1 = lub_solve(sol, pos, blocks, X=m_half, Xm=FT,
                            x0=vo_guess)
    vp = vel_p.reshape(sol.num_bodies, 6)
    pos_mid = pos + sol.dt * vp[:, 0:3]
    quat_mid = quat.step(quats, vp[:, 3:6], sol.dt)

    blocks_mid = compute_blocks(sol, pos_mid)

    # RFD drift for M (Lub_Solver.py:810-822)
    W = jax.random.normal(k2, (6 * sol.num_bodies,), dtype)
    Wrfd = W.reshape(sol.num_bodies, 6)[:, 0:3]
    Qp = pos + (sol.rf_delta / 2.0) * Wrfd
    Qm = pos - (sol.rf_delta / 2.0) * Wrfd
    d_m = (2.0 * sol.kT / sol.rf_delta) * (
        wall_mobility_mult(sol, Qp, W) - wall_mobility_mult(sol, Qm, W))

    FT_c = ft_calc(pos_mid).reshape(-1)
    if omega is not None:
        ftc = FT_c.reshape(sol.num_bodies, 6)
        FT_c = ftc.at[:, 3:6].add(T_omega).reshape(-1)
    vel_c, its2 = lub_solve(sol, pos_mid, blocks_mid, X=d_m + m_half,
                            Xm=FT_c, x0=vel_p)
    v = 0.5 * (vel_p + vel_c).reshape(sol.num_bodies, 6)

    pos_new = pos + sol.dt * v[:, 0:3]
    quat_new = quat.step(quats, v[:, 3:6], sol.dt)
    wall_bad, jump_bad = _check_jump(sol, pos_new, pos)
    reject = wall_bad | jump_bad
    pos_out = jnp.where(reject, pos, pos_new)
    quat_out = jnp.where(reject, quats, quat_new)
    aux = LubStepAux(velocities=v, det_iterations=its1 + its2 + torque_its,
                     stoch_iterations=it_l,
                     rejections_wall=wall_bad.astype(jnp.int32),
                     rejections_jump=(jump_bad & ~wall_bad).astype(jnp.int32))
    return pos_out, quat_out, aux
