"""Direct-block fused pairwise mobility matvecs (Pallas, Triton route).

One kernel template evaluates the 3x3 RPY/Blake pair blocks *directly*
in registers and contracts them against the source vector, so no pair
block ever reaches device memory. It replaces both XLA formulations for
the hot f32 products on the GPU:

- the SFM rank-1 form (ops/mobility_sfm) amplifies rounding by |q|^2
  and loses about 8 bits in f32;
- the generic tile engine (mobility.pairwise_matvec) streams
  (row_tile, N, 3, 3) pair blocks through device memory.

The work is O(N^2) f32 FMA + rsqrt with a 3-vector output per target;
no tensor cores are involved. Layout: the grid runs over target tiles
only; each program loops over source tiles inside the kernel (masked
loads), keeps its sums in registers and stores once (masked), the shape
of the reference's pycuda kernels (one thread per target, a loop over
all sources).

Couplings (reference kernel family, /root/reference/mobility/mobility_pycuda.py):
  tt    velocity_from_force            (:150)
  tr    velocity_from_torque           (:1516)
  rt    rotation_from_force            (:926)
  rr    rotation_from_torque           (:593)
  grand velocity_from_force_and_torque (:1266) fused with rotation, i.e.
        (U, W) = [[Mtt, Mtr], [Mrt, Mrr]] (F, T) in ONE pass over the
        pair geometry (distances/rsqrts shared by all four blocks).

All math in normalized units (lengths / a, prefactors applied by the
caller); single-wall corrections are the Swan-Brady image system
(mobility_numba.py:241-276, :607-679, :998-1066, :1249-1321). The pair
formulas evaluated at the self geometry (dx=dy=0, Rz=2z, h_hat=1/2)
reproduce the reference's explicit wall self-corrections exactly, so the
wall terms need no self branch; only the unbounded core does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import backend

_NCOMP = {"tt": (3, 3), "tr": (3, 3), "rt": (3, 3), "rr": (3, 3),
          "grand": (6, 6)}

# (target tile, source tile, warps): powers of two, chosen on the card
# for every coupling (PERF.md, "Kernel decisions"; tools/kernel_tiles.py)
TILES = (16, 32, 4)


def _wall_fields(R2, Rz, zs_row):
    """Wall TT scalar fields (Swan-Brady image system) on raw
    (dx, dy, Rz) products: f1, g2, g3, g4, f5 with
    m_ab += f1 delta_ab + g2 e_a e_b + (g3, g4, f5 z-row/col terms)."""
    invR = lax.rsqrt(R2)
    invR2 = invR * invR
    invR3 = invR * invR2
    invR5 = invR3 * invR2
    ez = Rz * invR
    ez2 = ez * ez
    h_hat = zs_row / Rz
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
    return f1, f2 * invR2, f3 * invR, f4 * invR, f5


def _tt_coeffs(r2, invr, self_mask, zero):
    """Unbounded RPY TT coefficients: m_ab = c1 delta_ab + c2 d_a d_b."""
    invr2 = invr * invr
    r = r2 * invr
    far = r > 2.0
    c1 = jnp.where(far, (1.0 + (2.0 / 3.0) * invr2) * invr,
                   (4.0 / 3.0) * (1.0 - 0.28125 * r))
    c2 = jnp.where(far, (1.0 - 2.0 * invr2) * invr2 * invr,
                   (4.0 / 3.0) * 0.09375 * invr)
    c1 = jnp.where(zero, jnp.where(self_mask, 4.0 / 3.0, 0.0), c1)
    c2 = jnp.where(zero, 0.0, c2)
    return c1, c2


def _rr_coeffs(r2, invr, self_mask, zero):
    """Unbounded RPY RR coefficients: m_ab = c1 delta_ab + c2 d_a d_b."""
    invr2 = invr * invr
    invr3 = invr2 * invr
    r = r2 * invr
    far = r >= 2.0
    c1 = jnp.where(far, -0.5 * invr3,
                   1.0 - 0.84375 * r + 0.078125 * (r2 * r))
    c2 = jnp.where(far, 1.5 * invr2 * invr3,
                   0.28125 * invr - 0.046875 * r)
    c1 = jnp.where(zero, jnp.where(self_mask, 1.0, 0.0), c1)
    c2 = jnp.where(zero, 0.0, c2)
    return c1, c2


def _cross_coeff(r2, invr, zero):
    """RPY cross coefficient: m = c [d x] (antisymmetric)."""
    invr3 = invr * invr * invr
    r = r2 * invr
    c = jnp.where(r >= 2.0, invr3, 0.5 * (1.0 - 0.375 * r))
    return jnp.where(zero, 0.0, c)


def _wall_rr_g(R2, Rz):
    """Wall RR scalar set folded onto raw products (rpy.wall_rr):
      mxx = f1 + f4 exy2 + G24 dx^2 ; mxy = G24 dx dy
      mzz = f1 + G2 Rz^2 + g3 Rz ;   mxz = G2 dx Rz ; mzx = G2 Rz dx + g3 dx
    with G2 = f2 invR2, G24 = (f2 - f4) invR2, g3 = f3 invR."""
    invR = lax.rsqrt(R2)
    invR2 = invR * invR
    invR3 = invR * invR2
    ez2 = Rz * Rz * invR2
    f1 = 0.5 * (1.0 - 6.0 * ez2) * invR3
    f2 = -1.5 * invR3
    f4 = 3.0 * invR3
    g3 = (3.0 * invR3 * Rz * invR) * invR  # f3 e_x / dx = 3 invR3 ez invR
    G2 = f2 * invR2
    G24 = (f2 - f4) * invR2
    exy2 = 1.0 - ez2  # ex^2 + ey^2
    A = f1 + f4 * exy2
    return A, G24, G2, g3, f1, ez2, invR3


def _wall_cross_g(R2, Rz, h):
    """Wall cross scalar set of rpy._wall_cross_core folded onto raw
    (dx, dy, Rz): entries use F1 = f1 invR, G3 = f3 invR2, f4 and
    F2 = f2 invR (h is the height argument: z_target for tr, z_source
    for rt)."""
    invR = lax.rsqrt(R2)
    invR2 = invR * invR
    invR4 = invR2 * invR2
    ez = Rz * invR
    ez2 = ez * ez
    h_hat = h / Rz
    f1 = invR2
    f2 = (6.0 * h_hat * ez2 * invR2 + (1.0 - 10.0 * ez2) * invR4) * 2.0
    f3 = -ez * (3.0 * h_hat * invR2 - 5.0 * invR4) * 2.0
    f4 = -ez * (h_hat * invR2 - invR4) * 2.0
    return f1 * invR, f2 * invR, f3 * invR2, f4


def _tt_condense(dx, dy, dz, xy2, r2, invr, self_mask, zero, wall, Rz, zs):
    """Condensed M_tt coefficients (5 scalars per pair): application to
    any number of RHS columns then costs ~10 flops each (the condense
    cost — the dominant per-pair work — is shared, see n_rhs)."""
    c1, c2 = _tt_coeffs(r2, invr, self_mask, zero)
    if wall:
        R2 = xy2 + Rz * Rz
        f1, g2, g3, g4, f5 = _wall_fields(R2, Rz, zs)
        A = c1 + f1
        S = c2 + g2
        P = c2 * dz + g2 * Rz + g3
        Q = c2 * dz + g2 * Rz + g4
        mzz = A + c2 * dz * dz + g2 * Rz * Rz + (g3 + g4) * Rz + f5
    else:
        A = c1
        S = c2
        P = Q = c2 * dz
        mzz = c1 + c2 * dz * dz
    return A, S, P, Q, mzz


def _diag_apply(coeffs, dx, dy, vx, vy, vz):
    """Apply condensed diagonal-block (tt/rr) coefficients to one RHS."""
    A, S, P, Q, mzz = coeffs
    w = dx * vx + dy * vy
    u = S * w + P * vz
    tx = dx * u + A * vx
    ty = dy * u + A * vy
    tz = Q * w + mzz * vz
    return tx, ty, tz


def _rr_condense(dx, dy, dz, xy2, r2, invr, self_mask, zero, wall, Rz):
    c1, c2 = _rr_coeffs(r2, invr, self_mask, zero)
    if wall:
        R2 = xy2 + Rz * Rz
        A_w, G24, G2, g3, f1, ez2, invR3 = _wall_rr_g(R2, Rz)
        A = c1 + A_w
        S = c2 + G24
        P = c2 * dz + G2 * Rz
        Q = c2 * dz + G2 * Rz + g3
        mzz = c1 + c2 * dz * dz + f1 + G2 * Rz * Rz + g3 * Rz
    else:
        A = c1
        S = c2
        P = Q = c2 * dz
        mzz = c1 + c2 * dz * dz
    return A, S, P, Q, mzz


def _cross_condense(dx, dy, dz, xy2, r2, invr, zero, wall, which, Rz, h):
    """Condensed cross-block (tr/rt) entries: the antisymmetric core
    coefficient plus (when wall) the 8 wall-correction matrix entries."""
    c = _cross_coeff(r2, invr, zero)
    if not wall:
        return (c,)
    R2 = xy2 + Rz * Rz
    F1, F2, G3, f4 = _wall_cross_g(R2, Rz, h)
    # UT pattern at (sx*dx, sx*dy): tr flips the in-plane displacement
    s = -1.0 if which == "tr" else 1.0
    ux, uy = s * dx, s * dy
    # core corr entries (rpy._wall_cross_core, folded): then M -= corr,
    # and for rt the pattern transposes.
    cxx = -G3 * ux * uy
    cxy = -F1 * Rz + G3 * ux * ux - f4
    cxz = F1 * uy
    cyx = F1 * Rz - G3 * uy * uy + f4
    cyy = G3 * ux * uy
    cyz = -F1 * ux
    czx = -(F1 + F2) * uy - G3 * uy * Rz
    czy = (F1 + F2) * ux + G3 * ux * Rz
    return (c, cxx, cxy, cxz, cyx, cyy, cyz, czx, czy)


def _cross_apply_condensed(coeffs, dx, dy, dz, which, vx, vy, vz):
    c = coeffs[0]
    tx = c * (dz * vy - dy * vz)
    ty = c * (dx * vz - dz * vx)
    tz = c * (dy * vx - dx * vy)
    if len(coeffs) > 1:
        _, cxx, cxy, cxz, cyx, cyy, cyz, czx, czy = coeffs
        if which == "tr":
            wx = -(cxx * vx + cxy * vy + cxz * vz)
            wy = -(cyx * vx + cyy * vy + cyz * vz)
            wz = -(czx * vx + czy * vy)
        else:  # rt: transpose pattern
            wx = -(cxx * vx + cyx * vy + czx * vz)
            wy = -(cxy * vx + cyy * vy + czy * vz)
            wz = -(cxz * vx + cyz * vy)
        tx = tx + wx
        ty = ty + wy
        tz = tz + wz
    return tx, ty, tz


def _pair_coeffs(coupling, dx, dy, dz, xy2, r2s, invr, self_mask, zero,
                 wall, Rz, zsr, ztr):
    """Condensed pair-block coefficients, evaluated once per pair and
    applied to every right-hand side (multi-RHS solves share them)."""
    if coupling == "grand":
        return (_tt_condense(dx, dy, dz, xy2, r2s, invr, self_mask, zero,
                             wall, Rz, zsr),
                _cross_condense(dx, dy, dz, xy2, r2s, invr, zero, wall,
                                "tr", Rz, ztr),
                _cross_condense(dx, dy, dz, xy2, r2s, invr, zero, wall,
                                "rt", Rz, zsr),
                _rr_condense(dx, dy, dz, xy2, r2s, invr, self_mask, zero,
                             wall, Rz))
    if coupling == "tt":
        return _tt_condense(dx, dy, dz, xy2, r2s, invr, self_mask, zero,
                            wall, Rz, zsr)
    if coupling == "rr":
        return _rr_condense(dx, dy, dz, xy2, r2s, invr, self_mask, zero,
                            wall, Rz)
    if coupling in ("tr", "rt"):
        h = ztr if coupling == "tr" else zsr
        return _cross_condense(dx, dy, dz, xy2, r2s, invr, zero, wall,
                               coupling, Rz, h)
    raise ValueError(coupling)


def _pair_apply(coupling, coeffs, dx, dy, dz, v):
    """Per-pair output components for one RHS (v: the nin source rows)."""
    if coupling == "grand":
        ctt, ctr, crt, crr = coeffs
        fx, fy, fz, tx, ty, tz = v
        # U = Mtt F + Mtr T ; W = Mrt F + Mrr T
        ax, ay, az = _diag_apply(ctt, dx, dy, fx, fy, fz)
        bx, by, bz = _cross_apply_condensed(ctr, dx, dy, dz, "tr",
                                            tx, ty, tz)
        cx, cy, cz = _cross_apply_condensed(crt, dx, dy, dz, "rt",
                                            fx, fy, fz)
        ex, ey, ez = _diag_apply(crr, dx, dy, tx, ty, tz)
        return (ax + bx, ay + by, az + bz, cx + ex, cy + ey, cz + ez)
    if coupling in ("tt", "rr"):
        return _diag_apply(coeffs, dx, dy, *v)
    return _cross_apply_condensed(coeffs, dx, dy, dz, coupling, *v)


def _pair_kernel(*refs, coupling, wall, self_interaction, n_rhs, n_src,
                 n_tgt, bt, bs):
    """One program = `bt` targets. Sources stream through an in-kernel
    loop of `bs`-wide tiles; the sums stay in registers as (bt, bs)
    tiles, reduced over the source axis once, after the loop (a
    reduction per loop step cost 20-25% on the card). Every in-kernel
    constant is a python number (weak-typed), so x64 never promotes the
    pair block."""
    nin1, nout1 = _NCOMP[coupling]
    nin, nout = nin1 * n_rhs, nout1 * n_rhs
    qt, qs, v_refs = refs[0:3], refs[3:6], refs[6:6 + nin]
    out_refs = refs[6 + nin:]
    rows = pl.program_id(0) * bt + jnp.arange(bt, dtype=jnp.int32)
    rmask = rows < n_tgt
    xt = plgpu.load(qt[0].at[rows], mask=rmask, other=0.0)
    yt = plgpu.load(qt[1].at[rows], mask=rmask, other=0.0)
    zt = plgpu.load(qt[2].at[rows], mask=rmask, other=1.0)

    def body(c, acc):
        cols = c * bs + jnp.arange(bs, dtype=jnp.int32)
        cmask = cols < n_src
        xs = plgpu.load(qs[0].at[cols], mask=cmask, other=0.0)
        ys = plgpu.load(qs[1].at[cols], mask=cmask, other=0.0)
        zs = plgpu.load(qs[2].at[cols], mask=cmask, other=1.0)
        # padded sources carry zero strength: their (finite) pair blocks
        # contribute nothing
        v = [plgpu.load(r.at[cols], mask=cmask, other=0.0)[None, :]
             for r in v_refs]
        dx = xt[:, None] - xs[None, :]
        dy = yt[:, None] - ys[None, :]
        dz = zt[:, None] - zs[None, :]
        xy2 = dx * dx + dy * dy
        r2 = xy2 + dz * dz
        if self_interaction:
            self_mask = rows[:, None] == cols[None, :]
        else:
            self_mask = jnp.zeros((bt, bs), dtype=jnp.bool_)
        zero = self_mask | (r2 == 0.0)
        r2s = jnp.where(zero, 1.0, r2)
        invr = lax.rsqrt(r2s)
        Rz = zt[:, None] + zs[None, :] if wall else None
        coeffs = _pair_coeffs(coupling, dx, dy, dz, xy2, r2s, invr,
                              self_mask, zero, wall, Rz, zs[None, :],
                              zt[:, None])
        comps = []
        for b in range(n_rhs):
            comps += _pair_apply(coupling, coeffs, dx, dy, dz,
                                 v[b * nin1:(b + 1) * nin1])
        return tuple(a + t for a, t in zip(acc, comps))

    acc0 = tuple(jnp.zeros((bt, bs), jnp.float32) for _ in range(nout))
    n_tiles = (n_src + bs - 1) // bs
    acc = lax.fori_loop(jnp.int32(0), jnp.int32(n_tiles), body, acc0)
    for r, a in zip(out_refs, acc):
        plgpu.store(r.at[rows], jnp.sum(a, axis=1), mask=rmask)


def pair_matvec_pallas(q_src, q_tgt, vec, *, coupling="tt", wall=True,
                       self_interaction=True, tiles=None, interpret=False):
    """Fused pairwise matvec in normalized units (lengths already / a,
    z heights already shifted; caller applies damping and 1/(8 pi eta a^k)
    prefactors).

    q_src (Ns,3), q_tgt (Nt,3) float32; vec (Ns, 3) — or (Ns, 6) = (F, T)
    for coupling='grand', with T pre-scaled by 1/a relative to F.
    Returns (Nt, 3) (or (Nt, 6) = (U, W a) for 'grand').

    vec may also stack B right-hand sides as (Ns, nin*B) (b-major
    columns): the per-pair geometry and condensed block coefficients are
    evaluated ONCE and applied to every column; returns (Nt, nout*B).

    tiles = (target tile, source tile, warps) overrides TILES. No
    padding: ragged N is handled by masked loads and stores.
    interpret=True runs the Pallas interpreter (tests)."""
    backend.require_kernels(jnp.float32, interpret=interpret,
                            what="pair_matvec_pallas")
    dtype = jnp.float32
    n_src = q_src.shape[0]
    n_tgt = q_tgt.shape[0]
    nin, nout = _NCOMP[coupling]
    n_rhs = vec.reshape(n_src, -1).shape[1] // nin
    bt, bs, warps = tiles or TILES
    v = vec.reshape(n_src, nin * n_rhs).astype(dtype)
    q_src = q_src.astype(dtype)
    q_tgt = q_tgt.astype(dtype)
    args = ([q_tgt[:, k] for k in range(3)] + [q_src[:, k] for k in range(3)]
            + [v[:, k] for k in range(nin * n_rhs)])
    kernel = functools.partial(
        _pair_kernel, coupling=coupling, wall=wall,
        self_interaction=self_interaction, n_rhs=n_rhs, n_src=n_src,
        n_tgt=n_tgt, bt=bt, bs=bs)
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    out = pl.pallas_call(
        kernel,
        grid=((n_tgt + bt - 1) // bt,),
        in_specs=[any_spec] * len(args),
        out_specs=[any_spec] * (nout * n_rhs),
        out_shape=[jax.ShapeDtypeStruct((n_tgt,), dtype)] * (nout * n_rhs),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps,
                                             num_stages=2),
        interpret=interpret,
        name=f"pair_{coupling}",
    )(*args)
    return jnp.stack(out, axis=1)
