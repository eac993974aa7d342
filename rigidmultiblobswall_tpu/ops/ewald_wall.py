"""Spectral single-wall RPY mobility — the O(N log N) wall-bounded engine.

The reference's flagship domain (suspensions above a no-slip wall,
mobility/mobility.py:1018-1116) is accelerated in its ecosystem by an
external wall-Stokeslet FMM (mobility/mobility_fmm.f90:10-25) and the
DPStokes spectral backend (empty submodule). This module is the
accelerator answer: a doubly-periodic-xy / open-z spectral Ewald method
built from three pieces (all derived in this repo, see
tools/gen_wall_channels.py):

1. **Image sources.** The Swan-Brady wall correction decomposes exactly
   as W(R, h) = -RPY_s2(R).D + T0(R) + h T1(R) + h^2 T2(R) (R = image
   displacement, h = source height, D = diag(1,1,-1)). The image
   Stokeslet rides the EXISTING sinc^2 spectral channel as extra
   sources with strength -D f at the image points; T0..T2 are three
   additional gridded channels with strengths h^m f whose k-space
   multipliers are rational (generated `mult_terms`).

2. **Aperiodic z by zero padding + polish modes.** The z axis is not
   physically periodic: the FFT box is padded (z_pad_factor x the data
   extent), which makes the kernel periodization error e^{-k_par *
   margin} — negligible for all but the smallest in-plane modes. Those
   "polish" columns (including k_par = 0, which carries the Couette
   mean flow) are cut out of the FFT multiplier and applied EXACTLY as
   dense z-Toeplitz convolutions built from continuous-k_z quadrature
   (ops/wall_kernels.build_polish_kernels), with analytic finite parts
   at k = 0.

3. **Near field.** The same Hasimoto split as the periodic engine: the
   real-real (and image-Stokeslet) remainder reuses the quadrature
   Chebyshev tables of ops/ewald.py; the T_m channels subtract their
   screened counterparts via the closed-form radial generators g4, g2
   (ops/wall_kernels.img_cheb_tables) inside the same fixed-capacity
   cell sweep, evaluated in blob-radius units for f32 conditioning.

Overlap regularization matches the reference (mobility/mobility.py:
52-119): blob heights are shifted to z >= a and the product is damped
B^T M(z_eff) B; the apply_* wrappers fold this in.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import cells, ewald, wall_kernels
from . import _wall_channels_gen as gen

# z cell height in units of r_cut: the excess over 1.0 is drift slack
# shared between the cheap plan-refresh budget and binning robustness
Z_CELL_SLACK = 1.2


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WallParams:
    """Static configuration of the wall engine for one
    (box_xy, slab, a, eta, accuracy)."""

    a: float
    eta: float
    box_xy: Tuple[float, float]
    z_hi: float                # top of the real-particle slab
    xi: float
    r_cut: float
    grid: Tuple[int, int, int]  # (gx, gy, gz) of the PADDED z box
    z0: float                  # physical z of grid plane 0 (negative)
    support: int = 9
    es_beta_factor: float = 0.98
    oversample: float = 1.5
    n_table: int = 2048
    cell_capacity: int = 0
    bucket_capacity: int = 0
    plane_batch: int = 4
    precision: str = "highest"
    cell_tile: int = 8
    n_cheb: int = 0
    z_pad_factor: float = 2.0
    tol: float = 1e-4
    # z-Chebyshev order of the closed-form wave noise sampler
    # (wave_sqrt_noise); 0 auto-sizes from the kernel's spectral content
    # (the per-mode z-kernels are entire with Gaussian-decaying k_z
    # content up to ~2 xi sqrt(ln 1/tol): p ~ content * range / pi),
    # < 0 disables (deterministic runs skip the factor tables entirely)
    noise_p: int = 0
    noise_pk: int = 0

    def noise_orders(self):
        """Resolved (p, pk) for the wave-noise factor tables.

        p balances two limits: the kernel's analytic z-content
        (~2 xi sqrt(ln 1/tol) radians over the half-slab) wants p UP;
        the grid's ability to carry the Chebyshev cardinal functions
        through the z-window deconvolution wants p DOWN (edge nodes
        cluster as half * (pi/p)^2 / 2 and anything much below a grid
        spacing is unrepresentable — measured: edge spacing 0.23 hz
        fits at 3.5e-4 residual, 0.11 hz blows up to 3e-2)."""
        s = math.sqrt(max(-math.log(0.02 * self.tol), 4.0))
        kz_eff = 2.0 * self.xi * s
        half = 0.5 * (self.z_hi - self.a)
        hz = self.spacing[2]
        p_need = int(math.ceil(kz_eff * half / math.pi)) + 8
        p_grid = 1 + int(math.pi * math.sqrt(2.0 * half / hz))
        p = self.noise_p or min(max(min(p_need, p_grid), 8), 40)
        # k_par content: e^{-k_par (z+z')} structure resolved over
        # [0, k_cut ~ kz_eff]; empirical + safety margin
        pk = self.noise_pk or min(max(int(math.ceil(
            1.2 * kz_eff * 2.0 * self.z_hi / math.pi)) + 16, 32), 96)
        return p, pk

    @property
    def spacing(self):
        gx, gy, gz = self.grid
        Lx, Ly = self.box_xy
        return (Lx / gx, Ly / gy, self.lz_box / gz)

    @property
    def lz_box(self) -> float:
        """Padded z period; hz is chosen so gz * hz = z_pad_factor * LD
        exactly at build time — stored via grid + data extent."""
        return self.grid[2] * self._hz

    @property
    def _hz(self) -> float:
        # hz is fixed at construction: LD = -2 z0 (data is centered on 0)
        return self.z_pad_factor * (-2.0 * self.z0) / self.grid[2]

    @property
    def data_extent(self) -> float:
        return -2.0 * self.z0

    @property
    def es_beta(self):
        return (self.es_beta_factor * math.pi * self.support
                * (1.0 - 0.5 / self.oversample))

    def grid_params(self) -> ewald.EwaldParams:
        """An EwaldParams view of the padded box (geometry fields only)
        so the z-slab gridding machinery of ops/ewald.py is reused
        verbatim for spreading/interpolation."""
        return ewald.EwaldParams(
            a=self.a, eta=self.eta,
            box=(self.box_xy[0], self.box_xy[1], self.lz_box),
            xi=self.xi, r_cut=self.r_cut, grid=self.grid,
            support=self.support, es_beta_factor=self.es_beta_factor,
            oversample=self.oversample, n_table=self.n_table,
            cell_capacity=max(self.cell_capacity, 1),
            bucket_capacity=self.bucket_capacity,
            plane_batch=self.plane_batch, precision=self.precision,
            cell_tile=self.cell_tile, n_cheb=self.n_cheb,
            near_impl="xla", tol=self.tol)


def default_wall_params(a, eta, box_xy, z_hi, *, tol=1e-4,
                        r_cut_factor=None, support=None, oversample=1.5,
                        grid_max=1024, z_pad_factor=1.8,
                        **kw) -> WallParams:
    """Parameter heuristics, mirroring ewald.default_params with two
    wall-specific changes: (a) the split margin s is enlarged (the
    T1/T2 remainders carry polynomial s-prefactors from their extra
    derivatives), (b) the z grid covers the padded slab
    [z0, z0 + z_pad_factor * LD], LD = 2 (z_hi + window)."""
    if support is None:
        support = int(min(max(math.ceil(
            (5.5 - math.log(0.3 * tol)) / 1.81), 6), 14))
    # split margin: tol*0.02 inside the log was measured to deliver
    # ~tol/10 matvec error on the lattice-sum oracle (the round-3
    # original tol*2e-4 delivered tol/100 and paid ~1.35x in grid +
    # r_cut for accuracy nobody asked for)
    s = math.sqrt(max(-math.log(tol * 0.02), 6.0))
    Lx, Ly = (float(b) for b in box_xy)
    r_cut = (r_cut_factor if r_cut_factor is not None else 6.0) * a
    r_cut = min(r_cut, 0.45 * min(Lx, Ly))

    def _axes(rc):
        k_max = 2.0 * s * s / rc
        h = math.pi / (oversample * k_max)
        gx = max(ewald._round_up_grid(Lx / h), 8)
        gy = max(ewald._round_up_grid(Ly / h), 8)
        return gx, gy

    gx, gy = _axes(r_cut)
    if grid_max and max(gx, gy) > grid_max:
        r_cut = min(r_cut * max(gx, gy) / float(grid_max),
                    0.45 * min(Lx, Ly))
        gx, gy = _axes(r_cut)
    xi = s / r_cut
    hx = Lx / gx
    # z geometry: data extent covers sources AND their windows
    wz = 0.5 * support * hx + 2 * hx
    LD = 2.0 * (float(z_hi) + wz)
    # polish-mode budget: the polish set keeps modes with k_par below
    # kstar = (ln(1/0.03 tol) + 5) / margin, margin = (pad - 1) LD, so
    # its size grows as (Lx Ly) kstar^2 / (4 pi^2) — at large in-plane
    # boxes (32k-roller slabs, L ~ 3 10^2) the per-mode Toeplitz tables
    # blow past the remote-compile payload limit. Raising the z padding
    # shrinks the set quadratically for a LINEAR gz cost (and the
    # z-sliced transforms only touch occupied planes); pick the
    # smallest pad in [z_pad_factor, 6] keeping the set under ~4096.
    kstar_num = math.log(1.0 / max(0.03 * tol, 1e-300)) + 5.0
    p_budget = 4096.0
    for _pad in (z_pad_factor, 2.5, 3.0, 4.0, 5.0, 6.0):
        if _pad < z_pad_factor:
            continue
        kstar = kstar_num / max((_pad - 1.0) * LD, 1e-30)
        p_est = Lx * Ly * kstar * kstar / (4.0 * math.pi ** 2) * math.pi
        z_pad_factor = _pad
        if p_est <= p_budget:
            break
    gz = max(ewald._round_up_grid(z_pad_factor * LD / hx,
                                  zslab_pm=max(int(support) - 1, 8)), 8)
    z0 = -0.5 * LD
    return WallParams(a=float(a), eta=float(eta), box_xy=(Lx, Ly),
                      z_hi=float(z_hi), xi=xi, r_cut=r_cut,
                      grid=(gx, gy, gz), z0=z0, support=int(support),
                      oversample=float(oversample),
                      z_pad_factor=float(z_pad_factor), tol=float(tol),
                      **kw)


# ---------------------------------------------------------------------------
# Host-side cached pieces
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _host_cheb_rpy(params: WallParams):
    """RPY remainder piecewise-Chebyshev (reuses the periodic engine's
    builder at the wall params' (a, eta, xi, r_cut))."""
    return ewald._host_cheb(params.grid_params())


@functools.lru_cache(maxsize=16)
def _host_img_cheb(params: WallParams):
    """Scaled two-piece radial tables for the image-channel remainder:
    (coeffs (2, 10, K), r_lo, r_mid, r_hi)."""
    r_lo = 1.8
    r_hi = params.r_cut / params.a
    return wall_kernels.img_cheb_tables(params.xi * params.a, r_lo, r_hi,
                                        n_cheb=params.n_cheb,
                                        tol=0.02 * params.tol)


@functools.lru_cache(maxsize=16)
def _host_whats(params: WallParams):
    gp = params.grid_params()
    P = params.support
    beta = params.es_beta
    ks = _axis_freqs(params)
    return tuple(ewald._es_window_hat(np.abs(kd), 0.5 * P * hd, beta)
                 for kd, hd in zip(ks, params.spacing))


def _axis_freqs(params: WallParams):
    gx, gy, gz = params.grid
    hx, hy, hz = params.spacing
    return [2.0 * np.pi * np.fft.fftfreq(gx, d=hx),
            2.0 * np.pi * np.fft.rfftfreq(gy, d=hy),
            2.0 * np.pi * np.fft.fftfreq(gz, d=hz)]


@functools.lru_cache(maxsize=16)
def _host_polish(params: WallParams):
    """Polish mode set + circular Toeplitz kernel FFTs (host, cached
    per params — position independent)."""
    gx, gy, gz = params.grid
    hx, hy, hz = params.spacing
    kx, ky, kz = _axis_freqs(params)
    margin = params.lz_box - params.data_extent
    idx, kxky = wall_kernels.polish_mode_set(gx, len(ky), kx, ky, margin,
                                             params.tol)
    # exact window transforms at each mode (no interpolation)
    wx = ewald._es_window_hat(np.abs(kxky[:, 0]), 0.5 * params.support * hx,
                              params.es_beta)
    wy = ewald._es_window_hat(np.abs(kxky[:, 1]), 0.5 * params.support * hy,
                              params.es_beta)
    # circular delta layout: index d -> displacement delta_z
    circ = np.arange(2 * gz)
    circ = np.where(circ < gz, circ, circ - 2 * gz)      # [0..gz-1, -gz..-1]
    dzg = circ * hz
    kern = wall_kernels.build_polish_kernels(
        kxky, dzg, a=params.a, eta=params.eta, xi=params.xi,
        hx=hx, hy=hy, hz=hz, support=params.support,
        es_beta=params.es_beta, what_x=wx, what_y=wy, tol=params.tol)
    kfft = np.fft.fft(kern, axis=-1)                     # (P,4,3,3,2gz)
    mask = np.ones(gx * len(ky), bool)
    mask[idx] = False                                    # False AT polish
    return idx, kfft, mask


@functools.lru_cache(maxsize=8)
def _host_noise_tables(params: WallParams):
    """Host tables for the closed-form wave-noise sampler
    (wall_wave_sqrt_noise): z-Chebyshev nodes + barycentric weights, the
    retained in-plane mode set with per-mode scalings, Chebyshev(-in-
    k_par) coefficients of the symmetric square-root factors of the
    per-mode z-operators (wall_kernels.wave_zkernel_nodes), and the
    z-window deconvolution table chi.

    Everything is position-independent (cached per params); the device
    side only evaluates the factor Chebyshev series per retained mode.
    Fitting the FACTORS (not the kernels) keeps the sampled covariance
    PSD by construction: interp(F) interp(F)^T is a Gram matrix whose
    error vs G is first-order in the fit error."""
    import numpy as np
    from numpy.polynomial import chebyshev as npcheb

    p = params
    pz, pk = p.noise_orders()
    # ---- z-Chebyshev nodes (2nd kind, endpoints included) on the
    # clipped height range [a, z_hi]
    mid_z = 0.5 * (p.z_hi + p.a)
    half_z = 0.5 * (p.z_hi - p.a)
    tcheb = np.cos(np.pi * np.arange(pz) / (pz - 1))      # [1 .. -1]
    z_nodes = mid_z + half_z * tcheb
    bary_w = np.ones(pz)
    bary_w[1::2] = -1.0
    bary_w[0] *= 0.5
    bary_w[-1] *= 0.5

    # ---- retained mode set: keep modes whose screen survives
    # 0.05 * tol (the dropped tail contributes < tol to the covariance;
    # the zz channels carry extra k powers, hence the margin)
    ln_t = math.log(20.0 / p.tol)
    u = ln_t
    for _ in range(20):
        u = ln_t + math.log1p(u)
    k_cut = 2.0 * p.xi * math.sqrt(u)
    kx, ky, _ = _axis_freqs(p)
    kpar = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
    sel = kpar <= k_cut
    idx = np.nonzero(sel.ravel())[0].astype(np.int32)
    kxm = np.broadcast_to(kx[:, None], kpar.shape).ravel()[idx]
    kym = np.broadcast_to(ky[None, :], kpar.shape).ravel()[idx]
    kpm = kpar.ravel()[idx]
    # in-plane rotation (l = along k; k = 0 -> l = x)
    kp_safe = np.where(kpm > 0, kpm, 1.0)
    cosm = np.where(kpm > 0, kxm / kp_safe, 1.0)
    sinm = np.where(kpm > 0, kym / kp_safe, 0.0)
    # per-mode linear scale: sqrt(hx hy) / (wx_hat wy_hat)  (DFT + xy
    # window deconvolution; see wall_wave_sqrt_noise derivation)
    hx, hy, hz = p.spacing
    wxh = ewald._es_window_hat(np.abs(kxm), 0.5 * p.support * hx, p.es_beta)
    wyh = ewald._es_window_hat(np.abs(kym), 0.5 * p.support * hy, p.es_beta)
    scale = math.sqrt(hx * hy) / (wxh * wyh)

    # ---- kernel tables: G at pk Chebyshev k_par nodes -> Chebyshev
    # coefficients of each KERNEL entry. The entries are as analytic in
    # k_par as the screened kernel itself, so the fit converges fast;
    # fitting sqrt FACTORS instead was measured 30x worse (the matrix
    # sqrt of an exponentially decaying family is not smooth once
    # eigenvalues reach the quadrature floor). The per-mode Cholesky
    # runs batched on device with a tiny ridge (PSD by construction).
    tk = np.cos(np.pi * (2 * np.arange(pk) + 1) / (2 * pk))  # Cheb 1st kind
    kq = 0.5 * k_cut * (tk + 1.0)
    G = wall_kernels.wave_zkernel_nodes(kq, z_nodes, a=p.a, eta=p.eta,
                                        xi=p.xi)
    # block split: rows (l: 0..pz, t: pz..2pz, z: 2pz..3pz); the rotated
    # frame decouples {l,z} from {t}
    il = np.arange(pz)
    it = pz + il
    iz = 2 * pz + il
    ilz = np.concatenate([il, iz])
    G_lz = G[:, ilz[:, None], ilz[None, :]]
    G_t = G[:, it[:, None], it[None, :]]
    ridge = 1e-5 * max(float(np.abs(np.diagonal(
        G, axis1=1, axis2=2)).max()), 1e-30)
    # Chebyshev coefficients from 1st-kind node values (exact DCT fit)
    C_lz = npcheb.chebfit(tk, G_lz.reshape(pk, -1), pk - 1)
    C_t = npcheb.chebfit(tk, G_t.reshape(pk, -1), pk - 1)

    # ---- chi: z-window deconvolution table, solving
    #   sum_pz wz(zeta_s - pz hz) chi_a(pz) ~= ell_a(z_s)
    # over dense z samples (the engine's 3D interpolate then evaluates
    # the Chebyshev cardinal functions exactly through its z windows)
    gz = p.grid[2]
    R = 0.5 * p.support * hz
    zs = np.linspace(p.a, p.z_hi, 40 * pz)
    zeta = zs - p.z0                       # grid-shifted, like plan pos
    pz_grid = np.arange(gz) * hz
    dzm = zeta[:, None] - pz_grid[None, :]
    t_w = np.clip(dzm / R, -1.0, 1.0)
    W = np.where(np.abs(dzm) <= R,
                 np.exp(p.es_beta * (np.sqrt(np.maximum(1 - t_w ** 2, 0.0))
                                     - 1.0)), 0.0)
    cols = np.nonzero(W.any(axis=0))[0]
    # cardinal function values at the samples (barycentric)
    ts = (zs - mid_z) / half_z
    diff = ts[:, None] - tcheb[None, :]
    exact = diff == 0.0
    diff = np.where(exact, 1.0, diff)
    terms = bary_w[None, :] / diff
    L_vals = terms / terms.sum(axis=1, keepdims=True)
    L_vals = np.where(exact.any(axis=1, keepdims=True), exact.astype(float),
                      L_vals)                             # (S, pz)
    chi_sub, *_ = np.linalg.lstsq(W[:, cols], L_vals, rcond=None)
    resid = np.abs(W[:, cols] @ chi_sub - L_vals).max()
    chi = np.zeros((gz, pz))
    chi[cols] = chi_sub
    return dict(p=pz, z_nodes=z_nodes, bary_w=bary_w, mid_z=mid_z,
                half_z=half_z,
                mode_idx=idx, cos=cosm.astype(np.float64),
                sin=sinm.astype(np.float64), kpar=kpm, k_cut=k_cut,
                scale=scale, C_lz=C_lz, C_t=C_t, ridge=ridge, chi=chi.T,
                chi_resid=float(resid))


def _noise_factors_device(params: WallParams, dtype=jnp.float32):
    """Per-mode factor + defect tables.

    The per-mode z-operators G_k of the Hasimoto-split WAVE part are NOT
    individually PSD — the image channels' near-field subtraction can
    exceed the wall kernel within a single in-plane mode (measured: every
    mode's {l,z} block carries a small negative eigenvalue, worst ~-1%
    of scale at low k_par; the mode SUM is PSD). The split therefore
    samples the positive parts and hands the defect to the near-field
    Lanczos:

      sample Cov  = sum_k clamp+(G_k)          (closed form, PSD)
      Lanczos on    M_near - Delta,  Delta = sum_k (clamp+(G_k) - G_k)

    which keeps the TOTAL covariance exactly M_near + sum_k G_k. Delta
    is PSD with measured norm ~half of lambda_min(M_near) (asserted in
    tests); M_near - Delta stays SPD.

    Returns (F_lz, F_t, Dh_lz, Dh_t): factors F with F F^T = clamp+(G)
    and defect half-factors Dh with Dh Dh^T = clamp+(G) - G (both
    scale-folded; Dh feeds wave_defect_matvec through the same linear
    chain, so sample-Cov + Delta == sum_k G_k holds by construction).
    Clenshaw + batched eigh per retained mode; position-independent —
    computed ON HOST (f64 numpy, lru-cached per params) and embedded as
    constants: the first implementation traced the ~10^4-mode batched
    eigh into every step graph, re-running it each step at runtime and
    paying its compile in every stepper instance."""
    host = _noise_factors_host(params)
    return tuple(jnp.asarray(a, dtype) for a in host)


@functools.lru_cache(maxsize=8)
def _noise_factors_host(params: WallParams):
    t = _host_noise_tables(params)
    x = 2.0 * t["kpar"] / t["k_cut"] - 1.0               # (M,)
    sc = t["scale"]
    outs = []
    for key in ("C_lz", "C_t"):
        C = np.asarray(t[key], np.float64)               # (pk, E)
        b1 = np.zeros((x.shape[0], C.shape[1]))
        b2 = np.zeros_like(b1)
        x2 = (2.0 * x)[:, None]
        for q in range(C.shape[0] - 1, 0, -1):
            b1, b2 = x2 * b1 - b2 + C[q][None, :], b1
        vals = x[:, None] * b1 - b2 + C[0][None, :]
        d = int(math.isqrt(C.shape[1]))
        G = vals.reshape(x.shape[0], d, d)
        G = 0.5 * (G + np.swapaxes(G, 1, 2))
        w, V = np.linalg.eigh(G)
        F = V * np.sqrt(np.maximum(w, 0.0))[:, None, :]  # F F^T = clamp+
        Dh = V * np.sqrt(np.maximum(-w, 0.0))[:, None, :]  # defect half
        outs.append((sc[:, None, None] * F, sc[:, None, None] * Dh))
    (F_lz, Dh_lz), (F_t, Dh_t) = outs
    return F_lz, F_t, Dh_lz, Dh_t


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WallPlan:
    """Reusable machinery for wall-mobility products at fixed positions.
    Positions are stored GRID-SHIFTED: pos_all = (x, y, z - z0) for the
    combined real+image set (first n_real rows = real particles)."""

    pos_all: jax.Array        # (2N, 3) grid coords, xy-wrapped
    sort_pos: jax.Array       # (2N, 3) positions the sorts were built at
    #                           (update_wall_plan measures cumulative
    #                           drift against THESE; see ewald.update_plan)
    heights: jax.Array        # (N,) physical z of the real particles
    damp: jax.Array           # (N,) overlap damping B_ii = min(z/a, 1)
    # near field (cells over the combined set)
    cheb: jax.Array           # RPY remainder (2, 2, K)
    self_coeff: jax.Array
    img_cheb: jax.Array       # (10, K2) scaled radial series
    cell_table: jax.Array
    cell_slot: jax.Array      # (2N,) — first N rows read for output
    nbr_cells: jax.Array
    n_dropped_cells: jax.Array
    cell_dims: Tuple[int, int, int]
    # gridding layouts (ewald.make_grid_layout) for the three point sets
    tbl_all: jax.Array
    tbl_img: jax.Array
    tbl_real: jax.Array
    inv_real: jax.Array
    n_dropped_grid: jax.Array
    n_clipped: jax.Array      # real particles clipped into [a, z_hi]
    # polish machinery
    polish_idx: jax.Array     # (P,) int32 flat (gx * gy2) columns
    # polish Toeplitz kernel FFTs, stored as a real/imag PAIR and FLAT in
    # the tensor dims (P, 36, L); wave_matvec reassembles with
    # lax.complex and reshapes in-graph
    polish_kfft_re: jax.Array  # (P, 36, 2 gz) real
    polish_kfft_im: jax.Array
    polish_mask: jax.Array    # (gx * gy2,) bool, False at polish columns
    params: WallParams

    @property
    def n_real(self) -> int:
        return self.pos_all.shape[0] // 2

    def _sub(self, tbl, pos, inv=None):
        """Duck-typed SpectralPlan view for ewald spread/interp reuse."""
        gp = self.params.grid_params()
        return ewald.SpectralPlan(
            positions=pos, sort_pos=pos, cheb=self.cheb,
            self_coeff=self.self_coeff, cell_table=self.cell_table,
            cell_slot=self.cell_slot, nbr_cells=self.nbr_cells,
            n_dropped_cells=self.n_dropped_cells,
            cell_dims=self.cell_dims, grid_tbl=tbl,
            inv_idx=(inv if inv is not None
                     else jnp.zeros((1, 1), jnp.int32)),
            n_dropped=self.n_dropped_grid, src_pos=None, src_ids=None,
            tgt_xyz=None, kernel=jnp.zeros(()), khat=jnp.zeros(()),
            params=gp)


jax.tree_util.register_dataclass(
    WallPlan,
    data_fields=["pos_all", "sort_pos", "heights", "damp", "cheb",
                 "self_coeff", "img_cheb",
                 "cell_table", "cell_slot", "nbr_cells",
                 "n_dropped_cells",
                 "tbl_all", "tbl_img", "tbl_real", "inv_real",
                 "n_dropped_grid", "n_clipped", "polish_idx",
                 "polish_kfft_re", "polish_kfft_im", "polish_mask"],
    meta_fields=["cell_dims", "params"])


def make_wall_plan(params: WallParams, positions) -> WallPlan:
    """Build the plan at (N, 3) PHYSICAL blob positions (wall at z=0).
    Heights are shift-regularized to z >= a (reference
    mobility/mobility.py:52-66); the damping part of the regularization
    lives in the apply wrappers."""
    dtype = positions.dtype
    p = params
    Lx, Ly = p.box_xy
    box2 = jnp.asarray([Lx, Ly], dtype)
    xy = positions[:, :2]
    xy = xy - jnp.floor(xy / box2) * box2
    z_raw = positions[:, 2]
    z = jnp.clip(z_raw, p.a, p.z_hi)
    # bottom shifts are the reference's overlap regularization (normal
    # physics, paired with the damping factors); only TOP clips mean the
    # slab parameter z_hi is too low for this configuration
    n_clipped = jnp.sum(z_raw > p.z_hi).astype(jnp.int32)
    damp = jnp.minimum(z_raw / p.a, 1.0).astype(dtype)
    n = positions.shape[0]

    pos_real = jnp.concatenate([xy, (z - p.z0)[:, None]], axis=1)
    pos_img = jnp.concatenate([xy, (-z - p.z0)[:, None]], axis=1)
    pos_all = jnp.concatenate([pos_real, pos_img], axis=0)

    # ---- near-field cells over the combined set. The binning volume is
    # the DATA slab plus one empty guard layer, NOT the padded FFT box:
    # slab configurations would otherwise leave most z-cells empty and
    # the occupied ones overflowing any mean-based capacity. The guard
    # layer keeps the 27-stencil's z wrap pointing at empty cells only
    # (the padded box never wraps pairs physically). The z cells carry
    # the same drift slack as the xy cells would (Z_CELL_SLACK - 1
    # in units of r_cut) so update_wall_plan's cheap refresh path has a
    # real budget — at exactly 1.001 r_cut the z budget was 5e-4 r_cut
    # and every per-step refresh fell through to a full rebuild.
    csize_z = Z_CELL_SLACK * p.r_cut
    nz_data = max(int(math.ceil(p.data_extent / csize_z)), 2)
    nz_cells = nz_data + 1
    bin_z = nz_cells * csize_z
    box3_bin = jnp.asarray([Lx, Ly, bin_z], dtype)
    dims = (max(int(Lx // p.r_cut), 1), max(int(Ly // p.r_cut), 1),
            nz_cells)
    if min(dims[:2]) < 4:
        raise ValueError(
            f"wall box {(Lx, Ly)} too small for r_cut "
            f"{p.r_cut}: need >= 4 xy cells")
    cap = p.cell_capacity
    if cap <= 0:
        # occupied-cell mean: the combined 2N points fill nz_data layers
        mean_occ = 2 * n / (dims[0] * dims[1] * nz_data)
        cap = int(min(max(
            -(-(mean_occ + 4.0 * math.sqrt(max(mean_occ, 1.0))) // 8) * 8,
            16), 256))
    params = dataclasses.replace(p, cell_capacity=int(cap))
    p = params
    cell_table, cell_slot, _cid, n_dropped_cells = cells.cell_bin(
        pos_all, box3_bin, dims, cap)
    nbr_cells = cells.neighbor_table(dims)

    # ---- gridding layouts. The generic mean-based segment capacity
    # (ewald.make_grid_layout) assumes particles fill the z axis; wall
    # configurations concentrate in the slab while the padded z-blocks
    # stay empty, so the auto capacity uses the OCCUPIED-block mean.
    gp = p.grid_params()
    cap_seg = p.bucket_capacity
    if cap_seg <= 0:
        ZB = gp.zslab
        hz = p.spacing[2]
        nzb = p.grid[2] // ZB
        nzb_occ = min(max(int(math.ceil(p.data_extent / (ZB * hz))) + 1, 1),
                      nzb)
        mean_seg = 2 * n * p.support / (p.grid[0] * nzb_occ)
        cap_seg = int(-(-(1.5 * mean_seg + 5.0 * math.sqrt(mean_seg)
                          + 16.0) // 8) * 8)
    tbl_all, _inv_a, d_all = ewald.make_grid_layout(gp, pos_all, cap_seg)
    tbl_img, _inv_i, d_img = ewald.make_grid_layout(gp, pos_img, cap_seg)
    tbl_real, inv_real, d_real = ewald.make_grid_layout(gp, pos_real,
                                                        cap_seg)

    # ---- host tables
    cheb, self_c = _host_cheb_rpy(p)
    img_cheb, _, _, _ = _host_img_cheb(p)
    pol_idx, pol_kfft, pol_mask = _host_polish(p)
    rdt = jnp.float32 if dtype == jnp.float32 else jnp.float64

    return WallPlan(
        pos_all=pos_all, sort_pos=pos_all, heights=z, damp=damp,
        cheb=jnp.asarray(cheb, dtype), self_coeff=jnp.asarray(self_c, dtype),
        img_cheb=jnp.asarray(img_cheb, dtype),
        cell_table=cell_table, cell_slot=cell_slot,
        nbr_cells=nbr_cells,
        n_dropped_cells=n_dropped_cells, cell_dims=dims,
        tbl_all=tbl_all, tbl_img=tbl_img, tbl_real=tbl_real,
        inv_real=inv_real,
        n_dropped_grid=d_all + d_img + d_real, n_clipped=n_clipped,
        polish_idx=jnp.asarray(pol_idx),
        polish_kfft_re=jnp.asarray(
            pol_kfft.real.reshape(len(pol_idx), 36, -1), rdt),
        polish_kfft_im=jnp.asarray(
            pol_kfft.imag.reshape(len(pol_idx), 36, -1), rdt),
        polish_mask=jnp.asarray(pol_mask),
        params=p)


# ---------------------------------------------------------------------------
# Near field (XLA cell sweep)
# ---------------------------------------------------------------------------


def _clenshaw_multi(coeffs, t, piece):
    """Stacked two-piece Chebyshev series: coeffs (2, F, K), t the
    per-piece normalized coordinate, piece a bool mask (True = piece 0).
    Returns a list of F values."""
    outs = []
    for f in range(coeffs.shape[1]):
        b1 = jnp.zeros_like(t)
        b2 = jnp.zeros_like(t)
        K = coeffs.shape[2]
        for k in range(K - 1, 0, -1):
            c = jnp.where(piece, coeffs[0, f, k], coeffs[1, f, k])
            b1, b2 = 2.0 * t * b1 - b2 + c, b1
        c0 = jnp.where(piece, coeffs[0, f, 0], coeffs[1, f, 0])
        outs.append(t * b1 - b2 + c0)
    return outs


def near_matvec_xla(plan: WallPlan, forces):
    """Near-field sweep: RPY remainder over all pairs of the combined
    set (mirrored strengths at image rows) + the screened image-channel
    remainder for (real target <- image source) pairs. forces (N, C)
    with C = 3B b-major; returns (N, C)."""
    p = plan.params
    n = plan.n_real
    dtype = plan.pos_all.dtype
    f = forces.reshape(n, -1)
    nc = f.shape[1]
    B = nc // 3
    mirror = jnp.asarray([1.0, 1.0, -1.0] * B, dtype)
    f_all = jnp.concatenate([f, -f * mirror], axis=0)       # (2N, C)
    # raw strengths at image rows only (image-channel remainder inputs)
    f_raw = jnp.concatenate([jnp.zeros_like(f), f], axis=0)

    box3 = jnp.asarray([p.box_xy[0], p.box_xy[1], p.lz_box], dtype)
    cap = p.cell_capacity
    n_cells = plan.nbr_cells.shape[0]
    pos_pad = jnp.concatenate(
        [plan.pos_all, jnp.full((1, 3), jnp.nan, dtype)], axis=0)
    fa_pad = jnp.concatenate([f_all, jnp.zeros((1, nc), dtype)], axis=0)
    fr_pad = jnp.concatenate([f_raw, jnp.zeros((1, nc), dtype)], axis=0)
    ids = plan.cell_table.reshape(n_cells, cap)
    pos_c = pos_pad[ids]
    fa_c = fa_pad[ids]
    fr_c = fr_pad[ids]

    TC = min(p.cell_tile, n_cells)
    n_pad_c = -(-n_cells // TC) * TC
    pad_c = n_pad_c - n_cells
    if pad_c:
        pos_c = jnp.concatenate(
            [pos_c, jnp.full((pad_c, cap, 3), jnp.nan, dtype)], axis=0)
        fa_c = jnp.concatenate(
            [fa_c, jnp.zeros((pad_c, cap, nc), dtype)], axis=0)
        fr_c = jnp.concatenate(
            [fr_c, jnp.zeros((pad_c, cap, nc), dtype)], axis=0)
    ids_pad = (jnp.concatenate(
        [ids, jnp.full((pad_c, cap), 2 * n, jnp.int32)]) if pad_c else ids)
    nbr_pad = (jnp.concatenate(
        [plan.nbr_cells, jnp.zeros((pad_c, 27), jnp.int32)])
        if pad_c else plan.nbr_cells)

    two_a = 2.0 * p.a
    mids = jnp.asarray([0.5 * two_a, 0.5 * (two_a + p.r_cut)], dtype)
    halfs = jnp.asarray([0.5 * two_a, 0.5 * (p.r_cut - two_a)], dtype)
    inv_a = 1.0 / p.a
    # image radial series domain (scaled, two pieces)
    _, ir_lo, ir_mid, ir_hi = _host_img_cheb(p)
    z0 = p.z0
    pref_img = 1.0 / (8.0 * jnp.pi * p.eta * p.a)

    def tile_fn(c0):
        rp = lax.dynamic_slice_in_dim(pos_c, c0, TC, 0)    # (TC, cap, 3)
        rid = lax.dynamic_slice_in_dim(ids_pad, c0, TC, 0)
        nb = lax.dynamic_slice_in_dim(nbr_pad, c0, TC, 0)
        ps = pos_c[nb]                                     # (TC,27,cap,3)
        fas = fa_c[nb]
        frs = fr_c[nb]
        sid = ids_pad[nb]
        d = rp[:, :, None, None, :] - ps[:, None, :, :, :]
        d = d - jnp.round(d / box3) * box3
        r2 = jnp.sum(d * d, axis=-1)
        r = jnp.sqrt(r2)
        inside = ((r < p.r_cut) & (r2 > 0)
                  & (rid[:, :, None, None] != sid[:, None, :, :]))
        d = jnp.where(inside[..., None], d, 0.0)
        # ---- RPY remainder (mirrored strengths)
        near = r < two_a
        t0 = jnp.clip((r - mids[0]) / halfs[0], -1.0, 1.0)
        t1 = jnp.clip((r - mids[1]) / halfs[1], -1.0, 1.0)
        al = jnp.where(near, ewald._clenshaw(plan.cheb[0, 0], t0),
                       ewald._clenshaw(plan.cheb[1, 0], t1))
        be = jnp.where(near, ewald._clenshaw(plan.cheb[0, 1], t0),
                       ewald._clenshaw(plan.cheb[1, 1], t1))
        al = jnp.where(inside, al, 0.0)
        bfac = jnp.where(inside, be / jnp.where(inside, r2, 1.0), 0.0)
        fs3 = fas.reshape(*fas.shape[:-1], B, 3)
        ddotf = jnp.sum(d[..., None, :] * fs3[:, None], axis=-1)
        contrib = (al[..., None, None] * fs3[:, None]
                   + (bfac[..., None] * ddotf)[..., None] * d[..., None, :])
        # ---- image-channel remainder: target real & source image.
        # Source is an image iff its grid z sits below the wall plane
        # (z' + z0 < 0); NaN pads compare False.
        src_z_phys = ps[..., 2] + z0                       # (TC,27,cap)
        tgt_z_phys = rp[..., 2] + z0                       # (TC,cap)
        is_pair = (inside & (src_z_phys < 0.0)[:, None, :, :]
                   & (tgt_z_phys > 0.0)[:, :, None, None])
        # sanitize NaN pads / non-pairs BEFORE img_terms: 0 * NaN = NaN
        hsrc = jnp.where(is_pair, -src_z_phys[:, None, :, :] * inv_a, 1.0)
        rs = jnp.clip(jnp.where(is_pair, r, ir_hi * p.a) * inv_a,
                      ir_lo, ir_hi)
        piece0 = rs < ir_mid
        t0i = (2.0 * rs - (ir_mid + ir_lo)) / (ir_mid - ir_lo)
        t1i = (2.0 * rs - (ir_hi + ir_mid)) / (ir_hi - ir_mid)
        ti = jnp.clip(jnp.where(piece0, t0i, t1i), -1.0, 1.0)
        cvals = _clenshaw_multi(plan.img_cheb, ti, piece0)  # 10 arrays
        dxs = d[..., 0] * inv_a
        dys = d[..., 1] * inv_a
        rzs = d[..., 2] * inv_a
        fr3 = frs.reshape(*frs.shape[:-1], B, 3)
        outs = []
        for b in range(B):
            fxb = fr3[..., b, 0][:, None]
            fyb = fr3[..., b, 1][:, None]
            fzb = fr3[..., b, 2][:, None]
            ux, uy, uz = gen.img_terms(
                dxs, dys, rzs, hsrc, fxb, fyb, fzb, 1.0, *cvals)
            m = jnp.where(is_pair, pref_img, 0.0)
            outs.append(jnp.stack([ux * m, uy * m, uz * m], axis=-1))
        img = jnp.stack(outs, axis=-2)                     # (...,B,3)
        out = jnp.sum(contrib + img, axis=(2, 3))          # (TC,cap,B,3)
        return out.reshape(TC, cap, nc)

    out_c = lax.map(tile_fn, jnp.arange(0, n_pad_c, TC))
    rows = out_c.reshape(n_pad_c * cap, nc)[:n_cells * cap]
    rows = jnp.concatenate([rows, jnp.zeros((1, nc), rows.dtype)], axis=0)
    return (rows[plan.cell_slot[:n]].astype(dtype)
            + plan.self_coeff * f.astype(dtype))


def update_wall_plan(plan: WallPlan, positions) -> WallPlan:
    """Refresh the plan for a slightly-moved same-topology configuration
    WITHOUT re-sorting (the wall analog of ewald.update_plan): keeps the
    cell membership, gridding segment assignments and the near-field
    slot layout, re-gathering only position data. Exactness contract as
    in ewald.update_plan (min-image drift per particle within half the
    cell slack and half a grid spacing, measured against the positions
    the sorts were built at); past the budget it falls back to a FULL
    rebuild via lax.cond, so steppers may call it unconditionally for
    in-step companion configurations (RFD displacement, trapezoidal
    predictor)."""
    p = plan.params
    dtype = plan.pos_all.dtype
    n = plan.n_real
    Lx, Ly = p.box_xy
    box2 = jnp.asarray([Lx, Ly], dtype)
    xy = positions[:, :2]
    xy = xy - jnp.floor(xy / box2) * box2
    z_raw = positions[:, 2]
    z = jnp.clip(z_raw, p.a, p.z_hi)
    n_clipped = jnp.sum(z_raw > p.z_hi).astype(jnp.int32)
    damp = jnp.minimum(z_raw / p.a, 1.0).astype(dtype)
    pos_real = jnp.concatenate([xy, (z - p.z0)[:, None]], axis=1)
    pos_img = jnp.concatenate([xy, (-z - p.z0)[:, None]], axis=1)
    pos_all = jnp.concatenate([pos_real, pos_img], axis=0)

    box3 = jnp.asarray([Lx, Ly, p.lz_box], dtype)
    delta = pos_all - plan.sort_pos
    delta = delta - jnp.round(delta / box3) * box3
    dims = plan.cell_dims
    # cells are binned over (Lx, Ly, dims_z * Z_CELL_SLACK r_cut) — see
    # make_wall_plan; the z side equals the bin cell height
    side = np.asarray([Lx / dims[0], Ly / dims[1], Z_CELL_SLACK * p.r_cut])
    budget = 0.5 * np.minimum(side - p.r_cut,
                              np.asarray(p.spacing, np.float64))
    ok = jnp.all(jnp.max(jnp.abs(delta), axis=0)
                 <= jnp.asarray(np.maximum(budget, 0.0), dtype))
    pos_eff = plan.sort_pos + delta

    def refresh(_):
        return dataclasses.replace(plan, pos_all=pos_eff, heights=z,
                                   damp=damp, n_clipped=n_clipped)

    def rebuild(_):
        return make_wall_plan(p, positions)

    return lax.cond(ok, refresh, rebuild, None)


def near_matvec(plan: WallPlan, forces):
    return near_matvec_xla(plan, forces)


# ---------------------------------------------------------------------------
# Wave field
# ---------------------------------------------------------------------------


def _wave_arrays(plan: WallPlan, dtype):
    """On-the-fly k-space arrays over (gx, gy2, gz): RPY kernel (with
    normalization + polish masking), khat, and the channel bases F4, F2
    (normalized, masked, 1/(8 pi eta) applied)."""
    p = plan.params
    kx, ky, kz = _axis_freqs(p)
    whats = _host_whats(p)
    KX = jnp.asarray(kx, dtype)[:, None, None]
    KY = jnp.asarray(ky, dtype)[None, :, None]
    KZ = jnp.asarray(kz, dtype)[None, None, :]
    k2 = KX * KX + KY * KY + KZ * KZ
    k2s = jnp.where(k2 > 0, k2, 1.0)
    k = jnp.sqrt(k2s)
    phi = (1.0 + k2 / (4 * p.xi ** 2)) * jnp.exp(-k2 / (4 * p.xi ** 2))
    sinc = jnp.sin(k * p.a) / (k * p.a)
    h3 = float(np.prod(p.spacing))
    w2 = [jnp.asarray(w, dtype) ** 2 for w in whats]
    norm = h3 / (w2[0][:, None, None] * w2[1][None, :, None]
                 * w2[2][None, None, :])
    gx, gy, gz = p.grid
    gy2 = gy // 2 + 1
    mask = plan.polish_mask.reshape(gx, gy2, 1).astype(dtype)
    kern = (sinc ** 2 * phi / (p.eta * k2s)) * norm * mask
    kern = jnp.where(k2 > 0, kern, 0.0)
    khat = jnp.stack([KX / k, KY / k, KZ / k * jnp.ones_like(kern)])
    khat = jnp.where(k2 > 0, khat, 0.0)
    base = phi * norm * mask / (8.0 * jnp.pi * p.eta)
    F4 = base * (-8.0 * jnp.pi) / (k2s * k2s)
    F4 = jnp.where(k2 > 0, F4, 0.0)
    F2 = base * (4.0 * jnp.pi) / k2s
    F2 = jnp.where(k2 > 0, F2, 0.0)
    return KX, KY, KZ, kern, khat, F4, F2


def _z_plane_ranges(p: WallParams):
    """Static occupied z-plane index ranges [lo, hi) of the padded grid:
    `data` covers every spread source's window (real + image), `img` the
    image sources only, `real` the planes the real-target interpolation
    reads. The z axis is mostly EMPTY padding (z_pad_factor x the slab,
    doubled again for images) — slicing the xy-transforms to the
    occupied planes is a ~2x (forward) / ~4x (inverse) FFT cut."""
    gz = p.grid[2]
    hz = p.spacing[2]
    R = 0.5 * p.support * hz + 2.0 * hz
    half = 0.5 * p.data_extent                 # = -z0

    def rng(z_lo, z_hi):
        lo = max(int(math.floor(z_lo / hz)), 0)
        hi = min(int(math.ceil(z_hi / hz)) + 1, gz)
        return lo, hi

    data = rng(half - p.z_hi - R, half + p.z_hi + R)
    img = rng(half - p.z_hi - R, half - p.a + R)
    real = rng(half + p.a - R, half + p.z_hi + R)
    return data, img, real


@functools.lru_cache(maxsize=16)
def _host_zdft(params: WallParams):
    """Host DFT constants for the sliced z transforms: forward matrices
    restricted to the occupied source planes (data / image ranges) and
    the inverse matrix onto the real-target planes. Stored as (re, im)
    float32 pairs (the same carried-table layout as
    WallPlan.polish_kfft_re)."""
    gz = params.grid[2]
    (da, db), (ia, ib), (ra, rb) = _z_plane_ranges(params)
    kzi = np.arange(gz)

    def pair(M):
        return (M.real.astype(np.float32), M.imag.astype(np.float32))

    def fwd(lo, hi):
        zi = np.arange(lo, hi)
        return pair(np.exp(-2j * np.pi * np.outer(zi, kzi) / gz))

    Wi = pair(np.exp(2j * np.pi * np.outer(kzi, np.arange(ra, rb)) / gz)
              / gz)
    return fwd(da, db), fwd(ia, ib), Wi


def wave_matvec(plan: WallPlan, forces):
    """Wave-side product: spread (real+image merged channel and the
    three h^m image channels), z-sliced rfft2 + z-DFT matmul, multiplier
    application, polish-column dense z-convolutions, inverse transforms
    onto the real-target planes, interp at the real particles.
    forces (N, C), C = 3B."""
    p = plan.params
    n = plan.n_real
    dtype = plan.pos_all.dtype
    f = forces.reshape(n, -1)
    nc = f.shape[1]
    B = nc // 3
    gx, gy, gz = p.grid
    gy2 = gy // 2 + 1
    (da, db), (ia, ib), (ra, rb) = _z_plane_ranges(p)
    nr = rb - ra
    Wf_data, Wf_img, Wi = (
        lax.complex(jnp.asarray(re), jnp.asarray(im))
        for re, im in _host_zdft(p))

    mirror = jnp.asarray([1.0, 1.0, -1.0] * B, dtype)
    f_all = jnp.concatenate([f, -f * mirror], axis=0)
    h = plan.heights[:, None]
    f_img = jnp.concatenate([f, h * f, (h * h) * f], axis=1)  # (N, 9B)

    sub_all = plan._sub(plan.tbl_all, plan.pos_all)
    sub_img = plan._sub(plan.tbl_img, plan.pos_all[n:])

    KX, KY, KZ, kern, khat, F4, F2 = _wave_arrays(plan, dtype)
    pi = plan.polish_idx
    cdt = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    zero = jnp.zeros((), cdt)
    if cdt == jnp.complex128:
        Wf_data, Wf_img, Wi = (W.astype(cdt) for W in (Wf_data, Wf_img,
                                                       Wi))
    prec = lax.Precision.HIGHEST

    def zfft(cxy, Wf):
        """Sliced-z forward DFT: (3, gx, gy2, nzs) -> (3, gx, gy2, gz)."""
        return jnp.einsum("cxyz,zk->cxyk", cxy, Wf, precision=prec)

    # The channel groups contribute ADDITIVELY to the k-space output:
    #   u_hat = K_rpy c_merged + sum_m T_m c_m.
    # Each group is spread, transformed and applied separately so only
    # one group's grid fields and complex transients are live at a time;
    # the ACCUMULATOR lives on the real-target plane slice (nr planes),
    # never the full padded grid — the full-grid (3B, gx, gy2, gz)
    # accumulator of the first implementation OOM'd one chip at 98k
    # blobs in the 2-RHS lockstep solve. The generated mult_terms
    # constant-folds the literal-zero channels of the absent groups.
    prof_rows = []                                       # polish inputs
    Uacc = jnp.zeros((3 * B, gx, gy2, nr), cdt)
    g_all = ewald.spread(sub_all, f_all)                 # (3B, gx, gy, gz)
    for b in range(B):
        cxy = jnp.fft.rfft2(g_all[3 * b:3 * b + 3, :, :, da:db],
                            axes=(1, 2))
        # polish inputs are the PRE-z-FFT column profiles (full gz,
        # zero outside the occupied slice)
        prof_rows.append(jnp.zeros((3, len(pi), gz), cdt)
                         .at[:, :, da:db]
                         .set(cxy.reshape(3, gx * gy2, -1)[:, pi]))
        ck = zfft(cxy, Wf_data)
        kdotc = jnp.sum(khat * ck, axis=0, keepdims=True)
        Uk3 = kern[None] * (ck - khat * kdotc)
        Uacc = Uacc.at[3 * b:3 * b + 3].add(
            jnp.einsum("cxyk,kt->cxyt", Uk3, Wi, precision=prec))
    del g_all
    prof_img_rows = [None] * (3 * B)
    for m in range(3):
        g_m = ewald.spread(sub_img, f_img[:, 3 * B * m:3 * B * (m + 1)])
        for b in range(B):
            # f_img columns are m-major then b-major: [f | h f | h^2 f]
            cxy = jnp.fft.rfft2(g_m[3 * b:3 * b + 3, :, :, ia:ib],
                                axes=(1, 2))
            prof_img_rows[B * m + b] = (
                jnp.zeros((3, len(pi), gz), cdt)
                .at[:, :, ia:ib]
                .set(cxy.reshape(3, gx * gy2, -1)[:, pi]))
            ck = zfft(cxy, Wf_img)
            args = [zero] * 9
            args[3 * m:3 * m + 3] = [ck[0], ck[1], ck[2]]
            ux, uy, uz = gen.mult_terms(KX, KY, KZ, F4, F2, p.a * p.a,
                                        *args)
            Uacc = Uacc.at[3 * b:3 * b + 3].add(
                jnp.einsum("cxyk,kt->cxyt", jnp.stack([ux, uy, uz]), Wi,
                           precision=prec))
    # prof order: B merged groups then (m, b) image groups
    prof_all = jnp.concatenate(prof_rows, axis=0)            # (3B, P, gz)
    prof_img = jnp.concatenate(prof_img_rows, axis=0)        # (9B, P, gz)

    # ---- polish columns: dense z-convolutions via circular FFT
    # input channel groups per RHS: [merged(3), T0(3), T1(3), T2(3)]
    pa = prof_all.reshape(B, 3, -1, gz)
    pim = prof_img.reshape(3, B, 3, -1, gz)              # (m, B, 3, P, gz)
    pin = jnp.concatenate([pa[:, None], jnp.moveaxis(pim, 0, 1)], axis=1)
    pin_f = jnp.fft.fft(pin, n=2 * gz, axis=-1)          # (B,4,3,P,2gz)
    kf = lax.complex(plan.polish_kfft_re,
                     plan.polish_kfft_im).astype(pin_f.dtype)
    kf = kf.reshape(kf.shape[0], 4, 3, 3, kf.shape[-1])
    out_f = jnp.einsum("pcijL,bcjpL->bipL", kf, pin_f,
                       precision=jax.lax.Precision.HIGHEST)
    pout = jnp.fft.ifft(out_f, axis=-1)[..., ra:rb]      # (B,3,P,nr)
    pout = pout.reshape(3 * B, -1, nr)
    Uacc = Uacc.reshape(3 * B, gx * gy2, nr).at[:, pi].add(pout)
    Uacc = Uacc.reshape(3 * B, gx, gy2, nr)

    Ur = jnp.fft.irfft2(Uacc, s=(gx, gy), axes=(1, 2))   # (3B,gx,gy,nr)
    U = (jnp.zeros((3 * B, gx, gy, gz), dtype)
         .at[:, :, :, ra:rb].set(Ur.astype(dtype)))
    sub_real = plan._sub(plan.tbl_real, plan.pos_all[:n], plan.inv_real)
    return ewald.interpolate(sub_real, U)


def wave_sqrt_noise(plan: WallPlan, key, factors=None):
    """Sample u with Cov(u) = M_wave of the wall engine, WITHOUT Lanczos
    (the wall analog of ewald.wave_sqrt_noise; the near field keeps its
    own cheap, well-conditioned Lanczos — integrators._noise_slip).

    Construction: per retained in-plane mode (|k_par| <= k_cut, beyond
    which the Hasimoto screen puts the wave kernel below tol), the wave
    operator restricted to that mode is a small z-operator G(k_par;z,z')
    over the slab — the point-evaluated screened image-channel kernels
    with continuous k_z (wall_kernels.wave_zkernel_nodes), compressed on
    a noise_p-point z-Chebyshev basis. Sampling draws grid white noise,
    applies each mode's symmetric-sqrt factor (Chebyshev-interpolated in
    k_par; PSD by construction since the FACTOR is interpolated), and
    evaluates at the particles through the engine's own 3D interpolation
    via a z-window deconvolution table.

    Exactness: Cov(u) + the Lanczos defect (wave_defect_matvec) matches
    the engine's wave_matvec operator to O(tol) (quadrature + Chebyshev
    compression + the dropped k > k_cut tail + 4 self-conjugate
    band-edge modes whose imaginary l<->z coupling a real field cannot
    carry), tested in tests/test_wall_spectral.py.
    Returns the UNDAMPED sample (N, 3) at the plan's clipped heights;
    callers apply the overlap damping (Cov target D M_wave D -> sample
    D u). Reference noise semantics: stochastic_forcing.py:112-264."""
    p = plan.params
    dtype = plan.pos_all.dtype
    if factors is None:
        factors = _noise_factors_device(p, dtype)
    F_lz, F_t = factors[0], factors[1]
    t = _host_noise_tables(p)
    pz = t["p"]
    gx, gy = p.grid[0], p.grid[1]
    w = jax.random.normal(key, (3 * pz, gx, gy), dtype)
    return _wave_noise_apply(plan, w, F_lz, F_t)


def _wave_noise_apply(plan: WallPlan, w, F_lz, F_t):
    """The linear chain of the wave sampler: (3p, gx, gy) real white
    noise -> per-mode factor application -> real plane fields -> z
    deconvolution -> 3D interpolation at the real particles. Shared by
    the sampler (factors = clamp+ sqrt) and the defect operator
    (factors = defect half), so their covariances add to sum_k G_k by
    construction."""
    grid3 = _wave_noise_pre(plan, w, F_lz, F_t)
    n = plan.n_real
    sub_real = plan._sub(plan.tbl_real, plan.pos_all[:n], plan.inv_real)
    return ewald.interpolate(sub_real, grid3)            # (N, 3)


def _wave_noise_pre(plan: WallPlan, w, F_lz, F_t):
    """Everything of the sampler chain BEFORE the 3D interpolation
    (pure FFT/einsum/gather ops, linear in w, NO lax.map inside): the
    split lets wave_defect_matvec transpose this part with
    jax.linear_transpose and use the engine's own `spread` as the exact
    adjoint of `interpolate` — jax.vjp through interpolate's lax.map
    plane sweep stacked its per-iteration window residuals across all
    plane chunks (an O(gx nzb cap_seg gy) tensor, 18.4 GB at bench
    slabs: the round-5 OOM that killed the first wall bench)."""
    p = plan.params
    t = _host_noise_tables(p)
    gx, gy, gz = p.grid
    gy2 = gy // 2 + 1
    pz = t["p"]
    dtype = plan.pos_all.dtype
    cdt = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    idx = jnp.asarray(t["mode_idx"])
    cos = jnp.asarray(t["cos"], dtype)
    sin = jnp.asarray(t["sin"], dtype)

    What = jnp.fft.rfft2(w, axes=(1, 2)).astype(cdt)
    Wm = What.reshape(3 * pz, gx * gy2)[:, idx]          # (3pz, M)
    wx, wy, wz = Wm[:pz], Wm[pz:2 * pz], Wm[2 * pz:]
    # z phases of the real transform T = diag(1_l, 1_t, i * 1_z) that
    # made G real (wall_kernels.wave_zkernel_nodes): the sampler applies
    # T^dagger F T so the per-mode map is Hermitian-EQUIVARIANT
    # (M(-k) = M(k)^*; in particular M_zz real). Dropping the INPUT
    # phase is covariance-neutral per isolated mode but breaks the
    # conjugate pairing of the explicitly-stored (+-kx, ky=0) column —
    # measured 12% covariance error confined to the x/z entries. At the
    # self-conjugate k = 0 mode the phase would rotate real noise onto
    # the imaginary axis irfft2 discards; the l<->z coupling vanishes
    # there, so both phases are set to 1.
    phz = jnp.where(jnp.asarray(t["kpar"] > 0.0),
                    jnp.asarray(-1j, cdt), jnp.asarray(1.0 + 0.0j, cdt))
    vl = cos[None] * wx + sin[None] * wy
    vt = -sin[None] * wx + cos[None] * wy
    v_lz = jnp.concatenate([vl, wz * jnp.conj(phz)[None, :]], axis=0)
    xi_lz = jnp.einsum("mij,jm->im", F_lz.astype(dtype),
                       v_lz, precision=lax.Precision.HIGHEST)
    xi_t = jnp.einsum("mij,jm->im", F_t.astype(dtype), vt,
                      precision=lax.Precision.HIGHEST)
    xl, xz = xi_lz[:pz], xi_lz[pz:]
    xz = xz * phz[None, :]
    ox = cos[None] * xl - sin[None] * xi_t
    oy = sin[None] * xl + cos[None] * xi_t
    out = jnp.concatenate([ox, oy, xz], axis=0)          # (3pz, M)
    # mode_idx is a strictly increasing unique set; declaring it lets
    # jax.linear_transpose transpose this scatter (defect adjoint)
    Z = (jnp.zeros((3 * pz, gx * gy2), cdt)
         .at[:, idx].set(out, unique_indices=True))
    psi = jnp.fft.irfft2(Z.reshape(3 * pz, gx, gy2), s=(gx, gy),
                         axes=(1, 2)).astype(dtype)      # (3pz, gx, gy)
    chi = jnp.asarray(t["chi"], dtype)                   # (pz, gz)
    return jnp.einsum("cpxy,pz->cxyz",
                      psi.reshape(3, pz, gx, gy), chi,
                      precision=lax.Precision.HIGHEST)   # (3, gx, gy, gz)


def wave_defect_matvec(plan: WallPlan, forces, factors=None):
    """Apply the PSD defect Delta = sum_k (clamp+(G_k) - G_k) of the
    wave sampler to (N, 3) forces: Delta = U Dh Dh^T U^T with U the
    sampler's linear chain, applied as forward(adjoint(f)). The adjoint
    is EXPLICIT: interpolate^T is the engine's own `spread` (same
    windows, exact transpose) and the scan-free pre-chain transposes
    via jax.linear_transpose — jax.vjp through interpolate's lax.map
    stacked per-plane window residuals into an 18 GB tensor at bench
    slabs. The noise split's Lanczos runs on M_near - Delta (see
    _noise_factors_device)."""
    p = plan.params
    dtype = plan.pos_all.dtype
    if factors is None:
        factors = _noise_factors_device(p, dtype)
    Dh_lz, Dh_t = factors[2], factors[3]
    t = _host_noise_tables(p)
    pz = t["p"]
    gx, gy = p.grid[0], p.grid[1]
    n = plan.n_real
    sub_real = plan._sub(plan.tbl_real, plan.pos_all[:n], plan.inv_real)

    f3 = forces.reshape(-1, 3).astype(dtype)
    grid_adj = ewald.spread(sub_real, f3)                # interpolate^T
    pre = functools.partial(_wave_noise_pre, plan, F_lz=Dh_lz, F_t=Dh_t)
    w0 = jax.ShapeDtypeStruct((3 * pz, gx, gy), dtype)
    (wt,) = jax.linear_transpose(pre, w0)(grid_adj)
    return _wave_noise_apply(plan, wt, Dh_lz, Dh_t)


def matvec(plan: WallPlan, forces, mesh=None, axis_name="blobs"):
    """Full single-wall RPY product M f, (N, 3) -> (N, 3) (or (N, 3B)
    stacked b-major), INCLUDING the reference's overlap regularization
    B^T M(z_eff) B (mobility/mobility.py:52-119): heights were shifted
    to z >= a at plan build and the damping B = min(z/a, 1) is applied
    to input strengths and output rows here. With a `mesh`, the
    gridding x-planes divide across devices and the xy transforms are
    distributed (matvec_sharded)."""
    if mesh is not None and mesh.shape[axis_name] > 1:
        return matvec_sharded(mesh, plan, forces, axis_name=axis_name)
    n = plan.n_real
    f2 = forces.reshape(n, -1)
    d = plan.damp[:, None]
    f2 = f2 * d
    out = near_matvec(plan, f2) + wave_matvec(plan, f2)
    out = out * d
    return out.reshape(forces.shape)


def matvec_multi(plan: WallPlan, forces, mesh=None, axis_name="blobs"):
    """(B, N, 3) stacked products in one engine sweep."""
    B, n = forces.shape[0], forces.shape[1]
    if B == 1:
        return matvec(plan, forces[0], mesh=mesh)[None]
    f = jnp.moveaxis(forces, 0, 1).reshape(n, 3 * B)
    out = matvec(plan, f, mesh=mesh)
    return jnp.moveaxis(out.reshape(n, B, 3), 1, 0)


def matvec_sharded(mesh, plan: WallPlan, forces, axis_name="blobs"):
    """Wall-mobility product sharded over a device mesh (the wall
    counterpart of ewald.matvec_sharded):

    - near field: the XLA cell sweep, replicated on every device;
    - gridding: x-planes divide across devices (_spread_planes /
      _interp_rows on per-device plane ids);
    - xy transforms: local y-rfft, ky-padded all_to_all transpose so
      the full x axis is local for the x-FFT, per-shard ky slices of
      the k-multipliers and the sliced z-DFTs;
    - polish columns: host-static per-shard (ky-grouped) column sets,
      applied on each device's local spectrum columns.

    The z axis (dense/polish) stays local per shard throughout.
    Falls back to a replicated wave part when gx % D != 0."""
    from jax import shard_map
    from jax.sharding import PartitionSpec

    D = mesh.shape[axis_name]
    p = plan.params
    n = plan.n_real
    gx, gy, gz = p.grid
    gy2 = gy // 2 + 1
    dtype = plan.pos_all.dtype
    cdt = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    wave_sharded = gx % D == 0
    gxd = gx // D if wave_sharded else gx
    gy2pd = -(-gy2 // D)
    gy2p = gy2pd * D
    (da, db), (ia, ib), (ra, rb) = _z_plane_ranges(p)
    nr = rb - ra
    zd = _host_zdft(p)

    # ---- host-static per-shard polish groups (ky-sharded columns).
    # polish_idx is flat kx-major over (gx, gy2); shard d owns padded-ky
    # rows [d gy2pd, (d+1) gy2pd). Dummy-padded columns point at a local
    # spectrum column but carry zero kernels.
    pol_idx_np, pol_kfft, _mask = _host_polish(p)
    iy = pol_idx_np % gy2
    ix = pol_idx_np // gy2
    shard_of = iy // gy2pd
    Pmax = max(int(np.max(np.bincount(shard_of, minlength=D))), 1)
    loc_idx = np.zeros((D, Pmax), np.int32)
    kfft_sh = np.zeros((D, Pmax) + pol_kfft.shape[1:], pol_kfft.dtype)
    for d in range(D):
        sel = np.nonzero(shard_of == d)[0]
        loc = ix[sel] * gy2pd + (iy[sel] - d * gy2pd)
        loc_idx[d, :len(sel)] = loc
        kfft_sh[d, :len(sel)] = pol_kfft[sel]
    loc_idx_d = jnp.asarray(loc_idx)
    kfft_re = jnp.asarray(kfft_sh.real.reshape(D, Pmax, 36, -1),
                          jnp.float32 if dtype == jnp.float32
                          else jnp.float64)
    kfft_im = jnp.asarray(kfft_sh.imag.reshape(D, Pmax, 36, -1),
                          kfft_re.dtype)

    # per-shard k-multiplier builder pieces (host freqs)
    kx_ax, ky_ax, kz_ax = _axis_freqs(p)
    ky_pad = np.concatenate([ky_ax, np.full(gy2p - gy2, ky_ax[-1])])
    whats = _host_whats(p)
    wy_pad = np.concatenate([whats[1], np.full(gy2p - gy2, 1.0)])
    # polish mask rebuilt host-side (plan.polish_mask is a device array;
    # this function may be traced)
    mask_np = np.ones(gx * gy2, bool)
    mask_np[pol_idx_np] = False
    mask_pad = jnp.asarray(np.concatenate(
        [mask_np.reshape(gx, gy2), np.zeros((gx, gy2p - gy2), bool)],
        axis=1))

    def _shard_wave_arrays(d):
        """Per-shard (gx, gy2pd, gz) multiplier tables, built from the
        global formulas at this shard's ky slice."""
        KX = jnp.asarray(kx_ax, dtype)[:, None, None]
        KY = lax.dynamic_slice_in_dim(jnp.asarray(ky_pad, dtype),
                                      d * gy2pd, gy2pd, 0)[None, :, None]
        KZ = jnp.asarray(kz_ax, dtype)[None, None, :]
        k2 = KX * KX + KY * KY + KZ * KZ
        k2s = jnp.where(k2 > 0, k2, 1.0)
        k = jnp.sqrt(k2s)
        phi = (1.0 + k2 / (4 * p.xi ** 2)) * jnp.exp(-k2 / (4 * p.xi ** 2))
        sinc = jnp.sin(k * p.a) / (k * p.a)
        h3 = float(np.prod(p.spacing))
        wx2 = jnp.asarray(whats[0], dtype) ** 2
        wy2 = lax.dynamic_slice_in_dim(jnp.asarray(wy_pad, dtype) ** 2,
                                       d * gy2pd, gy2pd, 0)
        wz2 = jnp.asarray(whats[2], dtype) ** 2
        norm = h3 / (wx2[:, None, None] * wy2[None, :, None]
                     * wz2[None, None, :])
        msk = lax.dynamic_slice_in_dim(mask_pad, d * gy2pd, gy2pd,
                                       1)[:, :, None].astype(dtype)
        kern = (sinc ** 2 * phi / (p.eta * k2s)) * norm * msk
        kern = jnp.where(k2 > 0, kern, 0.0)
        khat = jnp.stack([KX / k, KY / k, KZ / k * jnp.ones_like(kern)])
        khat = jnp.where(k2 > 0, khat, 0.0)
        base = phi * norm * msk / (8.0 * jnp.pi * p.eta)
        F4 = jnp.where(k2 > 0, base * (-8.0 * jnp.pi) / (k2s * k2s), 0.0)
        F2 = jnp.where(k2 > 0, base * (4.0 * jnp.pi) / k2s, 0.0)
        return KX, KY, KZ, kern, khat, F4, F2

    def shard_fn(pl_, f):
        d = lax.axis_index(axis_name)
        nc = f.shape[1]
        B = nc // 3
        un = near_matvec_xla(pl_, f)

        if not wave_sharded:
            return un + wave_matvec(pl_, f)

        # ---- wave field, distributed
        Wf_data, Wf_img, Wi = (
            lax.complex(jnp.asarray(re), jnp.asarray(im)).astype(cdt)
            for re, im in zd)
        prec = lax.Precision.HIGHEST
        mirror = jnp.asarray([1.0, 1.0, -1.0] * B, dtype)
        f_all = jnp.concatenate([f, -f * mirror], axis=0)
        h = pl_.heights[:, None]
        f_img = jnp.concatenate([f, h * f, (h * h) * f], axis=1)
        sub_all = pl_._sub(pl_.tbl_all, pl_.pos_all)
        sub_img = pl_._sub(pl_.tbl_img, pl_.pos_all[n:])
        plane_ids = d * gxd + jnp.arange(gxd, dtype=jnp.int32)
        KX, KY, KZ, kern, khat, F4, F2 = _shard_wave_arrays(d)
        zero = jnp.zeros((), cdt)
        kf = lax.complex(
            lax.dynamic_index_in_dim(kfft_re, d, 0, keepdims=False),
            lax.dynamic_index_in_dim(kfft_im, d, 0,
                                     keepdims=False)).astype(cdt)
        kf = kf.reshape(Pmax, 4, 3, 3, -1)
        pi_loc = lax.dynamic_index_in_dim(loc_idx_d, d, 0, keepdims=False)

        def to_spectrum(sub, fgrp, zlo, zhi):
            """Spread local planes -> local (C, gx, gy2pd, nzs) spectrum
            columns (full kx, this shard's ky)."""
            slab = ewald._spread_planes(sub, fgrp, plane_ids)
            g = jnp.moveaxis(slab[:, :, zlo:zhi, :], -1, 0)
            cy = jnp.fft.rfft(g, axis=2).astype(cdt)      # (C,gxd,gy2,nz)
            cy = jnp.pad(cy, ((0, 0), (0, 0), (0, gy2p - gy2), (0, 0)))
            cy = lax.all_to_all(cy, axis_name, split_axis=2,
                                concat_axis=1, tiled=True)
            return jnp.fft.fft(cy, axis=1)                # (C,gx,gy2pd,nz)

        prof_rows = []
        Uacc = jnp.zeros((3 * B, gx, gy2pd, nr), cdt)
        call = to_spectrum(sub_all, f_all, da, db)        # (3B,gx,gy2pd,·)
        for b in range(B):
            cxy = call[3 * b:3 * b + 3]
            prof_rows.append(jnp.zeros((3, Pmax, gz), cdt)
                             .at[:, :, da:db]
                             .set(cxy.reshape(3, gx * gy2pd, -1)[:, pi_loc]))
            ck = jnp.einsum("cxyz,zk->cxyk", cxy, Wf_data, precision=prec)
            kdotc = jnp.sum(khat * ck, axis=0, keepdims=True)
            Uk3 = kern[None] * (ck - khat * kdotc)
            Uacc = Uacc.at[3 * b:3 * b + 3].add(
                jnp.einsum("cxyk,kt->cxyt", Uk3, Wi, precision=prec))
        del call
        prof_img_rows = [None] * (3 * B)
        for m in range(3):
            cm = to_spectrum(sub_img, f_img[:, 3 * B * m:3 * B * (m + 1)],
                             ia, ib)
            for b in range(B):
                cxy = cm[3 * b:3 * b + 3]
                prof_img_rows[B * m + b] = (
                    jnp.zeros((3, Pmax, gz), cdt)
                    .at[:, :, ia:ib]
                    .set(cxy.reshape(3, gx * gy2pd, -1)[:, pi_loc]))
                ck = jnp.einsum("cxyz,zk->cxyk", cxy, Wf_img,
                                precision=prec)
                args = [zero] * 9
                args[3 * m:3 * m + 3] = [ck[0], ck[1], ck[2]]
                ux, uy, uz = gen.mult_terms(KX, KY, KZ, F4, F2,
                                            p.a * p.a, *args)
                Uacc = Uacc.at[3 * b:3 * b + 3].add(
                    jnp.einsum("cxyk,kt->cxyt", jnp.stack([ux, uy, uz]),
                               Wi, precision=prec))
        prof_all = jnp.concatenate(prof_rows, axis=0)
        prof_img = jnp.concatenate(prof_img_rows, axis=0)
        pa = prof_all.reshape(B, 3, -1, gz)
        pim = prof_img.reshape(3, B, 3, -1, gz)
        pin = jnp.concatenate([pa[:, None], jnp.moveaxis(pim, 0, 1)],
                              axis=1)
        pin_f = jnp.fft.fft(pin, n=2 * gz, axis=-1)
        out_f = jnp.einsum("pcijL,bcjpL->bipL", kf, pin_f,
                           precision=jax.lax.Precision.HIGHEST)
        pout = jnp.fft.ifft(out_f, axis=-1)[..., ra:rb]
        pout = pout.reshape(3 * B, -1, nr)
        Uacc = Uacc.reshape(3 * B, gx * gy2pd, nr).at[:, pi_loc].add(pout)
        Uacc = Uacc.reshape(3 * B, gx, gy2pd, nr)

        # inverse transforms: x-ifft local, transpose back, y-irfft
        Uacc = jnp.fft.ifft(Uacc, axis=1)
        Uacc = lax.all_to_all(Uacc, axis_name, split_axis=1,
                              concat_axis=2, tiled=True)
        Uacc = Uacc[:, :, :gy2, :]                       # (3B,gxd,gy2,nr)
        Ur = jnp.fft.irfft(Uacc, n=gy, axis=2).astype(dtype)
        Uloc = (jnp.zeros((gxd, gy, gz, 3 * B), dtype)
                .at[:, :, ra:rb, :].set(jnp.moveaxis(Ur, 0, -1)))
        sub_real = pl_._sub(pl_.tbl_real, pl_.pos_all[:n], pl_.inv_real)
        wrows_local = ewald._interp_rows(sub_real, Uloc, plane_ids)
        wrows = lax.all_gather(wrows_local.reshape(-1, nc), axis_name,
                               axis=0, tiled=True)
        wrows = jnp.concatenate(
            [wrows, jnp.zeros((1, nc), wrows.dtype)], axis=0)
        uw = jnp.sum(wrows[pl_.inv_real], axis=1)
        return un + uw.astype(dtype)

    f2 = forces.reshape(n, -1)
    damp = plan.damp[:, None]
    f2 = f2 * damp
    args = (plan, f2)
    specs = jax.tree_util.tree_map(lambda _: PartitionSpec(), args)
    out = shard_map(shard_fn, mesh=mesh, in_specs=specs,
                    out_specs=PartitionSpec(), check_vma=False)(*args)
    out = out * damp
    return out.reshape(forces.shape)


# ---------------------------------------------------------------------------
# Brute-force oracle (tests): converged direct image-box sum
# ---------------------------------------------------------------------------


def brute_force_wall(positions, forces, a, eta, box_xy, n_img=30):
    """Direct xy-periodic wall mobility: sum RPY + Swan-Brady wall
    blocks over (2 n_img + 1)^2 image boxes (numpy, f64). The combined
    real+image kernel decays like 1/rho^3 in-plane, so the lattice sum
    converges absolutely; n_img ~ 30+ reaches ~1e-4 of the self scale
    on small boxes (tests pair it with Richardson extrapolation)."""
    import jax as _jax

    pos = np.asarray(positions, np.float64)
    f = np.asarray(forces, np.float64).reshape(-1, 3)
    n = pos.shape[0]
    Lx, Ly = box_xy
    from . import rpy

    u = np.zeros_like(f)
    shifts = [(ix * Lx, iy * Ly)
              for ix in range(-n_img, n_img + 1)
              for iy in range(-n_img, n_img + 1)]
    shifts = np.asarray(shifts)                    # (S, 2)
    pos_j = pos[None, :, :] + np.concatenate(
        [shifts, np.zeros((len(shifts), 1))], axis=1)[:, None, :]
    # pairwise over all shifted sources, scaled units
    for i in range(n):
        d = (pos[i][None, None, :] - pos_j) / a    # (S, n, 3)
        r2 = np.sum(d * d, axis=-1)
        self_mask = np.zeros(r2.shape, bool)
        # self = same particle in the HOME box only
        home = np.all(shifts == 0.0, axis=1)
        self_mask[home] = (np.arange(n) == i)[None, :]
        m = np.asarray(rpy.rpy_tt(jnp.asarray(d), jnp.asarray(self_mask)))
        hz_t = pos[i, 2] / a
        hz_s = pos_j[..., 2] / a
        w = np.asarray(rpy.wall_tt(
            jnp.asarray(d[..., 0]), jnp.asarray(d[..., 1]),
            jnp.asarray(hz_t + hz_s), jnp.asarray(hz_s),
            jnp.asarray(self_mask)))
        u[i] = np.einsum("snij,nj->i", m + w, f) / (8 * np.pi * eta * a)
    return u
