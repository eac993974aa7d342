"""Inextensible-fiber (Kirchhoff rod) suspensions.

Accelerator re-design of the reference's C++ fiber stack
(/root/reference/cRigid_cFibers/c_fibers_obj.cpp, driven by
Many_Free_Fibers.py / Carpet_of_Fibers.py): each fiber is a chain of
B = L+1 blobs connected by L inextensible links of length ds, evolved by
overdamped Stokesian dynamics with semi-implicit bending elasticity and
a midpoint stochastic scheme.

Formulation (c_fibers_obj.cpp:1024-1135):
  state per fiber = (x0, tangents t_j, bishop frame u_j, v_j = t_j x u_j);
  unknowns per step = rigid-motion rates ``om`` (base velocity w for free
  fibers + two rotation rates per link) and link tensions ``theta``; the
  square system in (om, theta) is

      K om + impl * M D4 (K om) - M B theta = RHS,
      impl = impl_c * dt * k_bend / ds^3,

  where K maps rates to blob velocities (cumulative sum of ds * Omega x t,
  c_fibers_obj.cpp:1017-1047), B maps tensions to blob forces (discrete
  divergence of theta t, :1049-1075), D4 is the bending biharmonic
  stencil (:929-975), and M is the blob mobility.  Inextensibility is
  enforced kinematically: blob velocities are *parameterized* as K om, so
  no constraint rows are needed and the system is square
  (nOm + nTheta = 3B).

Design decisions (vs the reference):
  * All fibers share one static (F, L, 3) shape; every per-fiber loop is
    a batched einsum / cumsum, no Python loops over fibers.
  * The reference's per-fiber LAPACK banded saddle PC
    (c_fibers_obj.cpp:639-882: permuted dgbsv on a bands-limited local
    mobility) becomes a batched dense LU of the per-fiber system matrix
    [K + impl M_f D4 K, -M_f B] with the *full* per-fiber mobility —
    batched (3B)^2 factorizations are matmul-friendly and the PC is exact
    (not band-truncated) whenever hydrodynamics is per-fiber
    ("batched"), making GMRES converge in O(1) iterations.
  * hydrodynamics="batched" (reference DomainInt 0/2: no interfiber
    hydro) evaluates M as batched dense matmuls; "full" (DomainInt 1/3)
    uses the O(N^2) pairwise engine (ops/mobility.pairwise_matvec) over
    all F*B blobs, with the batched dense blocks kept as preconditioner.
  * Brownian increments M^{1/2} W use exact batched Cholesky in batched
    mode (replacing the solver library's internal Lanczos) and the
    shared Lanczos machinery in full mode.
  * frame_rot re-orthonormalizes the frame (t normalized, u projected,
    v = t x u) instead of only normalizing as the reference does
    (c_fibers_obj.cpp:1137-1191) — same O(dt^2) accuracy, better
    long-run frame integrity.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import mobility as mob
from ..ops.gmres import gmres
from ..ops.lanczos import stochastic_forcing_lanczos


@dataclasses.dataclass(frozen=True)
class FiberSuspension:
    """Static description of F identical-length fibers with L links.

    k_bend: bending stiffness (kappa); persistence length = k_bend / kT.
    impl_c: implicitness of the bending solve — 0.5 Crank-Nicolson,
    1.0 backward Euler (Many_Free_Fibers.py:176-181).
    clamp: fibers anchored at their first blob with ghost tangent t_fix
    (c_fibers_obj.cpp:254-268 ``T_fix``).
    hydrodynamics: "batched" = per-fiber mobility only (reference
    DomainInt 0/2), "full" = all-pairs (DomainInt 1/3).
    """

    num_fibers: int
    num_links: int
    ds: float
    a: float
    k_bend: float
    eta: float = 1.0
    kT: float = 0.0
    impl_c: float = 0.5
    clamp: bool = False
    t_fix: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    hydrodynamics: str = "batched"
    domain: str = "no_wall"
    solver_tolerance: float = 1e-4
    gmres_restart: int = 100
    gmres_maxiter: int = 300
    rf_delta_factor: float = 0.05  # delta = factor * ds^{3/2} (:1202)
    force_fn: Optional[Callable] = None  # (sus, positions (F,B,3)) -> F,B,3

    def __post_init__(self):
        if self.num_links < 3:
            raise ValueError("fibers need at least 3 links (the bending "
                             "stencil boundary rows assume it; same as "
                             "the reference)")
        if self.hydrodynamics not in ("batched", "full"):
            raise ValueError(f"hydrodynamics={self.hydrodynamics!r}")
        if self.domain not in ("no_wall", "single_wall"):
            raise ValueError(f"domain={self.domain!r}")

    @property
    def num_blobs_per_fiber(self) -> int:
        return self.num_links + 1

    @property
    def num_blobs(self) -> int:
        return self.num_fibers * self.num_blobs_per_fiber

    @property
    def n_om(self) -> int:
        # free: base velocity (3) + 2 rates/link; clamp: rates only
        return 2 * self.num_links + (0 if self.clamp else 3)

    @property
    def n_theta(self) -> int:
        # clamp adds a 3-vector reaction force at the anchored blob
        return self.num_links + (3 if self.clamp else 0)

    @property
    def m0(self) -> float:
        return 1.0 / (6.0 * np.pi * self.eta * self.a)


class FiberState(NamedTuple):
    x0: jax.Array  # (F, 3) first-blob positions
    t: jax.Array   # (F, L, 3) unit link tangents
    u: jax.Array   # (F, L, 3) bishop-frame normal
    v: jax.Array   # (F, L, 3) bishop-frame binormal (= t x u)


class FiberAux(NamedTuple):
    tensions: jax.Array
    rates: jax.Array
    iterations: jax.Array
    residual: jax.Array
    converged: jax.Array


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def bishop_frame(t, u0=None):
    """Parallel-transport (bishop) frame along each fiber
    (Many_Free_Fibers.py:46-77): u_0 given (or any unit vector normal to
    t_0), then u_{k+1} = R(t_k -> t_{k+1}) u_k via the rotation that
    carries t_k onto t_{k+1}; v = t x u.

    t: (F, L, 3) unit tangents. Returns (u, v) with the same shape.
    """
    t = jnp.asarray(t)
    if u0 is None:
        seed = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], t.dtype),
                                t[:, 0, :].shape)
        alt = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], t.dtype),
                               t[:, 0, :].shape)
        # pick whichever seed is less parallel to t_0
        par = jnp.abs(jnp.sum(seed * t[:, 0, :], axis=-1, keepdims=True))
        seed = jnp.where(par > 0.9, alt, seed)
        u0 = seed - jnp.sum(seed * t[:, 0, :], axis=-1, keepdims=True) \
            * t[:, 0, :]
        u0 = u0 / jnp.linalg.norm(u0, axis=-1, keepdims=True)

    def transport(u_k, ts):
        t_k, t_kp = ts
        cos_th = jnp.sum(t_k * t_kp, axis=-1, keepdims=True)
        rot = jnp.cross(t_k, t_kp)
        u_kp = (u_k + jnp.cross(rot, u_k)
                + jnp.cross(rot, jnp.cross(rot, u_k)) / (1.0 + cos_th))
        return u_kp, u_kp

    # scan over links; (L-1) transports from u_0
    ts = (jnp.moveaxis(t[:, :-1], 1, 0), jnp.moveaxis(t[:, 1:], 1, 0))
    _, u_rest = jax.lax.scan(transport, u0, ts)
    u = jnp.concatenate([u0[:, None, :], jnp.moveaxis(u_rest, 0, 1)], axis=1)
    v = jnp.cross(t, u)
    return u, v


def blob_positions(sus: FiberSuspension, state: FiberState):
    """(F, B, 3): x0 + ds * cumsum(t) (c_fibers_obj.cpp:336-357)."""
    steps = sus.ds * jnp.cumsum(state.t, axis=1)
    return jnp.concatenate(
        [state.x0[:, None, :], state.x0[:, None, :] + steps], axis=1)


def end_to_end_distance(sus: FiberSuspension, state: FiberState):
    """(F,) |x_B - x_0| = ds |sum_j t_j| (c_fibers_obj.cpp:393-410)."""
    return sus.ds * jnp.linalg.norm(jnp.sum(state.t, axis=1), axis=-1)


def straight_fiber_state(sus: FiberSuspension, x0, direction):
    """All-fibers-identical straight initial state."""
    d = np.asarray(direction, dtype=np.float64)
    d = d / np.linalg.norm(d)
    t = jnp.broadcast_to(jnp.asarray(d),
                         (sus.num_fibers, sus.num_links, 3))
    u, v = bishop_frame(t)
    x0 = jnp.broadcast_to(
        jnp.asarray(x0, dtype=t.dtype).reshape(-1, 3),
        (sus.num_fibers, 3))
    return FiberState(x0=x0, t=t, u=u, v=v)


# ---------------------------------------------------------------------------
# Elasticity: bending energy, force, and the D4 stencil
# ---------------------------------------------------------------------------


def bending_energy(sus: FiberSuspension, t):
    """E = (k_bend / 2 ds) sum_j |t_j - t_{j-1}|^2 per fiber, summed.

    For clamped fibers the ghost joint (t_fix, t_0) is included
    (c_fibers_obj.cpp Compute_F clamp branch :1280-1291). Discrete
    worm-like chain: joint stiffness alpha = k_bend/(ds kT)."""
    diff = t[:, 1:] - t[:, :-1]
    e = jnp.sum(diff * diff)
    if sus.clamp:
        ghost = t[:, 0] - jnp.asarray(sus.t_fix, t.dtype)
        e = e + jnp.sum(ghost * ghost)
    return 0.5 * sus.k_bend / sus.ds * e


def bending_force(sus: FiberSuspension, t):
    """F = -dE/dX as a tangent stencil, (F, B, 3).

    The stencil rows are the reference's Compute_F
    (c_fibers_obj.cpp:1239-1316), which computes grad E = -F; this
    returns the force itself. Verified against jax.grad of
    bending_energy in tests/test_fibers.py."""
    F, L, _ = t.shape
    f_c = sus.k_bend / sus.ds**2
    z = jnp.zeros((F, 1, 3), t.dtype)
    # shifted tangents aligned to blob index j = 0..L
    tm2 = jnp.concatenate([z, z, t[:, :-1]], axis=1)   # t_{j-2}
    tm1 = jnp.concatenate([z, t], axis=1)              # t_{j-1}
    tp0 = jnp.concatenate([t, z], axis=1)              # t_j
    tp1 = jnp.concatenate([t[:, 1:], z, z], axis=1)    # t_{j+1}
    # generic interior row of grad E (blobs 2..L-2)
    g = f_c * (tp1 - 3.0 * tp0 + 3.0 * tm1 - tm2)
    # boundary rows (blobs 0, 1, L-1, L); L >= 3 enforced at build
    g = g.at[:, 0].set(f_c * (t[:, 1] - t[:, 0]))
    g = g.at[:, 1].set(f_c * (t[:, 2] - 3.0 * t[:, 1] + 2.0 * t[:, 0]))
    g = g.at[:, L - 1].set(
        -f_c * (t[:, L - 3] - 3.0 * t[:, L - 2] + 2.0 * t[:, L - 1]))
    g = g.at[:, L].set(f_c * (t[:, L - 1] - t[:, L - 2]))
    if sus.clamp:
        t_fix = jnp.asarray(sus.t_fix, t.dtype)
        g = g.at[:, 0].set(0.0)
        g = g.at[:, 1].set(
            f_c * (t[:, 2] - 3.0 * t[:, 1] + 3.0 * t[:, 0] - t_fix))
    return -g


def d4_matrix(sus: FiberSuspension, dtype=jnp.float64):
    """(B, B) biharmonic stencil S with free/clamped boundary rows
    (c_fibers_obj.cpp ds_D4_v :929-975, WITHOUT the `impl` prefactor);
    the operator acts componentwise: D4 X = S X."""
    B = sus.num_blobs_per_fiber
    # D2: (B-2, B) second difference; free D4 = D2^T D2
    d2 = np.zeros((B - 2, B))
    for i in range(B - 2):
        d2[i, i], d2[i, i + 1], d2[i, i + 2] = 1.0, -2.0, 1.0
    s = d2.T @ d2
    if sus.clamp:
        # clamp energy |x_1 - x_0 - ds t_fix|^2 adds (e1 - e0)(e1 - e0)^T;
        # row 0 (anchored blob) is zeroed (c_fibers_obj.cpp:944-952)
        s[1, 0] -= 1.0
        s[1, 1] += 1.0
        s[0, :] = 0.0
    return jnp.asarray(s, dtype)


def d2t_matrix(sus: FiberSuspension, dtype=jnp.float64):
    """(B, B-2) transpose second-difference map used by the BE noise
    D2^T W (c_fibers_obj.cpp calc_D2_W :1318-1375)."""
    B = sus.num_blobs_per_fiber
    d2 = np.zeros((B - 2, B))
    for i in range(B - 2):
        d2[i, i], d2[i, i + 1], d2[i, i + 2] = 1.0, -2.0, 1.0
    return jnp.asarray(d2.T, dtype)


# ---------------------------------------------------------------------------
# Kinematic operators K, Kinv, B
# ---------------------------------------------------------------------------


def split_om(sus: FiberSuspension, om):
    """om (F, n_om) -> (w (F,3) or None, rates (F, L, 2))."""
    if sus.clamp:
        return None, om.reshape(sus.num_fibers, sus.num_links, 2)
    w = om[:, :3]
    rates = om[:, 3:].reshape(sus.num_fibers, sus.num_links, 2)
    return w, rates


def merge_om(sus: FiberSuspension, w, rates):
    flat = rates.reshape(sus.num_fibers, 2 * sus.num_links)
    if sus.clamp:
        return flat
    return jnp.concatenate([w, flat], axis=1)


def apply_K(sus: FiberSuspension, om, u, v):
    """Blob velocities from rates (c_fibers_obj.cpp apply_K :977-1010):
    vel_0 = w (0 if clamped); vel_{j+1} = vel_j + ds (om_v_j u_j -
    om_u_j v_j). Returns (F, B, 3)."""
    w, rates = split_om(sus, om)
    txom = rates[..., 1:2] * u - rates[..., 0:1] * v  # Omega_j x t_j
    steps = sus.ds * jnp.cumsum(txom, axis=1)
    if w is None:
        w = jnp.zeros((sus.num_fibers, 3), om.dtype)
    return jnp.concatenate([w[:, None, :], w[:, None, :] + steps], axis=1)


def apply_Kinv(sus: FiberSuspension, vel, u, v):
    """Pseudo-inverse of K (c_fibers_obj.cpp Kinv_multi :413-468):
    Dp_j = (vel_{j+1} - vel_j)/ds; om_u = -v . Dp, om_v = u . Dp;
    base velocity = vel_0 (free). vel: (F, B, 3) -> om (F, n_om)."""
    dp = (vel[:, 1:] - vel[:, :-1]) / sus.ds
    om_u = -jnp.sum(v * dp, axis=-1)
    om_v = jnp.sum(u * dp, axis=-1)
    rates = jnp.stack([om_u, om_v], axis=-1)
    return merge_om(sus, vel[:, 0, :], rates)


def split_theta(sus: FiberSuspension, theta):
    """theta (F, n_theta) -> (reaction (F,3) or None, tensions (F, L))."""
    if sus.clamp:
        return theta[:, :3], theta[:, 3:]
    return None, theta


def apply_B(sus: FiberSuspension, theta, t):
    """Blob forces from link tensions (c_fibers_obj.cpp apply_B
    :1012-1045): f_j = theta_{j-1} t_{j-1} - theta_j t_j (boundary
    one-sided); clamped fibers add a free reaction force on blob 0.
    Returns (F, B, 3)."""
    reaction, tens = split_theta(sus, theta)
    tt = tens[..., None] * t  # (F, L, 3)
    z = jnp.zeros((sus.num_fibers, 1, 3), t.dtype)
    f = jnp.concatenate([z, tt], axis=1) - jnp.concatenate([tt, z], axis=1)
    if sus.clamp:
        f = f.at[:, 0, :].set(reaction)
    return f


def apply_BT(sus: FiberSuspension, vel, t):
    """(B^T vel)_j = t_j . (vel_{j+1} - vel_j); for clamped fibers the
    reaction rows prepend vel_0 and the theta_0 row loses its vel_0 term
    (blob-0 force row is the reaction, Sparse_B_mat clamp branch,
    c_fibers_obj.cpp:608-618). Returns (F, n_theta)."""
    bt = jnp.sum(t * (vel[:, 1:] - vel[:, :-1]), axis=-1)
    if sus.clamp:
        bt = bt.at[:, 0].add(jnp.sum(t[:, 0] * vel[:, 0], axis=-1))
        return jnp.concatenate([vel[:, 0, :], bt], axis=1)
    return bt


def k_dense(sus: FiberSuspension, u, v):
    """(F, 3B, n_om) dense K, via application to a basis (shared basis
    across fibers, one pass of vmapped apply_K)."""
    eye = jnp.eye(sus.n_om, dtype=u.dtype)

    def col(e):
        om = jnp.broadcast_to(e, (sus.num_fibers, sus.n_om))
        return apply_K(sus, om, u, v).reshape(sus.num_fibers, -1)

    cols = jax.vmap(col)(eye)  # (n_om, F, 3B)
    return jnp.moveaxis(cols, 0, 2)


def b_dense(sus: FiberSuspension, t):
    """(F, 3B, n_theta) dense B."""
    eye = jnp.eye(sus.n_theta, dtype=t.dtype)

    def col(e):
        th = jnp.broadcast_to(e, (sus.num_fibers, sus.n_theta))
        return apply_B(sus, th, t).reshape(sus.num_fibers, -1)

    cols = jax.vmap(col)(eye)
    return jnp.moveaxis(cols, 0, 2)


# ---------------------------------------------------------------------------
# Mobility
# ---------------------------------------------------------------------------


def mobility_dense_batched(sus: FiberSuspension, pos):
    """Per-fiber dense blob mobility (F, 3B, 3B) — RPY, or wall-corrected
    Swan-Brady for domain='single_wall' (the PC mobility, and the full
    hydrodynamics of 'batched' mode; reference DomainInt 0/2)."""
    def one(r):
        return mob.dense_mobility(r, sus.eta, sus.a, domain=sus.domain,
                                  coupling="tt")

    return jax.vmap(one)(pos)


def mobility_matvec(sus: FiberSuspension, pos, f, *, m_batched=None):
    """M f over all blobs; f, result (F, B, 3)."""
    if sus.hydrodynamics == "batched":
        if m_batched is None:
            m_batched = mobility_dense_batched(sus, pos)
        out = jnp.einsum("fij,fj->fi", m_batched,
                         f.reshape(sus.num_fibers, -1))
        return out.reshape(f.shape)
    flat = pos.reshape(-1, 3)
    out = mob.pairwise_matvec(flat, flat, f.reshape(-1, 3), sus.eta, sus.a,
                              coupling="tt", domain=sus.domain)
    return out.reshape(f.shape)


def sqrt_mobility_noise(sus: FiberSuspension, pos, key, *, m_batched=None,
                        lanczos_max_iter=64):
    """M^{1/2} W with W ~ N(0, I): exact batched Cholesky in 'batched'
    mode (replacing the reference solver library's internal sqrtMdotW),
    Lanczos in 'full' mode. Returns ((F, B, 3), iterations)."""
    shape = (sus.num_fibers, 3 * sus.num_blobs_per_fiber)
    w = jax.random.normal(key, shape, dtype=pos.dtype)
    if sus.hydrodynamics == "batched":
        if m_batched is None:
            m_batched = mobility_dense_batched(sus, pos)
        chol = jnp.linalg.cholesky(m_batched)
        out = jnp.einsum("fij,fj->fi", chol, w)
        return out.reshape(sus.num_fibers, -1, 3), jnp.asarray(0)

    flat = pos.reshape(-1, 3)

    def matvec(x):
        return mob.pairwise_matvec(flat, flat, x.reshape(-1, 3), sus.eta,
                                   sus.a, coupling="tt",
                                   domain=sus.domain).reshape(-1)

    res = stochastic_forcing_lanczos(
        matvec, w.reshape(-1), tolerance=sus.solver_tolerance,
        max_iter=lanczos_max_iter)
    return res.noise.reshape(sus.num_fibers, -1, 3), res.iterations


# ---------------------------------------------------------------------------
# Frame rotation (the state update)
# ---------------------------------------------------------------------------


def frame_rot(sus: FiberSuspension, state: FiberState, om, delta):
    """Rotate every link frame by delta * Omega_j (Omega_j = om_u u_j +
    om_v v_j) via Rodrigues, translate x0 by delta * w, and
    re-orthonormalize (c_fibers_obj.cpp frame_rot :1137-1191)."""
    w, rates = split_om(sus, om)
    omega = rates[..., 0:1] * state.u + rates[..., 1:2] * state.v
    mag = jnp.linalg.norm(omega, axis=-1, keepdims=True)
    safe = jnp.maximum(mag, jnp.asarray(1e-30, omega.dtype))
    axis = omega / safe
    theta = delta * mag
    c, s = jnp.cos(theta), jnp.sin(theta)

    def rot(x):
        return (c * x + s * jnp.cross(axis, x)
                + (1.0 - c) * jnp.sum(axis * x, axis=-1, keepdims=True)
                * axis)

    t = rot(state.t)
    u = rot(state.u)
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
    u = u - jnp.sum(u * t, axis=-1, keepdims=True) * t
    u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
    v = jnp.cross(t, u)
    x0 = state.x0 if w is None else state.x0 + delta * w
    return FiberState(x0=x0, t=t, u=u, v=v)


# ---------------------------------------------------------------------------
# The linear system and its preconditioner
# ---------------------------------------------------------------------------


def system_matrix_batched(sus: FiberSuspension, impl, state: FiberState,
                          *, m_batched=None):
    """(F, 3B, 3B) per-fiber matrix [K + impl M_f D4 K | -M_f B] in
    (om, theta) column order. In 'batched' mode this IS the full
    operator; in 'full' mode it is the block-diagonal preconditioner
    (the batched replacement for the reference's banded LAPACK PC,
    c_fibers_obj.cpp:639-882)."""
    if m_batched is None:
        m_batched = mobility_dense_batched(sus, blob_positions(sus, state))
    kd = k_dense(sus, state.u, state.v)        # (F, 3B, n_om)
    bd = b_dense(sus, state.t)                 # (F, 3B, n_theta)
    s = d4_matrix(sus, dtype=kd.dtype)         # (B, B) componentwise
    B = sus.num_blobs_per_fiber
    kd3 = kd.reshape(sus.num_fibers, B, 3, sus.n_om)
    d4k = jnp.einsum("bc,fcdn->fbdn", s, kd3).reshape(kd.shape)
    left = kd + impl * jnp.einsum("fij,fjn->fin", m_batched, d4k)
    right = -jnp.einsum("fij,fjn->fin", m_batched, bd)
    return jnp.concatenate([left, right], axis=2)


def apply_system(sus: FiberSuspension, impl, state: FiberState, x, *,
                 m_batched=None):
    """Matrix-free operator for 'full' hydrodynamics: x = (om|theta)
    flattened (F * 3B,) -> residual-space vector."""
    F = sus.num_fibers
    x = x.reshape(F, -1)
    om, theta = x[:, :sus.n_om], x[:, sus.n_om:]
    kom = apply_K(sus, om, state.u, state.v)     # (F, B, 3)
    s = d4_matrix(sus, dtype=x.dtype)
    d4kom = jnp.einsum("bc,fcd->fbd", s, kom)
    btheta = apply_B(sus, theta, state.t)
    pos = blob_positions(sus, state)
    mf = mobility_matvec(sus, pos, impl * d4kom - btheta,
                         m_batched=m_batched)
    return (kom + mf).reshape(-1)


def factor_pc(sus: FiberSuspension, impl, state: FiberState, *,
              m_batched=None):
    """Batched LU of the per-fiber system matrix; returns a pc(x)
    callable for right-preconditioned GMRES."""
    mat = system_matrix_batched(sus, impl, state, m_batched=m_batched)
    lu, piv = jax.vmap(jax.scipy.linalg.lu_factor)(mat)

    def pc(x):
        xs = x.reshape(sus.num_fibers, -1)
        sol = jax.vmap(jax.scipy.linalg.lu_solve)((lu, piv), xs)
        return sol.reshape(-1)

    return pc


def solve_fiber_system(sus: FiberSuspension, impl, state: FiberState, rhs,
                       *, m_batched=None, x0=None):
    """Solve [K + impl M D4 K, -M B] (om, theta) = rhs.

    rhs: (F, B, 3) velocity-space right-hand side. Returns
    (om (F, n_om), theta (F, n_theta), GmresResult)."""
    pc = factor_pc(sus, impl, state, m_batched=m_batched)
    b = rhs.reshape(-1)
    if sus.hydrodynamics == "batched":
        # the PC is the exact inverse: one solve, no Krylov loop
        x = pc(b)
        res = None
        its = jnp.asarray(1)
        # cheap residual check via one operator application
        r = apply_system(sus, impl, state, x, m_batched=m_batched) - b
        resid = jnp.linalg.norm(r) / jnp.maximum(jnp.linalg.norm(b), 1e-300)
        converged = resid < jnp.asarray(10 * sus.solver_tolerance, b.dtype)
    else:
        def matvec(x):
            return apply_system(sus, impl, state, x, m_batched=m_batched)

        res = gmres(matvec, b, x0=x0, tol=sus.solver_tolerance,
                    restart=sus.gmres_restart, maxiter=sus.gmres_maxiter,
                    M=pc)
        x, its, resid, converged = (res.x, res.iterations,
                                    res.residual_norm, res.converged)
    xs = x.reshape(sus.num_fibers, -1)
    return xs[:, :sus.n_om], xs[:, sus.n_om:], (its, resid, converged)


# ---------------------------------------------------------------------------
# Random finite difference (thermal drift)
# ---------------------------------------------------------------------------


def m_rfd(sus: FiberSuspension, state: FiberState, key):
    """kT-free RFD vector (1/delta)(M(q+) - M(q-)) W with q+- the state
    rotated by +-delta/2 Kinv(W) (c_fibers_obj.cpp M_RFD :1193-1237);
    multiply by kT at use site."""
    B = sus.num_blobs_per_fiber
    delta = sus.rf_delta_factor * sus.ds ** 1.5
    w = jax.random.normal(key, (sus.num_fibers, B, 3),
                          dtype=state.x0.dtype)
    om_w = apply_Kinv(sus, w, state.u, state.v)
    sp = frame_rot(sus, state, om_w, 0.5 * delta)
    sm = frame_rot(sus, state, om_w, -0.5 * delta)
    mp = mobility_matvec(sus, blob_positions(sus, sp), w)
    mm = mobility_matvec(sus, blob_positions(sus, sm), w)
    return (mp - mm) / delta


# ---------------------------------------------------------------------------
# Time stepping
# ---------------------------------------------------------------------------


def make_stepper(sus: FiberSuspension, dt: float, *,
                 lanczos_max_iter: int = 64):
    """step(state, key) -> (state, FiberAux).

    Deterministic (kT=0) semi-implicit step, or the stochastic midpoint
    scheme (c_fibers_obj.cpp RHS_and_Midpoint :1400-1460 + the driver
    loop Many_Free_Fibers.py:275-308): predictor half-step rotation by
    the Brownian velocity, corrector solve at the midpoint
    configuration, final full-dt frame rotation from the original state.
    impl_c selects Crank-Nicolson (0.5) or backward-Euler (1.0) noise.
    """
    impl = sus.impl_c * dt * sus.k_bend / sus.ds**3
    cn = abs(sus.impl_c - 1.0) > 1e-5

    def external_force(pos):
        if sus.force_fn is None:
            return jnp.zeros_like(pos)
        return sus.force_fn(sus, pos)

    def step(state: FiberState, key):
        pos = blob_positions(sus, state)
        m_b = (mobility_dense_batched(sus, pos)
               if sus.hydrodynamics == "batched" else None)
        f = bending_force(sus, state.t) + external_force(pos)
        rhs = mobility_matvec(sus, pos, f, m_batched=m_b)
        state_h = state

        if sus.kT > 0.0:
            k1, k2, k3 = jax.random.split(key, 3)
            mhw1, _ = sqrt_mobility_noise(sus, pos, k1, m_batched=m_b,
                                          lanczos_max_iter=lanczos_max_iter)
            rfd = sus.kT * m_rfd(sus, state, k3)
            if cn:
                c1 = 2.0 * jnp.sqrt(sus.kT / dt)
                bi_half = c1 * mhw1
                mhw2, _ = sqrt_mobility_noise(
                    sus, pos, k2, m_batched=m_b,
                    lanczos_max_iter=lanczos_max_iter)
                bi = jnp.sqrt(sus.kT / dt) * (mhw1 - mhw2)
            else:
                if sus.clamp:
                    raise NotImplementedError(
                        "backward-Euler noise for clamped fibers "
                        "(matches the reference, c_fibers_obj.cpp:1341)")
                c1 = jnp.sqrt(2.0 * sus.kT / dt)
                bi_half = c1 * mhw1
                w2 = jax.random.normal(
                    k2, (sus.num_fibers, sus.num_blobs_per_fiber - 2, 3),
                    dtype=pos.dtype)
                d2t = d2t_matrix(sus, dtype=pos.dtype)
                d2w = jnp.einsum("bc,fcd->fbd", d2t, w2)
                md2w = mobility_matvec(sus, pos, d2w, m_batched=m_b)
                bi = c1 * (mhw1 + jnp.sqrt(0.5 * impl) * md2w)
            rhs = rhs + rfd + bi
            om_half = apply_Kinv(sus, bi_half, state.u, state.v)
            state_h = frame_rot(sus, state, om_half, 0.5 * dt)

        # solve at the (midpoint) configuration
        m_b_h = (mobility_dense_batched(sus, blob_positions(sus, state_h))
                 if sus.hydrodynamics == "batched" else None)
        om, theta, (its, resid, conv) = solve_fiber_system(
            sus, impl, state_h, rhs, m_batched=m_b_h)
        new_state = frame_rot(sus, state, om, dt)
        aux = FiberAux(tensions=theta, rates=om, iterations=its,
                       residual=resid, converged=conv)
        return new_state, aux

    return step


def simulate(sus: FiberSuspension, state: FiberState, key, *, dt, n_steps,
             save_every=1, **kw):
    """lax.scan time loop; returns (final state, stacked saved states)."""
    step = make_stepper(sus, dt, **kw)

    def outer(carry, _):
        state, key = carry

        def inner(carry, _):
            state, key = carry
            key, sub = jax.random.split(key)
            state, aux = step(state, sub)
            return (state, key), aux

        (state, key), aux = jax.lax.scan(inner, (state, key), None,
                                         length=save_every)
        return (state, key), (state, jax.tree.map(lambda x: x[-1], aux))

    (state, key), (traj, aux) = jax.lax.scan(
        outer, (state, key), None, length=n_steps // save_every)
    return state, traj, aux


# ---------------------------------------------------------------------------
# Stresslet measurement (rheology)
# ---------------------------------------------------------------------------


def fiber_stresslet(sus: FiberSuspension, pos, lam):
    """Per-fiber first moment S = sum_k (r_k - COM) lam_k^T, (F, 3, 3)
    (c_fibers_obj.cpp Outer_Product_Mat :1462-1556)."""
    com = jnp.mean(pos, axis=1, keepdims=True)
    return jnp.einsum("fkd,fke->fde", pos - com,
                      lam.reshape(sus.num_fibers, -1, 3))


def constraint_forces(sus: FiberSuspension, state: FiberState, f):
    """Rigid-link constraint forces lambda for applied blob forces f:
    lambda = M^-1 K N (K^T f) - f with N = (K^T M^-1 K)^+, evaluated
    with per-fiber dense algebra (c_fibers_obj.cpp Stresslet_RFD
    :1711-1726). Returns (F, B, 3)."""
    pos = blob_positions(sus, state)
    m_b = mobility_dense_batched(sus, pos)
    kd = k_dense(sus, state.u, state.v)
    ff = f.reshape(sus.num_fibers, -1)

    def one(m, k, fv):
        minv_k = jnp.linalg.solve(m, k)
        n_inv = k.T @ minv_k
        ktf = k.T @ fv
        y = jnp.linalg.lstsq(n_inv, ktf)[0]
        return minv_k @ y - fv

    lam = jax.vmap(one)(m_b, kd, ff)
    return lam.reshape(sus.num_fibers, -1, 3)


def stresslet_deterministic(sus: FiberSuspension, state: FiberState):
    """Stresslet of the bending-force-loaded suspension: S(lambda(F_bend))."""
    f = bending_force(sus, state.t)
    lam = constraint_forces(sus, state, f)
    return fiber_stresslet(sus, blob_positions(sus, state), lam)
