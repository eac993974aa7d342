"""Matrix-free saddle-point operator and block-diagonal preconditioners.

Mobility problem for rigid multiblob suspensions (Delong et al. 2015):

    |  M   -K | |lambda|   | slip |
    | -K^T  0 | |  U   | = | -F   |

solved by right-preconditioned GMRES with a per-body exact preconditioner
(/root/reference/multi_bodies/multi_bodies.py:424-618). Prescribed-kinematics
bodies turn their velocity rows into the identity and move K U to the RHS.

Design: bodies are batched per type; the preconditioner factors all
bodies of a type with one vmapped Cholesky, and its application is three
batched matmuls, all at full f32 precision (see `_full_precision`). The Lanczos noise preconditioner P = U_chol^{-1}
with M ~= U_chol^T U_chol reuses the same factorization.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import mobility as mob
from . import kinematics as kin
from .system import State, System


def _full_precision(fn):
    """Trace fn with full-f32 matmul precision. The preconditioner MUST
    act as an exactly-linear map: under vmap (the lockstep multi-RHS
    solve) its per-type einsums batch into matrix-unit contractions
    whose default f32 precision (TF32 on the GPU) keeps about three
    digits, and that rounding breaks superposition — the Arnoldi relation
    then fails at that level and GMRES's Givens residual estimate floors
    near 2e-3 while the true residual stalls. The factorisation is built
    at the same precision, so the Cholesky factors and inverses carry
    full f32 digits too."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)
    return wrapped


SPECTRAL_DOMAINS = ("periodic_spectral", "single_wall_spectral")


def is_spectral(system: System) -> bool:
    """True for the O(N log N) engines that carry a positions plan
    (ops/ewald.SpectralPlan or ops/ewald_wall.WallPlan)."""
    return system.domain in SPECTRAL_DOMAINS


def num_constraints(system: System) -> int:
    from . import articulated as art_mod

    return art_mod.num_constraints(system)


def saddle_size(system: System) -> int:
    return (3 * system.num_blobs + 6 * system.num_bodies
            + 3 * num_constraints(system))


def split_saddle_vector(system: System, vec):
    n3 = 3 * system.num_blobs
    nb6 = 6 * system.num_bodies
    lam = vec[:n3].reshape(system.num_blobs, 3)
    U = vec[n3:n3 + nb6].reshape(system.num_bodies, 6)
    phi = vec[n3 + nb6:].reshape(-1, 3)
    return lam, U, phi


# budget for materializing (3N,3N): a Slip-Trapz step keeps up to two
# configurations' matrices live simultaneously, so the budget stays under
# half the device memory with room for the solver's work arrays; lower
# via RMW_MATERIALIZE_BUDGET for schemes holding more
MATERIALIZE_BUDGET_BYTES = int(
    __import__("os").environ.get("RMW_MATERIALIZE_BUDGET", 6 << 30))


def maybe_dense_mobility(system: System, r_blobs):
    """Materialize the per-configuration mobility engine: the (3N,3N)
    dense planes when they fit the budget (at fixed positions every
    GMRES/Lanczos iteration is then one dense matvec), an ops/ewald
    SpectralPlan for domain='periodic_spectral' (O(N log N) per product),
    or None -> the matrix-free pairwise engine."""
    if system.has_mixed_radii:
        if system.domain == "periodic_spectral":
            # exact polydisperse spectral engine: per-GROUP sinc shape
            # factors in k-space + per-group-pair near tables
            # (ops/ewald, mixed-radii mode; reference radii backends:
            # mobility/mobility.py:830-966 — pairwise only there)
            from ..ops import ewald

            _, groups = radii_groups(system)
            return ewald.make_plan(spectral_params(system), r_blobs,
                                   group_of=jnp.asarray(groups))
        if system.domain == "single_wall_spectral":
            raise NotImplementedError(
                "per-blob radii are not supported by the WALL spectral "
                "engine yet; use domain='periodic_spectral' (supported) "
                "or the pairwise domains (single_wall/no_wall/"
                "free_surface)")
        # per-radius products run matrix-free through the source-target
        # kernel (mobility_radii_trans_times_force); the materialized
        # planes and the fused pair kernel assume one blob radius
        return None
    if system.domain == "periodic_spectral":
        from ..ops import ewald

        return ewald.make_plan(spectral_params(system), r_blobs)
    if system.domain == "single_wall_spectral":
        from ..ops import ewald_wall

        return ewald_wall.make_wall_plan(spectral_params(system), r_blobs)
    n = r_blobs.shape[0]
    nbytes = 9 * n * n * jnp.dtype(r_blobs.dtype).itemsize
    # under a mesh the row-sharded pairwise engine divides the sweep; a
    # materialized operator would be built and held on every device
    if nbytes > MATERIALIZE_BUDGET_BYTES or system.mesh is not None:
        return None
    return mob.dense_mobility_tiled(
        r_blobs, system.eta, system.blob_radius, domain=system.domain,
        periodic_length=system.periodic_length)


def radii_groups(system: System):
    """Distinct blob radii (rounded to 10 digits) + per-blob group index
    for the mixed-radii spectral engine (host numpy)."""
    import numpy as np

    rad = np.asarray(system.blob_radii, np.float64)
    vals, groups = np.unique(np.round(rad, 10), return_inverse=True)
    if len(vals) > 8:
        raise NotImplementedError(
            f"{len(vals)} distinct blob radii: the spectral mixed-radii "
            "engine carries one wave channel block per distinct radius; "
            "use the pairwise domains for continuously-distributed radii")
    return tuple(float(v) for v in vals), groups.astype(np.int32)


def spectral_params(system: System):
    """The parameter set the spectral engines derive from the System
    (host-side; shared by plan construction and capacity sizing)."""
    if system.domain == "periodic_spectral":
        from ..ops import ewald

        if not all(L > 0 for L in system.periodic_length):
            raise ValueError("periodic_spectral needs periodic_length > 0 "
                             "on all three axes")
        radii_kw = {}
        a_eff = system.blob_radius
        if system.has_mixed_radii:
            vals, _ = radii_groups(system)
            radii_kw["radii"] = vals
            a_eff = max(vals)  # r_cut/grid sized by the largest radius
        return ewald.default_params(
            a_eff, system.eta, system.periodic_length,
            tol=system.spectral_tol, grid_max=system.spectral_grid_max,
            bucket_capacity=system.spectral_bucket_capacity,
            plane_batch=system.spectral_plane_batch,
            precision=system.spectral_precision,
            cell_capacity=system.spectral_cell_capacity, **radii_kw)
    if system.domain == "single_wall_spectral":
        from ..ops import ewald_wall

        if not all(L > 0 for L in system.periodic_length[:2]):
            raise ValueError(
                "single_wall_spectral needs periodic_length > 0 on x and "
                "y (the wall engine is doubly-periodic in-plane)")
        if system.spectral_wall_height <= 0:
            raise ValueError(
                "single_wall_spectral needs spectral_wall_height > 0 "
                "(slab top; use saddle.auto_wall_height(system, state))")
        return ewald_wall.default_wall_params(
            system.blob_radius, system.eta, system.periodic_length[:2],
            z_hi=system.spectral_wall_height, tol=system.spectral_tol,
            grid_max=system.spectral_grid_max,
            bucket_capacity=system.spectral_bucket_capacity,
            plane_batch=system.spectral_plane_batch,
            precision=system.spectral_precision,
            cell_capacity=system.spectral_cell_capacity)
    return None


def _grid_bucket_max(pos, gx, gz, hx, hz, ZB, P):
    """Max (plane, z-block) segment population of the z-slab gridding
    layout (numpy mirror of ops/ewald.make_grid_layout's binning)."""
    import numpy as np

    base_x = np.mod(np.round(pos[:, 0] / hx).astype(np.int64), gx)
    base_z = np.mod(np.round(pos[:, 2] / hz).astype(np.int64), gz)
    tblk = base_z // ZB
    nzb = gz // ZB
    offs = np.arange(P) - P // 2
    planes = np.mod(base_x[:, None] + offs[None, :], gx)
    bucket = (planes * nzb + tblk[:, None]).reshape(-1)
    return int(np.bincount(bucket, minlength=gx * nzb).max())


def _cell_max(pos, csize, dims):
    """Max cell occupancy (numpy mirror of ops/cells.cell_bin); csize is
    the per-axis cell size."""
    import numpy as np

    c3 = np.clip((pos / np.asarray(csize)).astype(np.int64), 0,
                 np.asarray(dims) - 1)
    cid = (c3[:, 0] * dims[1] + c3[:, 1]) * dims[2] + c3[:, 2]
    return int(np.bincount(cid, minlength=dims[0] * dims[1] * dims[2]).max())


def exact_spectral_capacities(system: System, state, *, margin=1.25,
                              log=None):
    """Size the spectral engine's fixed capacities from the ACTUAL
    occupancy at this configuration (host numpy, no device probe): the
    mean-based auto heuristics assume uniform density, which clumped
    multiblob/slab configurations exceed by integer factors — each probe
    round of capacity growth costs a full plan recompile. `margin`
    covers position drift between full plan rebuilds. No-op for other
    domains or when the user pinned explicit capacities."""
    if not is_spectral(system):
        return system
    import dataclasses
    import math as _math

    import numpy as np

    from ..ops import ewald_wall

    p = spectral_params(system)
    r = np.asarray(kin.blob_positions(system, state), np.float64)
    updates = {}
    if system.domain == "single_wall_spectral":
        # mirror ops/ewald_wall.make_wall_plan's binning of the combined
        # real+image set
        Lx, Ly = p.box_xy
        xy = r[:, :2] - np.floor(r[:, :2] / [Lx, Ly]) * [Lx, Ly]
        z = np.clip(r[:, 2], p.a, p.z_hi)
        pos_real = np.concatenate([xy, (z - p.z0)[:, None]], axis=1)
        pos_img = np.concatenate([xy, (-z - p.z0)[:, None]], axis=1)
        pos_all = np.concatenate([pos_real, pos_img], axis=0)
        csize_z = ewald_wall.Z_CELL_SLACK * p.r_cut
        nz_data = max(int(_math.ceil(p.data_extent / csize_z)), 2)
        dims = (max(int(Lx // p.r_cut), 1), max(int(Ly // p.r_cut), 1),
                nz_data + 1)
        box_bin = (Lx / dims[0], Ly / dims[1], csize_z)
        occ = _cell_max(pos_all, box_bin, dims)
        gp = p.grid_params()
        hx, hy, hz = p.spacing
        ZB = gp.zslab
        seg = max(_grid_bucket_max(s, p.grid[0], p.grid[2], hx, hz, ZB,
                                   p.support)
                  for s in (pos_all, pos_img, pos_real))
    else:
        box = np.asarray(p.box)
        pos = r - np.floor(r / box) * box
        dims = tuple(max(int(L // p.r_cut), 1) for L in p.box)
        occ = _cell_max(pos, box / np.asarray(dims), dims)
        gp = p
        hx = p.box[0] / p.grid[0]
        hz = p.box[2] / p.grid[2]
        seg = _grid_bucket_max(pos, p.grid[0], p.grid[2], hx, hz,
                               gp.zslab, p.support)
    cell_cap = -(-int(occ * margin) // 8) * 8
    cap_seg = -(-int(seg * margin) // 8) * 8
    if system.spectral_cell_capacity <= 0 or \
            system.spectral_cell_capacity < cell_cap:
        updates["spectral_cell_capacity"] = max(
            cell_cap, system.spectral_cell_capacity)
    if system.spectral_bucket_capacity <= 0 or \
            system.spectral_bucket_capacity < cap_seg:
        updates["spectral_bucket_capacity"] = max(
            cap_seg, system.spectral_bucket_capacity)
    if log is not None:
        log(f"exact capacities: cell max_occ={occ} -> cap={cell_cap}, "
            f"segment max={seg} -> cap_seg={cap_seg}")
    if not updates:
        return system
    return dataclasses.replace(system, **updates)


def auto_wall_height(system: System, state, *, margin=1.3, log=None):
    """Set spectral_wall_height for a single_wall_spectral system from
    the CURRENT maximum blob height times a drift margin. Host-side
    (concrete state), like auto_spectral_capacities. No-op for other
    domains or when the height is already set high enough."""
    if system.domain != "single_wall_spectral":
        return system
    import dataclasses

    import numpy as np

    z_max = float(np.asarray(
        kin.blob_positions(system, state)[:, 2]).max())
    z_hi = margin * max(z_max, 2.0 * system.blob_radius)
    if system.spectral_wall_height >= z_hi:
        return system
    if log is not None:
        log(f"wall slab: z_max {z_max:.3g} -> spectral_wall_height "
            f"{z_hi:.3g}")
    return dataclasses.replace(system, spectral_wall_height=z_hi)


def auto_spectral_capacities(system: System, state, *, max_rounds=5,
                             log=None):
    """Grow the spectral engine's fixed capacities until a plan at this
    configuration reports ZERO dropped entries. Bucket-dropped particles
    silently lose their far-field contribution and over-capacity cells
    drop near-field sources — the auto heuristics size for uniform
    density, which clumped configurations (whole multiblob bodies per
    cell) can exceed. No-op for other domains."""
    if not is_spectral(system):
        return system
    import dataclasses

    if system.domain == "single_wall_spectral":
        system = auto_wall_height(system, state, log=log)
    # exact host-side sizing first: the probe loop below then almost
    # always verifies zero drops on its first round instead of paying a
    # full plan recompile per 1.5x growth round
    system = exact_spectral_capacities(system, state, log=log)
    r_blobs = kin.blob_positions(system, state)
    for _ in range(max_rounds):
        # jit the probe build: eagerly it dispatches hundreds of small
        # ops one by one
        plan = jax.jit(
            lambda r: maybe_dense_mobility(system, r))(r_blobs)
        if system.domain == "single_wall_spectral":
            drops = (int(plan.n_dropped_grid), int(plan.n_dropped_cells))
        else:
            drops = (int(plan.n_dropped), int(plan.n_dropped_cells))
        cap_seg = (plan.tbl_all.shape[0]
                   // (plan.params.grid[0]
                       * (plan.params.grid[2]
                          // plan.params.grid_params().zslab))
                   if system.domain == "single_wall_spectral"
                   else plan.cap_seg)
        if log is not None:
            log(f"spectral plan: grid={plan.params.grid} "
                f"r_cut={plan.params.r_cut:.2f} cap_seg={cap_seg} "
                f"cell_cap={plan.params.cell_capacity} dropped={drops}")
        if drops == (0, 0):
            return system
        updates = {}
        if drops[0]:
            updates["spectral_bucket_capacity"] = cap_seg * 3 // 2
        if drops[1]:
            # periodic engine: +8 (overflow is a few clumped cells'
            # tail). Wall engine: grow multiplicatively
            # (slab layouts can misestimate the occupied-cell mean)
            cap_now = plan.params.cell_capacity
            if system.domain == "single_wall_spectral":
                updates["spectral_cell_capacity"] = (
                    -(-max(cap_now + 8, cap_now * 5 // 4) // 8) * 8)
            else:
                updates["spectral_cell_capacity"] = cap_now + 8
        system = dataclasses.replace(system, **updates)
    raise ValueError(
        f"spectral capacities still dropping after {max_rounds} rounds "
        f"of growth: {drops}")


def refresh_dense_mobility(system: System, m_dense, r_new, *, build=True):
    """Mobility engine for a configuration NEAR the one `m_dense` was
    built at (same topology, O(dt) drift): spectral plans refresh via
    ops/ewald.update_plan — position re-gathers only, with an automatic
    full-rebuild fallback past the drift budget — instead of paying the
    plan sorts again. Every other engine rebuilds at r_new (build=True)
    or defers to the matrix-free path (build=False, for single products
    where materialization would not amortize)."""
    if system.domain == "periodic_spectral":
        from ..ops import ewald

        if isinstance(m_dense, ewald.SpectralPlan):
            return ewald.update_plan(m_dense, r_new)
        return maybe_dense_mobility(system, r_new)
    if system.domain == "single_wall_spectral":
        from ..ops import ewald_wall

        if isinstance(m_dense, ewald_wall.WallPlan):
            return ewald_wall.update_wall_plan(m_dense, r_new)
        return maybe_dense_mobility(system, r_new)
    return maybe_dense_mobility(system, r_new) if build else None


def _mobility_apply(system, r_blobs, m_dense, lam):
    if system.domain == "periodic_spectral":
        from ..ops import ewald

        if not isinstance(m_dense, ewald.SpectralPlan):
            m_dense = maybe_dense_mobility(system, r_blobs)
        return ewald.matvec(m_dense, lam.reshape(-1, 3), mesh=system.mesh)
    if system.domain == "single_wall_spectral":
        from ..ops import ewald_wall

        if not isinstance(m_dense, ewald_wall.WallPlan):
            m_dense = maybe_dense_mobility(system, r_blobs)
        return ewald_wall.matvec(m_dense, lam.reshape(-1, 3),
                                 mesh=system.mesh)
    if m_dense is not None:
        # m_dense: (3,3,N,N) component planes (see dense_mobility_tiled)
        lam = lam.reshape(-1, 3)
        return jnp.einsum("abij,jb->ia", m_dense, lam,
                          precision=jax.lax.Precision.HIGHEST)
    if system.has_mixed_radii:
        return mob.mobility_radii_trans_times_force(
            r_blobs, lam.reshape(-1, 3),
            jnp.asarray(system.blob_radii, r_blobs.dtype), system.eta,
            domain=system.domain,
            periodic_length=system.periodic_length)
    return mob.mobility_trans_times_force(
        r_blobs, lam, system.eta, system.blob_radius,
        **system.mobility_kwargs)


def _mobility_apply_multi(system, r_blobs, m_dense, lam):
    """Stacked mobility products, lam (b, N, 3) -> (b, N, 3), sharing one
    engine sweep across the stack where the engine supports it (spectral
    plan, materialized planes); otherwise per-RHS."""
    if system.domain == "periodic_spectral":
        from ..ops import ewald

        if not isinstance(m_dense, ewald.SpectralPlan):
            m_dense = maybe_dense_mobility(system, r_blobs)
        return ewald.matvec_multi(m_dense, lam, mesh=system.mesh)
    if system.domain == "single_wall_spectral":
        from ..ops import ewald_wall

        if not isinstance(m_dense, ewald_wall.WallPlan):
            m_dense = maybe_dense_mobility(system, r_blobs)
        return ewald_wall.matvec_multi(m_dense, lam, mesh=system.mesh)
    if m_dense is not None and not isinstance(m_dense, (str,)):
        # one streaming pass over the planes serves the whole stack
        return jnp.einsum("abij,qjb->qia", m_dense, lam,
                          precision=jax.lax.Precision.HIGHEST)
    if system.has_mixed_radii:
        radii = jnp.asarray(system.blob_radii, r_blobs.dtype)
        return jax.vmap(lambda f: mob.mobility_radii_trans_times_force(
            r_blobs, f, radii, system.eta, domain=system.domain,
            periodic_length=system.periodic_length))(lam)
    return mob.pairwise_matvec_multi(
        r_blobs, r_blobs, lam, system.eta, system.blob_radius,
        coupling="tt", self_interaction=True, **system.mobility_kwargs)


def make_linear_operator(system: System, state: State, r_blobs=None,
                         time=0.0, m_dense=None):
    """Return vec -> saddle operator action (flat in, flat out):
    [M lam - K U; -K^T lam + C^T phi; C U] with prescribed-kinematics
    rewrites (multi_bodies.py:424-471)."""
    if r_blobs is None:
        r_blobs = kin.blob_positions(system, state)
    if m_dense is None and is_spectral(system):
        # build the spectral plan ONCE here: XLA does not hoist
        # loop-invariant work out of while_loop bodies, so leaving it to
        # _mobility_apply would rebuild the plan every Krylov iteration
        m_dense = maybe_dense_mobility(system, r_blobs)
    prescribed = jnp.asarray(system.prescribed_body_mask)
    any_prescribed = bool(system.prescribed_body_mask.any())
    has_constraints = num_constraints(system) > 0
    kwargs = system.mobility_kwargs

    def finish(vec, m_lam):
        lam, U, phi = split_saddle_vector(system, vec)
        KU = kin.K_mul(system, state, U)
        res_blobs = m_lam - KU
        res_bodies = -kin.KT_mul(system, state, lam)
        parts = [res_blobs, res_bodies]
        if has_constraints:
            from . import articulated as art_mod

            res_bodies = res_bodies + art_mod.CT_mul(system, state, phi, time)
            parts = [res_blobs, res_bodies,
                     art_mod.C_mul(system, state, U, time)]
        if any_prescribed:
            # identity row on U, and K U moved back out of the blob rows
            blob_mask = blob_prescribed_mask(system)[:, None]
            parts[0] = parts[0] + blob_mask * KU
            parts[1] = parts[1] + prescribed[:, None] * U
        return jnp.concatenate([p.ravel() for p in parts])

    def operator(vec):
        lam = split_saddle_vector(system, vec)[0]
        return finish(vec, _mobility_apply(system, r_blobs, m_dense, lam))

    operator._finish = finish
    return operator


def make_lockstep_operator(system: System, state: State, r_blobs=None,
                           time=0.0, m_dense=None):
    """Saddle operator over a (nrhs, n) RHS stack: ONE shared mobility
    sweep (ops/ewald.matvec_multi / batched plane product) feeds the
    per-RHS K/C algebra. Pairs with ops/gmres.gmres_lockstep."""
    if r_blobs is None:
        r_blobs = kin.blob_positions(system, state)
    if m_dense is None and is_spectral(system):
        m_dense = maybe_dense_mobility(system, r_blobs)
    single = make_linear_operator(system, state, r_blobs, time=time,
                                  m_dense=m_dense)
    n3 = 3 * system.num_blobs

    def operator(Y):
        lam = Y[:, :n3].reshape(Y.shape[0], system.num_blobs, 3)
        m_lam = _mobility_apply_multi(system, r_blobs, m_dense, lam)
        return jax.vmap(single._finish)(Y, m_lam)

    return operator


def blob_prescribed_mask(system: System):
    """(N,) 1.0 where the parent body has prescribed kinematics."""
    import numpy as np

    mask = np.zeros(system.num_blobs)
    for i, t in enumerate(system.types):
        if t.prescribed_kinematics:
            mask[system.blob_slice(i)] = 1.0
    return jnp.asarray(mask)


class TypePC(NamedTuple):
    """Per-type batched preconditioner factors."""

    chol: jax.Array      # (c, 3nb, 3nb) upper Cholesky, M = U^T U
    chol_inv: jax.Array  # (c, 3nb, 3nb) U^{-1}
    m_inv: jax.Array     # (c, 3nb, 3nb)
    K: jax.Array         # (c, 3nb, 6)
    N_body: jax.Array    # (c, 6, 6) = pinv(K^T M^{-1} K)


class ArticulatedPC(NamedTuple):
    """Per articulated-type batched constraint factors."""

    C: jax.Array       # (count, 3nc, 6nb)
    G: jax.Array       # (count, 3nc, 3nc) = pinv(C N C^T)


class BlockDiagPC(NamedTuple):
    per_type: tuple
    per_articulated: tuple = ()


def _build_articulated_pc(system: System, state: State, per_type, time=0.0):
    """Constraint resistance G = pinv(C N_diag C^T) per articulated
    instance, batched per type (multi_bodies.py:787-806)."""
    from . import articulated as art_mod

    out = []
    for art in system.articulated:
        C = art_mod.dense_C_per_instance(system, art, state, time)
        # block-diagonal body mobility N of the instance's sub-bodies
        nb = art.num_bodies
        N_blocks = jnp.stack(
            [per_type[tj].N_body for tj in art.sub_type_indices], axis=1
        )  # (count, nb, 6, 6)
        CN = jnp.zeros_like(C)
        for j in range(nb):
            cols = slice(6 * j, 6 * j + 6)
            CN = CN.at[:, :, cols].set(
                jnp.einsum("cik,ckl->cil", C[:, :, cols], N_blocks[:, j]))
        CNCT = jnp.einsum("cik,cjk->cij", CN, C)
        # MUST be pinv (multi_bodies.py:806): redundant link sets (e.g. a
        # weld expressed as >=2 ball joints, Structures/bacteria_active.
        # const) make C N C^T exactly singular — inv would fill the PC
        # with NaN and poison the whole Krylov solve.
        G = jnp.linalg.pinv(CNCT)
        out.append(ArticulatedPC(C=C, G=G))
    return tuple(out)


@_full_precision
def build_block_diag_pc(system: System, state: State, time=0.0) -> BlockDiagPC:
    """Factor every body's blob mobility; batched per type
    (multi_bodies.py:480-618). Uses the dense single-body mobility in the
    system's domain without periodic images, like the reference."""
    per_type = []
    # the in_plane mobility is singular in z; like the reference (which has
    # no dense in_plane builder) the PC factors the single-wall mobility.
    # periodic_spectral bodies precondition with the open-boundary RPY
    # blocks (the PC is near-field-dominated; images only perturb it)
    pc_domain = {"in_plane": "single_wall",
                 "periodic_spectral": "no_wall",
                 "single_wall_spectral": "single_wall"}.get(system.domain,
                                                            system.domain)
    for i, t in enumerate(system.types):
        rel = kin.blob_rel_positions(system, state, i)  # (c,nb,3)
        pos, _ = kin.type_arrays(system, state, i)
        r_body = rel + pos[:, None, :]

        if (t.blob_radii is not None
                and not np.allclose(np.asarray(t.blob_radii),
                                    system.blob_radius)):
            radii_t = np.asarray(t.blob_radii)

            def dense_one(r):
                return mob.dense_mobility_radii(
                    r, jnp.asarray(radii_t, r.dtype), system.eta,
                    domain=pc_domain)
        else:
            def dense_one(r):
                return mob.dense_mobility(r, system.eta,
                                          system.blob_radius,
                                          domain=pc_domain, coupling="tt")

        M = jax.vmap(dense_one)(r_body)  # (c, 3nb, 3nb)
        chol = jax.vmap(lambda m: jnp.linalg.cholesky(m, upper=True))(M)
        eye = jnp.broadcast_to(jnp.eye(3 * t.num_blobs, dtype=M.dtype), M.shape)
        chol_inv = jax.vmap(
            lambda u, b: jax.scipy.linalg.solve_triangular(u, b, lower=False)
        )(chol, eye)
        m_inv = jnp.einsum("cij,ckj->cik", chol_inv, chol_inv)
        K = kin.K_dense(system, state, i)  # (c, 3nb, 6)
        KtMinvK = jnp.einsum("cni,cnm,cmj->cij", K, m_inv, K)
        # SPD and full-rank for >=3 NON-COLLINEAR blobs: LU inverse is
        # much faster than the batched-SVD pinv. Collinear bodies (straight rods like the reference's
        # Cylinder_N_14) cannot resolve spin about their own axis, so
        # K^T M^{-1} K is rank-5 and MUST take the reference's pinv
        # (body.py:194). ref_config is static, so the rank test is free.
        cfg = np.asarray(t.ref_config, np.float64)
        cfg = cfg - cfg.mean(axis=0)
        sv = np.linalg.svd(cfg, compute_uv=False) if len(cfg) > 1 else [0.0]
        collinear = len(sv) < 2 or sv[1] <= 1e-9 * max(sv[0], 1e-30)
        if t.num_blobs >= 3 and not collinear:
            N_body = jnp.linalg.inv(KtMinvK)
        else:
            N_body = jnp.linalg.pinv(KtMinvK)
        per_type.append(TypePC(chol=chol, chol_inv=chol_inv, m_inv=m_inv,
                               K=K, N_body=N_body))
    per_art = ()
    if num_constraints(system) > 0:
        per_art = _build_articulated_pc(system, state, per_type, time=time)
    return BlockDiagPC(per_type=tuple(per_type), per_articulated=per_art)


@_full_precision
def apply_block_diag_pc(system: System, pc: BlockDiagPC, vec):
    """Apply the saddle preconditioner: per body solve the isolated
    mobility problem exactly (multi_bodies.py:552-582), then correct the
    articulated instances with the constraint resistance G
    (multi_bodies.py:863-894)."""
    lam, F, B = split_saddle_vector(system, vec)
    lam_out = []
    body_out = []
    for i, t in enumerate(system.types):
        p = pc.per_type[i]
        c, nb = t.count, t.num_blobs
        slip = lam[system.blob_slice(i)].reshape(c, 3 * nb)
        Fb = F[system.body_slice(i)].reshape(c, 6)
        if t.prescribed_kinematics:
            lam_t = jnp.einsum("cij,cj->ci", p.m_inv, slip)
            Y = jnp.einsum("cni,cn->ci", p.K, lam_t)  # F = K^T lambda
            lam_out.append(lam_t.reshape(c * nb, 3))
            body_out.append(Y)
        else:
            lam_tilde = jnp.einsum("cij,cj->ci", p.m_inv, slip)
            rhs = -Fb - jnp.einsum("cni,cn->ci", p.K, lam_tilde)
            Y = jnp.einsum("cij,cj->ci", p.N_body, rhs)
            KY = jnp.einsum("cni,ci->cn", p.K, Y)
            lam_t = jnp.einsum("cij,cj->ci", p.m_inv, slip + KY)
            lam_out.append(lam_t.reshape(c * nb, 3))
            body_out.append(Y)
    lam_full = jnp.concatenate(lam_out, axis=0).reshape(system.num_blobs, 3)
    body_full = jnp.concatenate(body_out, axis=0)

    if not pc.per_articulated:
        return jnp.concatenate([lam_full.ravel(), body_full.ravel()])

    from . import articulated as art_mod

    phi_out = []
    offs = art_mod.constraint_offsets(system)
    for ia, art in enumerate(system.articulated):
        apc = pc.per_articulated[ia]
        nb_a, nc_a = art.num_bodies, art.num_constraints
        # gather unconstrained instance velocities (count, 6 nb)
        U_unc = art_mod._instance_bodies(system, art, body_full).reshape(
            art.count, 6 * nb_a)
        CU = jnp.einsum("cij,cj->ci", apc.C, U_unc)
        B_a = B[offs[ia]:offs[ia + 1]].reshape(art.count, 3 * nc_a)
        Phi = jnp.einsum("cij,cj->ci", apc.G, B_a - CU)
        Fc = jnp.einsum("cji,cj->ci", apc.C, Phi).reshape(art.count, nb_a, 6)
        # per sub-body: N Fc, and the lambda correction M^{-1} K N Fc
        for j, tj in enumerate(art.sub_type_indices):
            p = pc.per_type[tj]
            NFc = jnp.einsum("cij,cj->ci", p.N_body, Fc[:, j])
            body_full = body_full.at[system.body_slice(tj)].add(NFc)
            KNFc = jnp.einsum("cni,ci->cn", p.K, NFc)
            lam_corr = jnp.einsum("cij,cj->ci", p.m_inv, KNFc)
            nb_blobs = system.types[tj].num_blobs
            lam_full = lam_full.at[system.blob_slice(tj)].add(
                lam_corr.reshape(-1, 3))
        phi_out.append(Phi.reshape(-1, 3))
    phi_full = jnp.concatenate(phi_out, axis=0)
    return jnp.concatenate([lam_full.ravel(), body_full.ravel(),
                            phi_full.ravel()])


@_full_precision
def apply_identity_saddle_solver(system: System, state: State, vec):
    """Exact solve of the M=I saddle system [I -K; -K^T 0] per body: the
    'identity' unconstrained mobility solver used by the GDC scheme
    (multi_bodies.py:626-743). vec = [slip, F] flat; returns [lam, U]."""
    lam, F, _ = split_saddle_vector(system, vec)
    lam_out = []
    body_out = []
    for i, t in enumerate(system.types):
        c, nb = t.count, t.num_blobs
        slip = lam[system.blob_slice(i)].reshape(c, 3 * nb)
        Fb = F[system.body_slice(i)].reshape(c, 6)
        K = kin.K_dense(system, state, i)
        N = jnp.linalg.pinv(jnp.einsum("cni,cnj->cij", K, K))
        rhs = -Fb - jnp.einsum("cni,cn->ci", K, slip)
        Y = jnp.einsum("cij,cj->ci", N, rhs)
        lam_t = slip + jnp.einsum("cni,ci->cn", K, Y)
        lam_out.append(lam_t.reshape(c * nb, 3))
        body_out.append(Y)
    return jnp.concatenate([jnp.concatenate(lam_out).ravel(),
                            jnp.concatenate(body_out).ravel()])


def make_noise_pc(system: System, state: State, pc: BlockDiagPC,
                  r_blobs=None, m_dense=None):
    """Operators for the preconditioned Lanczos noise
    (multi_bodies.py:591-615):
      mobility_pc(w) = P^T M P w   with per-body P = U_chol^{-1}
      L_mult(w)      = U_chol^T w
    so that L sqrt(P^T M P) z has covariance M."""
    if r_blobs is None:
        r_blobs = kin.blob_positions(system, state)
    if m_dense is None and is_spectral(system):
        # hoist the spectral plan out of the Lanczos while_loop (see
        # make_linear_operator)
        m_dense = maybe_dense_mobility(system, r_blobs)
    kwargs = system.mobility_kwargs

    @_full_precision
    def _apply_per_body(vec, which):
        out = []
        for i, t in enumerate(system.types):
            p = pc.per_type[i]
            c, nb = t.count, t.num_blobs
            w = vec.reshape(system.num_blobs, 3)[system.blob_slice(i)]
            w = w.reshape(c, 3 * nb)
            if which == "P":
                r = jnp.einsum("cij,cj->ci", p.chol_inv, w)
            elif which == "PT":
                r = jnp.einsum("cji,cj->ci", p.chol_inv, w)
            elif which == "L":
                r = jnp.einsum("cji,cj->ci", p.chol, w)  # U^T w
            out.append(r.reshape(c * nb, 3))
        return jnp.concatenate(out, axis=0).ravel()

    def mobility_pc(w):
        y = _apply_per_body(w, "P").reshape(system.num_blobs, 3)
        my = _mobility_apply(system, r_blobs, m_dense, y)
        return _apply_per_body(my.ravel(), "PT")

    def L_mult(w):
        return _apply_per_body(w, "L")

    return mobility_pc, L_mult
