"""Static system description and dynamic state pytrees.

The reference represents a suspension as a Python list of `Body` objects
with per-body numpy arrays and ~25 injected function attributes
(/root/reference/body/body.py:13, multi_bodies/multi_bodies.py:1318-1394).
This framework splits that into:

  * `BodyType` / `System` — static, hashable geometry and physics
    parameters. Bodies are grouped by type (identical reference
    configuration), so all per-body work is batched with static shapes.
  * `State` — the dynamic pytree: body locations (B,3) and unit
    quaternions (B,4), in type-group order. This is the only thing that
    changes during a simulation, making `lax.scan` time loops natural.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np


def _freeze(arr):
    a = np.asarray(arr, dtype=np.float64)
    a.setflags(write=False)
    return a


@dataclasses.dataclass(frozen=True)
class BodyType:
    """A group of rigid bodies sharing one reference configuration.

    ref_config: (nb, 3) blob coordinates for orientation (1,0,0,0) at the
    origin (reference `.vertex` semantics, body/body.py:30-42).
    """

    name: str
    ref_config: np.ndarray  # (nb, 3)
    count: int
    blob_radii: Optional[np.ndarray] = None  # (nb,), defaults to system a
    slip_ref: Optional[np.ndarray] = None  # (nb, 3) active slip, body frame
    prescribed_kinematics: bool = False
    prescribed_velocity: Optional[np.ndarray] = None  # (count, 6)
    is_obstacle: bool = False

    def __post_init__(self):
        object.__setattr__(self, "ref_config", _freeze(np.reshape(self.ref_config, (-1, 3))))
        if self.blob_radii is not None:
            object.__setattr__(self, "blob_radii", _freeze(self.blob_radii))
        if self.slip_ref is not None:
            object.__setattr__(self, "slip_ref", _freeze(np.reshape(self.slip_ref, (-1, 3))))
        if self.prescribed_velocity is not None:
            object.__setattr__(
                self, "prescribed_velocity",
                _freeze(np.reshape(self.prescribed_velocity, (self.count, 6))))

    @property
    def num_blobs(self) -> int:
        return self.ref_config.shape[0]

    @property
    def body_length(self) -> float:
        """Max pairwise blob distance + 2a (body/body.py:218-231); the RFD
        length scale."""
        r = self.ref_config
        d = np.linalg.norm(r[:, None, :] - r[None, :, :], axis=-1)
        return float(d.max())


@dataclasses.dataclass(frozen=True)
class System:
    """Immutable problem description. Functions close over a System; JAX
    treats it as a compile-time constant."""

    types: Tuple[BodyType, ...]
    eta: float = 1.0
    blob_radius: float = 1.0
    kT: float = 0.0
    g: float = 0.0
    # 'no_wall' | 'single_wall' | 'in_plane' | 'periodic_spectral' |
    # 'single_wall_spectral'
    # (periodic_spectral: true triply-periodic RPY via the O(N log N)
    # spectral Ewald engine, ops/ewald.py; requires periodic_length > 0
    # on all three axes. single_wall_spectral: the O(N log N)
    # doubly-periodic-xy / open-z wall engine, ops/ewald_wall.py;
    # requires periodic_length > 0 on x and y plus
    # spectral_wall_height > 0. The pairwise domains treat
    # periodic_length as the reference's pseudo-periodic +-1 image-box
    # sweep.)
    domain: str = "single_wall"
    periodic_length: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # accuracy target for the periodic_spectral engine (sets the Ewald
    # split, window support, and grid via ops/ewald.default_params)
    spectral_tol: float = 1e-4
    # per-axis FFT grid cap for the spectral engine; when it binds,
    # r_cut inflates so dilute boxes don't demand enormous grids
    spectral_grid_max: int = 256
    # plane-matmul gridding knobs (see ops/ewald.EwaldParams): particles
    # per x-bucket (0 = auto 4x mean), yz-planes per lax.map step, and
    # the precision of the gridding matmuls ("highest" = full f32; the
    # GPU's default and "high" run them as TF32, which misses
    # spectral_tol — see PERF.md)
    spectral_bucket_capacity: int = 0
    spectral_plane_batch: int = 4
    spectral_precision: str = "highest"
    # near-field cell-list slots per cell (0 = auto: mean occupancy +
    # 4 sigma; overflow is counted in the plan's n_dropped_cells)
    spectral_cell_capacity: int = 0
    # single_wall_spectral slab top: the engine's z grid is static, so
    # the maximum blob height must be declared (grow via
    # saddle.auto_wall_height; blobs above it are clipped and counted)
    spectral_wall_height: float = 0.0
    repulsion_strength: float = 0.0
    debye_length: float = 1.0
    repulsion_strength_wall: float = 0.0
    debye_length_wall: float = 1.0
    # blob-blob pair-force backend: 'direct' O(N^2) sweep or
    # 'neighbor_list' linked cells (the reference's tree backend,
    # selected by blob_blob_force_implementation in the input file)
    blob_blob_force_method: str = "direct"
    # neighbor-list knobs: pair cutoff (0 = the reference's conservative
    # 2a + 30*debye), cells per dim cap, and blobs per cell
    blob_blob_cutoff: float = 0.0
    blob_blob_grid_dim: int = 16
    blob_blob_cell_capacity: int = 32
    # body-body Yukawa force (the reference's example user override,
    # multi_bodies_functions.py:359-408): 'none' (reference default,
    # body_body_force_torque_implementation None) or 'python'/'yukawa'
    body_body_force_method: str = "none"
    solver_tolerance: float = 1e-8
    rf_delta: float = 1e-3
    # user-extension hooks (reference L5 layer); all optional callables
    blob_force_fn: Optional[Callable] = None
    body_force_torque_fn: Optional[Callable] = None
    # extra slip source (e.g. phoretic slip): (system, state) -> (N,3),
    # added to the per-type prescribed active slip
    slip_fn: Optional[Callable] = None
    # articulated-body constraint groups (models/articulated.ArticulatedType)
    articulated: Tuple = ()
    nonlinear_solver_tolerance: float = 1e-8
    # multi-chip execution: shard the O(N^2) pairwise products over this
    # jax.sharding.Mesh (see parallel/mesh.py); None = single device
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)

    # ---- static layout helpers -------------------------------------------------

    @property
    def num_bodies(self) -> int:
        return sum(t.count for t in self.types)

    @property
    def num_blobs(self) -> int:
        return sum(t.count * t.num_blobs for t in self.types)

    @property
    def body_offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for t in self.types:
            offs.append(offs[-1] + t.count)
        return tuple(offs)

    @property
    def blob_offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for t in self.types:
            offs.append(offs[-1] + t.count * t.num_blobs)
        return tuple(offs)

    def body_slice(self, i: int) -> slice:
        offs = self.body_offsets
        return slice(offs[i], offs[i + 1])

    def blob_slice(self, i: int) -> slice:
        offs = self.blob_offsets
        return slice(offs[i], offs[i + 1])

    @property
    def prescribed_body_mask(self) -> np.ndarray:
        """(B,) bool: bodies with prescribed kinematics (obstacles)."""
        mask = np.zeros(self.num_bodies, dtype=bool)
        for i, t in enumerate(self.types):
            if t.prescribed_kinematics:
                mask[self.body_slice(i)] = True
        mask.setflags(write=False)
        return mask

    @property
    def prescribed_velocities(self) -> np.ndarray:
        """(B, 6) prescribed velocity (zero for free bodies)."""
        v = np.zeros((self.num_bodies, 6))
        for i, t in enumerate(self.types):
            if t.prescribed_velocity is not None:
                v[self.body_slice(i)] = t.prescribed_velocity
        v.setflags(write=False)
        return v

    @property
    def blob_radii(self) -> np.ndarray:
        """(N,) per-blob radii (defaults to blob_radius)."""
        out = np.empty(self.num_blobs)
        for i, t in enumerate(self.types):
            rad = (t.blob_radii if t.blob_radii is not None
                   else np.full(t.num_blobs, self.blob_radius))
            out[self.blob_slice(i)] = np.tile(rad, t.count)
        out.setflags(write=False)
        return out

    @property
    def has_mixed_radii(self) -> bool:
        """True when any type carries explicit per-blob radii different
        from the default blob_radius: the mobility engine must then take
        the per-radius kernels (reference radii_* backend family,
        mobility/mobility.py:1369). Static (host-side) — radii live in
        the scene files, never traced."""
        return any(
            t.blob_radii is not None
            and not np.allclose(np.asarray(t.blob_radii), self.blob_radius)
            for t in self.types)

    @property
    def mobility_kwargs(self):
        kw = dict(domain=self.domain, periodic_length=self.periodic_length)
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        return kw


class State(NamedTuple):
    """Dynamic state: all bodies concatenated in type-group order."""

    pos: jnp.ndarray  # (B, 3)
    quat: jnp.ndarray  # (B, 4), unit, scalar-first


def make_state(positions, quaternions, dtype=None) -> State:
    dtype = dtype or jnp.result_type(float)
    pos = jnp.asarray(positions, dtype=dtype).reshape(-1, 3)
    quat = jnp.asarray(quaternions, dtype=dtype).reshape(-1, 4)
    return State(pos=pos, quat=quat)
