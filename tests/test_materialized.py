"""Materialized-operator fast path vs the matrix-free engine."""

import jax.numpy as jnp
import numpy as np

from rigidmultiblobswall_tpu.models import kinematics as kin, saddle, solvers
from rigidmultiblobswall_tpu.ops import mobility as mob
from tests.test_saddle import _sphere_system


def test_dense_components_match_matvec():
    system, state = _sphere_system(count=3, seed=30)
    r = kin.blob_positions(system, state)
    comps = mob.dense_mobility_tiled(r, system.eta, system.blob_radius,
                                     domain=system.domain, row_tile=7)
    rng = np.random.default_rng(31)
    v = jnp.asarray(rng.normal(size=(system.num_blobs, 3)))
    u_dense = saddle._mobility_apply(system, r, comps, v)
    u_free = mob.mobility_trans_times_force(r, v, system.eta,
                                            system.blob_radius,
                                            **system.mobility_kwargs)
    assert np.allclose(np.asarray(u_dense), np.asarray(u_free), atol=1e-12)


def test_dense_components_periodic():
    system, state = _sphere_system(count=2, seed=32)
    import dataclasses

    system = dataclasses.replace(system, periodic_length=(8.0, 8.0, 0.0))
    r = kin.blob_positions(system, state)
    comps = mob.dense_mobility_tiled(r, system.eta, system.blob_radius,
                                     domain=system.domain,
                                     periodic_length=system.periodic_length)
    rng = np.random.default_rng(33)
    v = jnp.asarray(rng.normal(size=(system.num_blobs, 3)))
    u_dense = saddle._mobility_apply(system, r, comps, v)
    u_free = mob.mobility_trans_times_force(r, v, system.eta,
                                            system.blob_radius,
                                            **system.mobility_kwargs)
    assert np.allclose(np.asarray(u_dense), np.asarray(u_free), atol=1e-12)


def test_solve_same_result_with_and_without_materialization():
    system, state = _sphere_system(count=2, seed=34)
    sol_mat = solvers.solve_mobility_problem(system, state, m_dense="auto",
                                             tol=1e-10)
    sol_free = solvers.solve_mobility_problem(system, state, m_dense=None,
                                              tol=1e-10)
    assert np.allclose(np.asarray(sol_mat.velocities),
                       np.asarray(sol_free.velocities), atol=1e-8)
