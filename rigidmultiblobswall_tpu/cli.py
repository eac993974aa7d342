"""Command-line driver: `python -m rigidmultiblobswall_tpu.cli --input-file X.dat`.

Covers both reference drivers with the same input files and output formats:
  - static schemes 'mobility' | 'resistance' | 'body_mobility'
    (/root/reference/multi_bodies/multi_bodies_utilities.py:262-626)
  - dynamic schemes (deterministic/stochastic integrators)
    (/root/reference/multi_bodies/multi_bodies.py:1112-1631)

Outputs: <output>.inputfile, .bodies_info, .velocity.dat, .force.dat,
.body_mobility.dat, .body_slip_mobility.dat, per-step .clones files,
.info (iteration counters), .time (wall clock).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Rigid multiblob dynamics in JAX")
    parser.add_argument("--input-file", dest="input_file", type=str,
                        default="data.main")
    parser.add_argument("--print-residual", action="store_true")
    parser.add_argument("--f64", action="store_true",
                        help="run in float64")
    args = parser.parse_args(argv)

    if args.f64:
        import jax

        jax.config.update("jax_enable_x64", True)

    import jax
    import jax.numpy as jnp

    from .io import input_file as input_mod, scene
    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from .models import integrators, kinematics as kin, solvers

    cfg = input_mod.read_input(args.input_file)
    shutil.copyfile(args.input_file, cfg.output_name + ".inputfile")
    # stamp the framework's git commit for provenance
    # (reference multi_bodies.py:1145-1151)
    try:
        import subprocess

        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True,
            cwd=os.path.dirname(os.path.abspath(__file__))).stdout.decode()
        with open(cfg.output_name + ".git", "w") as f:
            f.write(commit)
    except Exception:
        pass
    # scene-file paths resolve relative to the input file's directory
    system, state = input_mod.build_system(
        cfg, base_dir=os.path.dirname(os.path.abspath(args.input_file)))

    # user-extension override module (the reference's L5 mechanism: a
    # user_defined_functions.py in the run directory overrides the force/
    # slip hooks, multi_bodies_functions.py:466-472). Here it may define
    # jax-traceable hooks blob_force_fn(system, state, r_blobs)->(N,3),
    # body_force_torque_fn(system, state, r_blobs)->(B,6),
    # slip_fn(system, state)->(N,3), and preprocess/postprocess(system,
    # state, step)->state callbacks around the time loop.
    user_mod = None
    for udf_dir in (os.getcwd(),
                    os.path.dirname(os.path.abspath(args.input_file))):
        udf = os.path.join(udf_dir, "user_defined_functions.py")
        if os.path.isfile(udf):
            import importlib.util

            spec = importlib.util.spec_from_file_location(
                "user_defined_functions", udf)
            user_mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = user_mod
            try:
                spec.loader.exec_module(user_mod)
            except ImportError as e:
                # a module written against the REFERENCE hook API (it
                # imports multi_bodies_functions / numexpr / pycuda ...)
                # cannot drive this framework's hooks — fail with the
                # porting pointer instead of a bare traceback
                hint = ""
                if e.name in ("multi_bodies_functions", "numexpr",
                              "pycuda", "body", "mobility"):
                    hint = (
                        "\nThis file appears to target the reference's "
                        "user_defined_functions API; this framework's "
                        "hooks are plain functions named blob_force_fn /"
                        " body_force_torque_fn / slip_fn / preprocess / "
                        "postprocess — see the user-extension table in "
                        "doc/USAGE.md for the signatures.")
                raise SystemExit(
                    f"error: could not load {udf}: {e}{hint}")
            import dataclasses as _dc

            hooks = {name: getattr(user_mod, name)
                     for name in ("blob_force_fn", "body_force_torque_fn",
                                  "slip_fn")
                     if hasattr(user_mod, name)}
            if "body_force_torque_fn" in hooks:
                # the reference's override REPLACES calc_body_body_forces_
                # torques_python (multi_bodies_functions.py:474, examples/
                # bacteria/user_defined_functions.py) — so the built-in
                # Yukawa body-body force must not also apply
                hooks["body_body_force_method"] = "none"
            if hooks:
                system = _dc.replace(system, **hooks)
            print("Loaded user_defined_functions from", udf)
            break

    with open(cfg.output_name + ".bodies_info", "w") as f:
        f.write("num_of_body_types  %d\n" % len(system.types))
        f.write("body_names         %s\n" % [t.name for t in system.types])
        f.write("body_types         %s\n" % [t.count for t in system.types])
        f.write("num_bodies         %d\n" % system.num_bodies)
        f.write("num_blobs          %d\n" % system.num_blobs)

    start_time = time.time()

    if cfg.scheme == "mobility":
        force_torque = None
        if cfg.force_file is not None:
            force_torque = jnp.asarray(
                np.loadtxt(cfg.force_file).reshape(system.num_bodies, 6))
        sol = solvers.solve_mobility_problem(system, state,
                                             force_torque=force_torque)
        np.savetxt(cfg.output_name + ".velocity.dat",
                   np.asarray(sol.velocities).reshape(-1, 6), delimiter="  ")
        force = np.asarray(kin.KT_mul(system, state, sol.lam))
        np.savetxt(cfg.output_name + ".force.dat", force, delimiter="  ")
        print("Time to solve mobility problem =", time.time() - start_time)
        if cfg.plot_velocity_field is not None:
            from .models import fields

            fields.plot_velocity_field_to_vtk(
                cfg.plot_velocity_field, system, state, sol.lam,
                cfg.output_name, tracer_radius=cfg.tracer_radius)
        if (cfg.plot_concentration_field is not None
                and cfg.phoretic_cfg is not None):
            from .models import fields

            fields.plot_concentration_field_to_vtk(
                cfg.plot_concentration_field, system, state,
                cfg.phoretic_cfg, cfg.output_name)

    elif cfg.scheme == "resistance":
        velocity = np.zeros((system.num_bodies, 6))
        if cfg.velocity_file is not None:
            velocity = np.loadtxt(cfg.velocity_file).reshape(
                system.num_bodies, 6)
        force = solvers.solve_resistance(system, state, jnp.asarray(velocity))
        np.savetxt(cfg.output_name + ".force.dat", np.asarray(force),
                   delimiter="  ")
        print("Time to solve resistance problem =", time.time() - start_time)

    elif cfg.scheme == "body_mobility":
        N = np.asarray(solvers.solve_body_mobility(system, state))
        np.savetxt(cfg.output_name + ".body_mobility.dat", N, delimiter="  ")
        # slip mobility: N K^T M^{-1}
        M = np.asarray(solvers.dense_blob_mobility(system, state))
        K = np.asarray(solvers._dense_K(system, state))
        slip_mob = N @ K.T @ np.linalg.inv(M)
        np.savetxt(cfg.output_name + ".body_slip_mobility.dat", slip_mob,
                   delimiter="  ")
        # double-layer slip correction when a .Laplace file supplies
        # surface normals/weights (multi_bodies_utilities.py:607-613)
        if cfg.phoretic_cfg is not None:
            from .models import phoretic
            from .ops import stokes_layers

            pcfg = cfg.phoretic_cfg
            r_blobs = kin.blob_positions(system, state)
            normals = phoretic.lab_normals(system, state, pcfg.chemistry)
            weights = phoretic._gather(system, pcfg.chemistry, "weights",
                                       r_blobs.dtype)
            D = np.asarray(stokes_layers.double_layer_dense(
                r_blobs, r_blobs, normals, weights))
            I2pD = 0.5 * np.eye(D.shape[0]) + D
            np.savetxt(cfg.output_name + ".body_slip_mobility_double_layer.dat",
                       slip_mob @ I2pD, delimiter="  ")
        print("Time to compute body mobility =", time.time() - start_time)

    elif cfg.scheme in ("body_mcmc", "MCMC"):
        # Markov-chain Monte Carlo equilibrium sampling (the reference's
        # many_bodyMCMC/many_body_MCMC.py driver; negative initial_step
        # runs adaptive burn-in)
        from .models import mcmc

        key = jax.random.PRNGKey(cfg.seed if cfg.seed is not None else 0)
        mc, traj, energies = jax.jit(
            lambda s, k: mcmc.run_mcmc(
                system, s, k, n_steps=cfg.n_steps, save_every=cfg.n_save,
                initial_step=min(cfg.initial_step, 0)),
            static_argnums=())(state, key)
        offs = system.body_offsets
        n_saved = int(np.asarray(energies).shape[0])
        for s_idx in range(n_saved):
            step_idx = s_idx * cfg.n_save
            for i, t in enumerate(system.types):
                pos_i = np.asarray(traj.pos)[s_idx, offs[i]:offs[i + 1]]
                quat_i = np.asarray(traj.quat)[s_idx, offs[i]:offs[i + 1]]
                if cfg.save_clones == "one_file":
                    name = "%s.%s.config" % (cfg.output_name, t.name)
                    with open(name, "w" if s_idx == 0 else "a") as f:
                        f.write("%d\n" % len(pos_i))
                        for x, q in zip(pos_i, quat_i):
                            f.write("%s %s %s %s %s %s %s\n" % (
                                x[0], x[1], x[2], q[0], q[1], q[2], q[3]))
                else:
                    scene.write_clones_file(
                        "%s.%s.%08d.clones" % (cfg.output_name, t.name,
                                               step_idx), pos_i, quat_i)
        n_total = cfg.n_steps - min(cfg.initial_step, 0)
        with open(cfg.output_name + ".MCMC_info", "w") as f:
            f.write("acceptance ratio = %s\n"
                    % (int(mc.accepted) / max(n_total, 1)))
            f.write("accepted_moves = %d\n" % int(mc.accepted))
            f.write("final max_translation = %s\n"
                    % float(mc.max_translation))
            f.write("final energy = %s\n" % float(mc.energy))

    elif cfg.scheme == "body_mcmc_rejection":
        # independent-sample rejection sampler
        # (many_bodyMCMC/many_body_rejection.py)
        from .models import mcmc

        key = jax.random.PRNGKey(cfg.seed if cfg.seed is not None else 0)
        n_estimate = int(cfg.options.get(
            "n_estimate", max(cfg.n_steps // 100, 100000)))
        res = jax.jit(lambda k: mcmc.run_rejection_sampler(
            system, k, n_steps=cfg.n_steps, n_estimate=n_estimate))(key)
        accepted = np.asarray(res.accepted)
        offs = system.body_offsets
        for i, t in enumerate(system.types):
            name = "%s.%s.config" % (cfg.output_name, t.name)
            with open(name, "w") as f:
                for s_idx in np.nonzero(accepted)[0]:
                    pos_i = np.asarray(res.states.pos)[
                        s_idx, offs[i]:offs[i + 1]]
                    quat_i = np.asarray(res.states.quat)[
                        s_idx, offs[i]:offs[i + 1]]
                    f.write("%d\n" % len(pos_i))
                    for x, q in zip(pos_i, quat_i):
                        f.write("%s %s %s %s %s %s %s\n" % (
                            x[0], x[1], x[2], q[0], q[1], q[2], q[3]))
        with open(cfg.output_name + ".MCMC_info", "w") as f:
            f.write("acceptance ratio = %s\n"
                    % (accepted.sum() / max(cfg.n_steps, 1)))
            f.write("accepted_moves = %d\n" % accepted.sum())
            f.write("minimum_energy = %s\n" % float(res.minimum_energy))

    elif cfg.scheme.startswith("lubrication"):
        # lubrication-corrected sphere suspension (the reference's
        # Lubrication_Examples drivers, e.g. Uniform_Rollers
        # main_rollers.py; BASELINE config 5). Bodies are single spheres
        # of radius blob_radius; options: omega, cut_torque,
        # lub_cutoff[_wall], max_neighbors, firm_delta.
        from .models import lubrication as lub
        from .ops import forces

        opts = cfg.options
        tables = lub.LubricationTables.load(
            opts.get("lubrication_tables_dir", lub.DEFAULT_TABLE_DIR))
        max_nb = opts.get("max_neighbors")
        # the reference's option name is Lub_Cut (read_input.py:96,
        # default 4.5); lub_cutoff[_wall] are this framework's aliases
        lub_cut = float(opts.get("Lub_Cut", opts.get("lub_cutoff", 4.5)))
        sol = lub.LubSolver(
            num_bodies=system.num_bodies, eta=cfg.eta, a=cfg.blob_radius,
            kT=cfg.kT, dt=cfg.dt,
            cutoff=lub_cut,
            cutoff_wall=float(opts.get("lub_cutoff_wall", lub_cut)),
            debye_cut=float(opts.get("firm_delta", 1e-2)),
            rf_delta=cfg.rf_delta,
            periodic_length=tuple(cfg.periodic_length),
            solver_tolerance=cfg.solver_tolerance,
            max_neighbors=int(max_nb) if max_nb is not None else None,
            tables=tables)
        omega = (float(opts["omega"]) if "omega" in opts else None)
        cut_torque = (float(opts["cut_torque"]) if "cut_torque" in opts
                      else None)
        weight = cfg.g
        a = cfg.blob_radius

        # firm (stiff short-range) potential of the lubrication examples:
        # offset 2a(1-firm_delta), debye 2a*firm_delta/ln(10)
        # (Uniform_Rollers/main_rollers.py:141-143,
        # multi_bodies_functions.py:143-155,225-238)
        eps_firm = float(opts.get("repulsion_strength_firm", 0.0))
        firm_delta = float(opts.get("firm_delta", 1e-2))
        debye_firm = 2.0 * a * firm_delta / np.log(1e1)

        def ft_calc(pos):
            # gravity + wall Yukawa + pair soft repulsion on the sphere
            # centers (Uniform_Rollers FT_calc composition)
            f = forces.blob_external_forces(
                pos, g=weight, blob_radius=a,
                repulsion_strength_wall=cfg.repulsion_strength_wall,
                debye_length_wall=cfg.debye_length_wall)
            f = f + forces.blob_blob_forces(
                pos, repulsion_strength=cfg.repulsion_strength,
                debye_length=cfg.debye_length, blob_radius=a,
                periodic_length=tuple(cfg.periodic_length))
            if eps_firm > 0.0:
                # the firm wall/pair terms are the same Yukawa forms with
                # contact shifted inward by firm_delta: emulate via an
                # effective radius a(1-firm_delta)
                f = f + forces.blob_external_forces(
                    pos, g=0.0, blob_radius=a * (1.0 - firm_delta),
                    repulsion_strength_wall=eps_firm,
                    debye_length_wall=debye_firm)
                f = f + forces.blob_blob_forces(
                    pos, repulsion_strength=eps_firm,
                    debye_length=debye_firm,
                    blob_radius=a * (1.0 - firm_delta),
                    periodic_length=tuple(cfg.periodic_length))
            return jnp.concatenate([f, jnp.zeros_like(f)], axis=1)

        stepper = (lub.step_euler_maruyama
                   if "euler" in cfg.scheme else lub.step_trapezoidal)
        if stepper is lub.step_trapezoidal:
            def jit_body(pos, quats, key):
                return stepper(sol, pos, quats, key, ft_calc,
                               omega=omega, cut_torque=cut_torque)
        else:
            def jit_body(pos, quats, key):
                return stepper(sol, pos, quats, key, ft_calc)
        jit_step = jax.jit(jit_body)

        key = jax.random.PRNGKey(cfg.seed if cfg.seed is not None else 0)
        pos, quats = state.pos, state.quat
        name = system.types[0].name
        det_iters = stoch_iters = rej_wall = rej_jump = 0
        for step_idx in range(cfg.initial_step, cfg.n_steps):
            if (step_idx % cfg.n_save) == 0 and step_idx >= 0:
                scene.write_clones_file(
                    "%s.%s.%08d.clones" % (cfg.output_name, name, step_idx),
                    np.asarray(pos), np.asarray(quats))
            key, sub = jax.random.split(key)
            pos, quats, aux = jit_step(pos, quats, sub)
            det_iters += int(aux.det_iterations)
            stoch_iters += int(aux.stoch_iterations)
            rej_wall += int(aux.rejections_wall)
            rej_jump += int(aux.rejections_jump)
            if args.print_residual:
                print("lubrication step %d: gmres its %d, lanczos its %d"
                      % (step_idx, int(aux.det_iterations),
                         int(aux.stoch_iterations)))
        scene.write_clones_file(
            "%s.%s.%08d.clones" % (cfg.output_name, name, cfg.n_steps),
            np.asarray(pos), np.asarray(quats))
        with open(cfg.output_name + ".info", "w") as f:
            f.write("num_rejections_wall              %d\n" % rej_wall)
            f.write("num_rejections_jump              %d\n" % rej_jump)
            f.write("deterministic_iterations_count   %d\n" % det_iters)
            f.write("stochastic_iterations_count      %d\n" % stoch_iters)

    elif (cfg.scheme.endswith("_rollers")
          and not cfg.scheme.startswith("articulated_")):
        # minimally-resolved rollers path (reference main_rollers.py);
        # articulated_*_rollers instead use the System-based dynamic loop
        # below (grand-mobility constrained solve, integrators._SCHEMES)
        from .models import rollers

        opts = cfg.options
        sus = rollers.RollerSuspension(
            num_rollers=system.num_bodies, eta=cfg.eta,
            blob_radius=cfg.blob_radius, kT=cfg.kT, g=cfg.g,
            domain=cfg.domain, periodic_length=tuple(cfg.periodic_length),
            repulsion_strength=cfg.repulsion_strength,
            debye_length=cfg.debye_length,
            repulsion_strength_wall=cfg.repulsion_strength_wall,
            debye_length_wall=cfg.debye_length_wall,
            solver_tolerance=cfg.solver_tolerance, rf_delta=cfg.rf_delta,
            free_kinematics=(opts.get("free_kinematics", "True") == "True"),
            omega_one_roller=tuple(np.fromstring(
                opts.get("omega_one_roller", "0 0 0"), sep=" ")),
            hydro_interactions=bool(int(opts.get("hydro_interactions", 1))))
        key = jax.random.PRNGKey(cfg.seed if cfg.seed is not None else 0)
        step = rollers.make_stepper(sus, cfg.scheme, cfg.dt)
        carry = rollers.init_carry(sus, dtype=state.pos.dtype)
        positions = state.pos

        @jax.jit
        def jit_step(r, key, carry):
            return step(r, key, carry)

        det_iters = stoch_iters = rejections = overlaps = 0
        name = system.types[0].name
        quat0 = np.asarray(state.quat)
        for step_idx in range(cfg.initial_step, cfg.n_steps):
            if (step_idx % cfg.n_save) == 0:
                scene.write_clones_file(
                    "%s.%s.%08d.clones" % (cfg.output_name, name, step_idx),
                    np.asarray(positions), quat0)
            key, sub = jax.random.split(key)
            positions, carry, aux = jit_step(positions, sub, carry)
            det_iters += int(aux.det_iterations)
            stoch_iters += int(aux.stoch_iterations)
            rejections += int(aux.rejections)
            overlaps += int(aux.wall_overlaps)
        scene.write_clones_file(
            "%s.%s.%08d.clones" % (cfg.output_name, name, cfg.n_steps),
            np.asarray(positions), quat0)
        with open(cfg.output_name + ".info", "w") as f:
            f.write("invalid_configuration_count      %d\n" % rejections)
            f.write("deterministic_iterations_count   %d\n" % det_iters)
            f.write("stochastic_iterations_count      %d\n" % stoch_iters)
            f.write("wall_overlaps                    %d\n" % overlaps)

    else:
        # dynamic simulation
        key = jax.random.PRNGKey(cfg.seed if cfg.seed is not None else 0)
        if cfg.random_state is not None:
            # resume the PRNG from a saved .random_state file (the JAX
            # analog of the reference's np.random pickle restore,
            # multi_bodies.py:1154-1158)
            key = jax.random.wrap_key_data(
                jnp.asarray(np.loadtxt(cfg.random_state, dtype=np.uint32)))
        # grow the spectral engine's fixed capacities until drop-free at
        # the initial configuration (no-op for other domains), and size
        # the linked-cell force capacity from the actual occupancy
        # (overflowing cells would silently weaken the repulsion)
        from .models import kinematics as _kin
        from .models import saddle as _saddle
        from .ops import forces as _forces

        system = _saddle.auto_spectral_capacities(system, state, log=print)
        system = _forces.auto_force_cell_capacity(
            system, _kin.blob_positions(system, state), log=print)
        gmres_maxiter = 1000
        step = integrators.make_stepper(system, cfg.scheme, cfg.dt,
                                        tolerance=cfg.solver_tolerance,
                                        gmres_maxiter=gmres_maxiter,
                                        update_PC=cfg.update_PC,
                                        verbose=args.print_residual)
        carry = (integrators.init_carry_with_pc(system, state,
                                                dtype=state.pos.dtype)
                 if cfg.update_PC > 1
                 else integrators.init_carry(system, dtype=state.pos.dtype,
                                             state=state))

        @jax.jit
        def jit_step(state, key, carry):
            return step(state, key, carry)

        det_iters = 0
        stoch_iters = 0
        rejections = 0
        unconverged_steps = 0
        overflow_steps = 0

        velocities_log = []

        # articulated groups are stored type-major internally (sub-body j
        # of every instance is one BodyType) but the reference writes one
        # file per articulated ID with bodies in clones-file order
        # (instance-major, multi_bodies.py:1430-1462) — reconstruct that
        art_sub_types = set()
        for art in system.articulated:
            art_sub_types.update(art.sub_type_indices)

        def _articulated_frames(state):
            offs = system.body_offsets
            pos = np.asarray(state.pos)
            quat = np.asarray(state.quat)
            for art in system.articulated:
                p = np.stack([pos[offs[i]:offs[i] + art.count]
                              for i in art.sub_type_indices], axis=1)
                q = np.stack([quat[offs[i]:offs[i] + art.count]
                              for i in art.sub_type_indices], axis=1)
                yield art.name, p.reshape(-1, 3), q.reshape(-1, 4)

        def save_clones(step_idx, state):
            offs = system.body_offsets
            groups = [(t.name,
                       np.asarray(state.pos)[offs[i]:offs[i + 1]],
                       np.asarray(state.quat)[offs[i]:offs[i + 1]])
                      for i, t in enumerate(system.types)
                      if i not in art_sub_types]
            groups += list(_articulated_frames(state))
            for name_i, pos_i, quat_i in groups:
                if cfg.save_clones == "one_file":
                    # append snapshots into a single .config file
                    # (reference multi_bodies.py save_clones='one_file')
                    name = "%s.%s.config" % (cfg.output_name, name_i)
                    mode = "w" if step_idx == cfg.initial_step else "a"
                    with open(name, mode) as f:
                        f.write("%d\n" % len(pos_i))
                        for x, q in zip(pos_i, quat_i):
                            f.write("%s %s %s %s %s %s %s\n" % (
                                x[0], x[1], x[2], q[0], q[1], q[2], q[3]))
                else:
                    name = "%s.%s.%08d.clones" % (cfg.output_name, name_i,
                                                  step_idx)
                    scene.write_clones_file(name, pos_i, quat_i)

        def save_concentration_field(step_idx, state):
            # phoretic runs can dump the off-surface concentration field
            # alongside each saved frame (the reference example's intent,
            # multi_bodies_stkfmm.py:215-219, whose plot helper is
            # undefined there)
            if (cfg.plot_concentration_field is not None
                    and cfg.phoretic_cfg is not None):
                from .models import fields

                fields.plot_concentration_field_to_vtk(
                    cfg.plot_concentration_field, system, state,
                    cfg.phoretic_cfg, cfg.output_name,
                    suffix=".%08d" % step_idx)

        def save_mobilities(step_idx, state):
            # trajectory-resolved dense blob/body mobility dumps
            # (reference multi_bodies.py:1465-1477)
            want_blobs = cfg.options.get("save_blobs_mobility") == "True"
            want_body = cfg.options.get("save_body_mobility") == "True"
            if not (want_blobs or want_body):
                return
            M = np.asarray(solvers.dense_blob_mobility(system, state))
            if want_blobs:
                np.savetxt("%s.blobs_mobility.%08d.dat"
                           % (cfg.output_name, step_idx), M, delimiter="  ")
            if want_body:
                K = np.asarray(solvers._dense_K(system, state))
                Minv = np.linalg.inv(M)
                N = np.linalg.pinv(K.T @ Minv @ K)
                np.savetxt("%s.body_mobility.%08d.dat"
                           % (cfg.output_name, step_idx), N, delimiter="  ")

        # HydroGrid-analog on-the-fly structure factors (reference
        # multi_bodies.py:1396-1409 + read_input.py:86-93 option names)
        sk = None
        if cfg.options.get("call_HydroGrid", "False") == "True":
            from .utils.analysis import StructureFactor

            cells = np.fromstring(cfg.options.get("cells", "1 1"),
                                  sep=" ", dtype=int)
            green = np.fromstring(
                cfg.options.get("green_particles", "0 0"), sep=" ",
                dtype=int)
            sk = StructureFactor(system.periodic_length[0],
                                 system.periodic_length[1], cells, green,
                                 system.num_blobs)
        sk_sample = int(cfg.options.get("sample_HydroGrid", 1))
        sk_save = int(cfg.options.get("save_HydroGrid", 0))

        for step_idx in range(cfg.initial_step, cfg.n_steps):
            if (step_idx % cfg.n_save) == 0 and step_idx >= 0:
                elapsed = time.time() - start_time
                print("Integrator = %s, step = %d, wallclock = %.2fs" % (
                    cfg.scheme, step_idx, elapsed))
                save_clones(step_idx, state)
                save_concentration_field(step_idx, state)
                save_mobilities(step_idx, state)
            if sk is not None and (step_idx % sk_sample) == 0:
                sk.sample(kin.blob_positions(system, state))
                if sk_save > 0 and step_idx > 0 and \
                        (step_idx % sk_save) == 0:
                    sk.save(cfg.output_name + ".structure_factors.dat")
            if user_mod is not None and hasattr(user_mod, "preprocess"):
                state = user_mod.preprocess(system, state, step_idx)
            key, sub = jax.random.split(key)
            state, carry, aux = jit_step(state, sub, carry)
            if user_mod is not None and hasattr(user_mod, "postprocess"):
                state = user_mod.postprocess(system, state, step_idx)
            det_iters += int(aux.det_iterations)
            stoch_iters += int(aux.stoch_iterations)
            rejections += int(aux.rejections)
            # a solve that stopped without reaching tolerance is surfaced
            # instead of silently continuing (the per-solve converged flag
            # threads up from GmresResult through MobilitySolution)
            if not bool(np.asarray(aux.solves_converged)):
                unconverged_steps += 1
                print("WARNING: step %d had a GMRES solve stop before "
                      "tolerance (maxiter=%d)" % (step_idx, gmres_maxiter),
                      file=sys.stderr)
            # mid-run density growth can outgrow the t=0 capacity
            # auto-sizing: aux.capacity_overflows counts this step's
            # spectral-plan drops (recounted at each full rebuild) plus
            # linked-cell force overflow — a dropped particle silently
            # loses hydrodynamic/repulsion contributions, so surface it
            ovf = int(np.asarray(getattr(aux, "capacity_overflows", 0)))
            if ovf > 0:
                overflow_steps += 1
                print("WARNING: step %d dropped %d entries from fixed-"
                      "capacity layouts (grow spectral_bucket_capacity/"
                      "spectral_cell_capacity or blob_blob_cell_capacity)"
                      % (step_idx, ovf), file=sys.stderr)
            if cfg.options.get("save_velocities", "False") == "True":
                velocities_log.append(np.asarray(aux.velocities))
        save_clones(cfg.n_steps, state)
        save_mobilities(cfg.n_steps, state)
        if sk is not None and sk.n_samples > 0:
            sk.save(cfg.output_name + ".structure_factors.dat")
        if velocities_log:
            np.savetxt(cfg.output_name + ".velocities.dat",
                       np.stack(velocities_log).reshape(len(velocities_log), -1))

        with open(cfg.output_name + ".info", "w") as f:
            f.write("invalid_configuration_count      %d\n" % rejections)
            f.write("deterministic_iterations_count   %d\n" % det_iters)
            f.write("stochastic_iterations_count      %d\n" % stoch_iters)
            f.write("unconverged_solve_steps          %d\n"
                    % unconverged_steps)
            f.write("capacity_overflow_steps          %d\n"
                    % overflow_steps)
        # PRNG reproducibility (the reference pickles np.random state,
        # multi_bodies.py:1160-1162; the JAX equivalent is the final key)
        np.savetxt(cfg.output_name + ".random_state",
                   np.asarray(jax.random.key_data(key)), fmt="%d")

    with open(cfg.output_name + ".time", "w") as f:
        f.write(str(time.time() - start_time) + "\n")
    print("\n\n\n# End")


if __name__ == "__main__":
    main()
