"""Post-processing tools: trajectory-to-xyz conversion, histograms, and
file averaging — this framework's versions of the reference's `tools/`
scripts (tools/bodies_to_xyz.py, tools/histogram.py, tools/averageFiles.py).

All functions are host-side numpy utilities usable both as a library and
via `python -m rigidmultiblobswall_tpu.utils.tools <cmd> ...`.
"""

from __future__ import annotations

import numpy as np

from ..ops import quaternion as quat_ops


def read_config_file(path):
    """Read a multi-frame `.config` trajectory (the CLI's
    save_clones='one_file' output; same layout as the reference's
    multi_bodies.py one_file format): repeated blocks of
    `n` then n lines of `x y z qs qx qy qz`. Returns (frames, n, 7)."""
    frames = []
    with open(path) as f:
        lines = [l for l in (ln.strip() for ln in f) if l]
    i = 0
    while i < len(lines):
        n = int(lines[i].split()[0])
        block = np.array([[float(v) for v in lines[i + 1 + j].split()[:7]]
                          for j in range(n)])
        frames.append(block)
        i += 1 + n
    return np.stack(frames, axis=0)


def bodies_to_xyz(config, ref_config, output_path, *, blob_radius=None,
                  tag="O"):
    """Expand a body trajectory to per-blob xyz frames
    (tools/bodies_to_xyz.py): each frame becomes an extended-xyz block
    `n_blobs / comment / tag x y z [radius]`.

    config: (frames, n_bodies, 7) array or a `.config` path;
    ref_config: (n_blobs_per_body, 3) reference blob configuration."""
    import jax.numpy as jnp

    if isinstance(config, str):
        config = read_config_file(config)
    ref = np.asarray(ref_config, dtype=float)[:, :3]
    n_frames, n_bodies, _ = config.shape
    nb = ref.shape[0]
    with open(output_path, "w") as f:
        for k in range(n_frames):
            pos = config[k, :, 0:3]
            q = jnp.asarray(config[k, :, 3:7])
            R = np.asarray(quat_ops.rotation_matrix(q))  # (B,3,3)
            blobs = (pos[:, None, :]
                     + np.einsum("bij,nj->bni", R, ref)).reshape(-1, 3)
            f.write("%d\n" % (n_bodies * nb))
            f.write("frame %d\n" % k)
            for x in blobs:
                if blob_radius is not None:
                    f.write("%s %.10g %.10g %.10g %.10g\n" % (
                        tag, x[0], x[1], x[2], blob_radius))
                else:
                    f.write("%s %.10g %.10g %.10g\n" % (tag, x[0], x[1], x[2]))
    return n_frames * n_bodies * nb


def histogram_from_file(path, column, start, end, bins):
    """Normalized histogram of one column of a whitespace text file
    (tools/histogram.py): returns (bin_centers, density) with
    sum(density) * dx = 1 over the counted samples."""
    data = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if column < len(parts):
                try:
                    data.append(float(parts[column]))
                except ValueError:
                    continue
    data = np.asarray(data)
    dx = (end - start) / bins
    hist, edges = np.histogram(data, bins=bins, range=(start, end))
    norm = hist.sum() * dx
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, hist / np.where(norm > 0, norm, 1.0)


def average_files(paths, *, usecols=None):
    """Column-wise mean and standard error across equally-shaped text
    files (tools/averageFiles.py). Returns (mean, stderr), each
    (rows, cols)."""
    arrays = [np.loadtxt(p, comments="#", usecols=usecols) for p in paths]
    stack = np.stack([np.atleast_2d(a) for a in arrays], axis=0)
    mean = stack.mean(axis=0)
    n = stack.shape[0]
    if n > 1:
        stderr = stack.std(axis=0, ddof=1) / np.sqrt(n)
    else:
        stderr = np.zeros_like(mean)
    return mean, stderr


def _main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="rigidmultiblobswall_tpu.utils.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    x = sub.add_parser("bodies-to-xyz")
    x.add_argument("config")
    x.add_argument("vertex")
    x.add_argument("output")
    x.add_argument("--blob-radius", type=float, default=None)

    h = sub.add_parser("histogram")
    h.add_argument("file")
    h.add_argument("column", type=int)
    h.add_argument("start", type=float)
    h.add_argument("end", type=float)
    h.add_argument("bins", type=int)

    a = sub.add_parser("average")
    a.add_argument("files", nargs="+")

    args = p.parse_args(argv)
    if args.cmd == "bodies-to-xyz":
        from ..io import scene

        ref = scene.read_vertex_file(args.vertex)
        n = bodies_to_xyz(args.config, ref, args.output,
                          blob_radius=args.blob_radius)
        print("wrote %d blob rows -> %s" % (n, args.output))
    elif args.cmd == "histogram":
        centers, dens = histogram_from_file(args.file, args.column,
                                            args.start, args.end, args.bins)
        for c, d in zip(centers, dens):
            print(c, d)
    elif args.cmd == "average":
        mean, err = average_files(args.files)
        for row_m, row_e in zip(np.atleast_2d(mean), np.atleast_2d(err)):
            print("  ".join("%.10g" % v for v in row_m), "   ",
                  "  ".join("%.10g" % v for v in row_e))


if __name__ == "__main__":
    _main()
