"""Sequence harness: synthetic ground-truthed sequences + batch runner.

TUM/KITTI-style datasets are directories of frames; `run_sequence`
drives a SlamPipeline over either in-memory frames or image paths
(through the native prefetching FrameLoader) and evaluates ATE against
ground truth.  `render_plane_sequence` generates a synthetic textured
ground-truthed sequence so the full SLAM stack is testable with no
dataset dependencies (SURVEY.md section 4's "multi-host tests without a
cluster" philosophy applied to data).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .evaluate import ate_rmse
from .pipeline import SlamPipeline
from .tracking import Intrinsics


class SequenceResult(NamedTuple):
    trajectory: np.ndarray          # (N, 3) estimated camera centres
    gt: np.ndarray | None           # (N, 3) ground-truth centres
    ate: float | None
    inliers: np.ndarray             # (N,)


def render_plane_sequence(n_frames: int = 8, h: int = 240, w: int = 320,
                          seed: int = 0, motion: float = 0.02):
    """Camera translating/rotating above a textured plane at z=1.

    Returns (frames uint8 (N, h, w), centres (N, 3), Intrinsics).  The
    texture is smooth multi-scale noise so SURF finds stable blobs.
    """
    rng = np.random.default_rng(seed)
    intr = Intrinsics(fx=0.9 * w, fy=0.9 * w, cx=w / 2.0, cy=h / 2.0)

    # multi-scale smooth texture over the plane patch [-1,1]^2:
    # bilinearly upsampled coarse noise at several cell sizes
    T = 1024
    tex = np.zeros((T, T))
    gy, gx = np.mgrid[0:T, 0:T].astype(np.float64)
    for cell in (8, 16, 32, 64):
        g = rng.normal(0, 1, (T // cell + 2, T // cell + 2))
        u, v = gx / cell, gy / cell
        u0, v0 = u.astype(int), v.astype(int)
        fu, fv = u - u0, v - v0
        tex += (g[v0, u0] * (1 - fu) * (1 - fv) + g[v0, u0 + 1] * fu * (1 - fv)
                + g[v0 + 1, u0] * (1 - fu) * fv + g[v0 + 1, u0 + 1] * fu * fv)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255.0

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    frames, centres = [], []
    for i in range(n_frames):
        # camera pose: world->cam; camera at c_i looking down +z
        ang = motion * i
        c = np.array([motion * 2 * i, motion * np.sin(1.7 * i), -1.0])
        Rz = np.array([[np.cos(ang), -np.sin(ang), 0],
                       [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
        R = Rz
        t = -R @ c
        # ray through each pixel: X = R^T (z_c * K^-1 u) + c, plane z=0
        dx = (xx - intr.cx) / intr.fx
        dy = (yy - intr.cy) / intr.fy
        d_cam = np.stack([dx, dy, np.ones_like(dx)], -1)
        d_world = d_cam @ R  # R^T d
        lam = -c[2] / d_world[..., 2]
        X = c[None, None, :] + lam[..., None] * d_world
        u = (X[..., 0] * 0.35 + 0.5) * (T - 1)
        v = (X[..., 1] * 0.35 + 0.5) * (T - 1)
        u = np.clip(u, 0, T - 2)
        v = np.clip(v, 0, T - 2)
        u0, v0 = u.astype(int), v.astype(int)
        fu, fv = u - u0, v - v0
        img = (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
               + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        centres.append(c)
    return np.stack(frames), np.stack(centres), intr


def _multiscale_texture(rng, T: int, cells=(8, 16, 32, 64)) -> np.ndarray:
    tex = np.zeros((T, T))
    gy, gx = np.mgrid[0:T, 0:T].astype(np.float64)
    for cell in cells:
        g = rng.normal(0, 1, (T // cell + 2, T // cell + 2))
        u, v = gx / cell, gy / cell
        u0, v0 = u.astype(int), v.astype(int)
        fu, fv = u - u0, v - v0
        tex += (g[v0, u0] * (1 - fu) * (1 - fv) + g[v0, u0 + 1] * fu * (1 - fv)
                + g[v0 + 1, u0] * (1 - fu) * fv + g[v0 + 1, u0 + 1] * fu * fv)
    return (tex - tex.min()) / (np.ptp(tex) + 1e-9)


def render_terrain_sequence(n_frames: int = 50, h: int = 200, w: int = 280,
                            seed: int = 0, relief: float = 0.45,
                            loop: bool = True):
    """Camera orbiting above a textured HEIGHT-FIELD (genuine 3D
    structure: parallax between near and far terrain), exact per-pixel
    ray-marched rendering with analytic ground truth.

    The all-plane scene of :func:`render_plane_sequence` is degenerate
    for essential-matrix VO (a plane admits a homography); this terrain
    makes two-view geometry well-posed.  With `loop`, the trajectory is
    a closed orbit so the final frames revisit the first poses —
    exercise for the loop detector + pose graph.

    Returns (frames uint8 (N, h, w), centres (N, 3), Intrinsics).
    """
    poses = terrain_orbit_poses(n_frames, loop)
    return _render_terrain(poses, h, w, seed, relief)


def terrain_orbit_poses(n_frames: int, loop: bool = True) -> list:
    """(R world->cam, centre) poses of :func:`render_terrain_sequence`'s
    orbit.  With `loop` the orbit closes over `n_frames`; without it the
    camera covers 0.4 rad of the orbit."""
    poses = []
    for i in range(n_frames):
        ph = 2 * np.pi * i / n_frames if loop else 0.4 * i / n_frames
        c = np.array([0.28 * np.cos(ph), 0.28 * np.sin(ph),
                      -1.0 + 0.04 * np.sin(2 * ph)])
        # gentle roll variation.  Amplitude is deliberately <= ~7 deg:
        # upright SURF stops matching beyond ~10 deg relative roll, and
        # revisit pairs must stay matchable for the loop detector
        # (oriented descriptors are rotation-invariant but markedly
        # less discriminative on this self-similar noise texture —
        # median Lowe ratio 0.96 vs 0.85 upright)
        yaw = 0.12 * np.sin(ph)
        Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                       [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        poses.append((Rz, c))
    return poses


def render_terrain_pair(h: int = 960, w: int = 1280, seed: int = 0):
    """Seeded two-view terrain pair at the reference demo's frame size
    (1280x960, main.cpp:239-245): the first two frames of an open
    :func:`render_terrain_sequence` orbit (baseline ~0.057, relative
    roll ~1.4 deg).  Returns (frames uint8 (2, h, w), poses
    [(R world->cam, centre)] * 2, Intrinsics)."""
    poses = terrain_orbit_poses(2, loop=False)
    # texture scales down to 2 texels keep fine blobs at this resolution
    # (~3.5k keypoints per frame at thresh 4.0, like the reference's own
    # stereo pair)
    frames, _, intr = _render_terrain(poses, h, w, seed, 0.45,
                                      cells=(2, 4, 8, 16, 32, 64))
    return frames, poses, intr


def render_forward_sequence(n_frames: int = 20, h: int = 200, w: int = 280,
                            seed: int = 0, relief: float = 0.45,
                            speed: float = 0.03):
    """Forward-motion variant (KITTI-like geometry): the camera
    advances mostly ALONG its optical axis toward the terrain with a
    small lateral drift.  The epipole sits near the image centre —
    the hard regime for monocular translation estimation (parallax
    vanishes toward the focus of expansion), complementing the
    lateral-motion orbit of :func:`render_terrain_sequence`."""
    poses = []
    I = np.eye(3)
    for i in range(n_frames):
        c = np.array([0.008 * i, 0.004 * i, -1.35 + speed * i])
        poses.append((I, c))
    return _render_terrain(poses, h, w, seed, relief)


def _render_terrain(poses, h, w, seed, relief, cells=(8, 16, 32, 64)):
    """Ray-march render of the procedural height-field for a list of
    (R world->cam with d_z == 1, centre) poses; `cells` are the texture
    noise scales in texels.  Returns (frames uint8 (N, h, w), centres
    (N, 3), Intrinsics)."""
    rng = np.random.default_rng(seed)
    intr = Intrinsics(fx=0.9 * w, fy=0.9 * w, cx=w / 2.0, cy=h / 2.0)
    T = 1024
    # S-curve contrast stretch: the raw multiscale noise is mid-heavy
    # (std ~25/255) and starves the Hessian detector; pushing mass
    # toward the extremes roughly doubles the detected keypoint count
    tex = _multiscale_texture(rng, T, cells)
    tex = (0.5 + 0.5 * np.tanh(2.2 * (2.0 * tex - 1.0))) * 255.0
    elev = _multiscale_texture(np.random.default_rng(seed + 1), T,
                               cells=(64, 128, 256))

    def surface_z(x, y):
        """Terrain height (world z, camera looks toward +z) at plane
        coords; bilinear in the elevation map over [-1, 1]^2."""
        u = np.clip((x * 0.35 + 0.5) * (T - 1), 0, T - 2)
        v = np.clip((y * 0.35 + 0.5) * (T - 1), 0, T - 2)
        u0, v0 = u.astype(int), v.astype(int)
        fu, fv = u - u0, v - v0
        e = (elev[v0, u0] * (1 - fu) * (1 - fv) + elev[v0, u0 + 1] * fu * (1 - fv)
             + elev[v0 + 1, u0] * (1 - fu) * fv + elev[v0 + 1, u0 + 1] * fu * fv)
        return -relief * e          # terrain spans z in [-relief, 0]

    def sample_tex(x, y):
        u = np.clip((x * 0.35 + 0.5) * (T - 1), 0, T - 2)
        v = np.clip((y * 0.35 + 0.5) * (T - 1), 0, T - 2)
        u0, v0 = u.astype(int), v.astype(int)
        fu, fv = u - u0, v - v0
        return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
                + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dx = (xx - intr.cx) / intr.fx
    dy = (yy - intr.cy) / intr.fy

    frames, centres = [], []
    for R, c in poses:
        d_cam = np.stack([dx, dy, np.ones_like(dx)], -1)
        d_world = d_cam @ R                       # R^T d
        # ray-march f(lam) = z(lam) - surface_z(x(lam), y(lam)): camera is
        # above the terrain (f<0), find the first crossing, then bisect.
        # Rays have d_z == 1 (roll-only rotation), so the crossing lies
        # at lam = z_surf - z_cam in [|z_cam| - relief - eps, |z_cam|].
        lam0 = -c[2] - relief - 0.03
        step = (-c[2] - lam0 + 0.06) / 85.0
        lo = np.full((h, w), lam0)
        hi = np.full((h, w), -c[2] + 0.06)
        lam = np.full((h, w), lam0)
        prev = lam.copy()
        crossed = np.zeros((h, w), bool)
        for _ in range(85):
            X = c[None, None, :] + lam[..., None] * d_world
            f = X[..., 2] - surface_z(X[..., 0], X[..., 1])
            newly = (f > 0) & ~crossed
            hi = np.where(newly, lam, hi)
            lo = np.where(newly, prev, lo)
            crossed |= newly
            prev = np.where(crossed, prev, lam)
            lam = np.where(crossed, lam, lam + step)
        # bisection refinement
        for _ in range(18):
            mid = 0.5 * (lo + hi)
            X = c[None, None, :] + mid[..., None] * d_world
            f = X[..., 2] - surface_z(X[..., 0], X[..., 1])
            hi = np.where(f > 0, mid, hi)
            lo = np.where(f > 0, lo, mid)
        lam = 0.5 * (lo + hi)
        X = c[None, None, :] + lam[..., None] * d_world
        img = sample_tex(X[..., 0], X[..., 1])
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        centres.append(np.asarray(c, np.float64))
    return np.stack(frames), np.stack(centres), intr


def _latest_pipeline_ckpt(directory: str):
    import glob
    import os
    files = sorted(glob.glob(os.path.join(directory, "pipeline_*.npz")))
    return files[-1] if files else None


def _save_pipeline_atomic(directory: str, pipe: SlamPipeline, k: int,
                          keep: int = 3):
    """Torn-write-immune checkpoint: a kill mid-save leaves only a temp
    file that resume discovery ignores.  Older snapshots beyond `keep`
    are pruned (each archive holds the full map/detector state — a long
    sequence would otherwise accumulate hundreds of multi-MB files)."""
    import glob
    import os
    from .checkpoint import save_pipeline
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_{os.getpid()}.npz")
    save_pipeline(tmp, pipe)
    os.replace(tmp, os.path.join(directory, f"pipeline_{k:09d}.npz"))
    old = sorted(glob.glob(os.path.join(directory, "pipeline_*.npz")))
    for path in old[: max(0, len(old) - keep)]:
        try:
            os.remove(path)
        except OSError:
            pass


def run_sequence(pipe: SlamPipeline, frames, gt: np.ndarray | None = None,
                 prefetch_depth: int = 4,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 25,
                 heartbeat_path: str | None = None) -> SequenceResult:
    """Drive the pipeline over `frames` (array of images, or a list of
    image paths streamed through the native prefetching loader).

    Long-run resilience (SURVEY.md section 5 row 3): with
    `checkpoint_dir`, the pipeline state is atomically checkpointed
    every `checkpoint_every` frames and at the end; re-running the same
    call after a crash/kill resumes after the newest complete
    checkpoint and produces the identical trajectory.  With
    `heartbeat_path`, a liveness file is published for an external
    watchdog (parallel/elastic.py)."""
    n_total = len(frames)
    start = 0
    if checkpoint_dir is not None:
        ck = _latest_pipeline_ckpt(checkpoint_dir)
        if ck is not None:
            from .checkpoint import load_pipeline
            load_pipeline(ck, pipe)
            start = min(len(pipe.frames), n_total)
    rest = frames[start:] if start else frames
    if len(rest) and isinstance(rest[0], str):
        from ..io.native import FrameLoader
        it = FrameLoader(list(rest), depth=prefetch_depth)
    else:
        it = iter(rest)
    hb = None
    if heartbeat_path is not None:
        from ..parallel.elastic import Heartbeat
        hb = Heartbeat(heartbeat_path).start()
    try:
        for k, f in enumerate(it, start=start):
            pipe.process(np.asarray(f))
            if hb is not None:
                hb.beat(k)
            if (checkpoint_dir is not None and (k + 1) % checkpoint_every
                    == 0 and k + 1 < n_total):
                _save_pipeline_atomic(checkpoint_dir, pipe, k + 1)
        if checkpoint_dir is not None and n_total > start:
            _save_pipeline_atomic(checkpoint_dir, pipe, n_total)
    finally:
        if hb is not None:
            hb.stop()
    traj = pipe.trajectory()
    inl = np.asarray([s.n_inliers for s in pipe.frames])
    ate = None
    if gt is not None:
        ate = ate_rmse(traj, np.asarray(gt), with_scale=True)
    return SequenceResult(trajectory=traj, gt=gt, ate=ate, inliers=inl)


def load_image_dir(path: str, pattern: str = "*") -> list:
    """Sorted image paths from a directory (PGM/PPM/PNG), for streaming
    through run_sequence / the native FrameLoader."""
    import glob
    import os
    exts = (".pgm", ".ppm", ".png")
    files = sorted(p for p in glob.glob(os.path.join(path, pattern))
                   if os.path.splitext(p)[1].lower() in exts)
    if not files:
        raise FileNotFoundError(f"no images under {path!r}")
    return files


def load_tum_trajectory(path: str) -> tuple:
    """Parse a TUM-format trajectory file (lines of `timestamp tx ty tz
    qx qy qz qw`, '#' comments) -> (timestamps (N,), centres (N, 3),
    quaternions (N, 4) in xyzw order) — the ground-truth format of the
    TUM RGB-D benchmark, consumed by evaluate.ate_rmse."""
    ts, cs, qs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) < 8:
                continue
            ts.append(vals[0])
            cs.append(vals[1:4])
            qs.append(vals[4:8])
    return (np.asarray(ts), np.asarray(cs), np.asarray(qs))


def load_kitti_poses(path: str) -> tuple:
    """Parse a KITTI odometry poses file (lines of 12 floats: the
    row-major 3x4 cam-to-world matrix [R|t]) -> (poses (N, 4, 4),
    centres (N, 3)).  Centres feed evaluate.ate_rmse directly."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) == 12:
                rows.append(vals)
    if not rows:
        raise ValueError(f"no 3x4 pose rows in {path!r}")
    P = np.asarray(rows).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (len(P), 1, 1))
    poses[:, :3, :] = P
    return poses, P[:, :, 3].copy()


def load_kitti_calib(path: str, camera: int = 0) -> "Intrinsics":
    """Parse a KITTI odometry calib.txt (`P0: <12 floats>` rows, one
    per camera) into the pinhole Intrinsics of the chosen camera."""
    key = f"P{camera}:"
    with open(path) as f:
        for line in f:
            if line.startswith(key):
                vals = [float(v) for v in line.split()[1:]]
                P = np.asarray(vals).reshape(3, 4)
                return Intrinsics(fx=float(P[0, 0]), fy=float(P[1, 1]),
                                  cx=float(P[0, 2]), cy=float(P[1, 2]))
    raise ValueError(f"no {key} row in {path!r}")


def load_kitti_times(path: str) -> np.ndarray:
    """Parse a KITTI odometry times.txt (one timestamp per line)."""
    with open(path) as f:
        return np.asarray([float(line) for line in f if line.strip()])


def associate_timestamps(t_a, t_b, max_dt: float = 0.02):
    """Nearest-neighbour association of two timestamp lists (the TUM
    benchmark's associate step): returns index pairs (i, j)."""
    t_a = np.asarray(t_a)
    t_b = np.asarray(t_b)
    j = np.searchsorted(t_b, t_a)
    j = np.clip(j, 1, len(t_b) - 1)
    j = np.where(np.abs(t_b[j] - t_a) < np.abs(t_b[j - 1] - t_a), j, j - 1)
    ok = np.abs(t_b[j] - t_a) <= max_dt
    return np.stack([np.nonzero(ok)[0], j[ok]], axis=1)
