"""BA_info factor-graph wire format: reader + writer.

Byte-compatible with the reference's offline BA exchange protocol
(reference: writer Work/SLAM/application/own/slam2.py:743-865; reader
Work/SLAM/tools/bundle_adjustment/IO.hpp:20-135 filenames, :141-296 decoders,
:302-406 hole-filling/loadData). The front-end dumps these files per run; the
BA back-end consumes them — the two sides are separate processes coupled only
through this protocol, a contract this framework preserves.

Sectioned-ASCII convention (IO.hpp:141-185 loadAscii): '#' lines are comments,
an *empty line* starts the next list entry (= next step / next frame / next
matrix cell), values within a line are space-separated.
"""

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["NoiseModel", "BAFilenames", "BAData", "load_ba_data",
           "save_ba_data", "make_filenames"]


@dataclass
class NoiseModel:
    """GTSAM-style noise spec: kind in {Unit, Isotropic, Diagonal, Constrained},
    sigmas per-dimension (IO.hpp:273-296)."""
    kind: str
    dim: int
    sigmas: np.ndarray

    @classmethod
    def unit(cls, dim):
        return cls("Unit", dim, np.ones(dim))

    @classmethod
    def isotropic(cls, dim, sigma):
        return cls("Isotropic", dim, np.full(dim, float(sigma)))

    @classmethod
    def diagonal(cls, sigmas):
        s = np.asarray(sigmas, dtype=np.float64)
        return cls("Diagonal", len(s), s)

    def encode(self) -> str:
        if self.kind == "Unit":
            return "Unit"
        if self.kind == "Isotropic":
            return f"Isotropic {float(self.sigmas[0])!r}"
        return self.kind + " " + " ".join(map(repr, map(float, self.sigmas)))

    @classmethod
    def decode(cls, words, dim):
        kind = words[0]
        rest = words[1:]
        if kind == "Unit":
            return cls.unit(dim)
        if kind == "Isotropic":
            return cls.isotropic(dim, float(rest[0]))
        if kind in ("Diagonal", "Constrained"):
            sig = np.array([float(v) for v in rest], dtype=np.float64)
            if len(sig) != dim:
                raise ValueError(f"{kind} noise needs {dim} sigmas, got "
                                 f"{len(sig)}")
            return cls(kind, dim, sig)
        raise ValueError(f"Noise-type '{kind}' unknown.")


@dataclass
class BAFilenames:
    """All input/output paths of one BA run (IO.hpp:20-135)."""
    map_in: str
    trajectories_in: List[str]
    pose_noise: List[str]
    odometry_noise: str
    point3D_noise: str
    point2D_noise: List[str]
    calibrations: List[str]
    odometry: str
    odometry_assocs: str
    point3D_added_idxs: str
    points2D: List[str]
    point2D3D_assocs: List[str]
    map_out: str
    trajectories_out: List[str]


def make_filenames(base_dir: str, base_name: str,
                   nr_cameras: int) -> BAFilenames:
    """Reference file-naming scheme (IO.hpp:46-135)."""
    j = lambda name: os.path.join(base_dir, name)
    cams = range(nr_cameras)
    return BAFilenames(
        map_in=j(f"map_out-{base_name}.pcd"),
        trajectories_in=[j(f"traj_out.cam{c}-{base_name}.txt") for c in cams],
        pose_noise=[j(f"BA_info.noise.pose.cam{c}-{base_name}.txt")
                    for c in cams],
        odometry_noise=j(f"BA_info.noise.odometry-{base_name}.txt"),
        point3D_noise=j(f"BA_info.noise.point3D-{base_name}.txt"),
        point2D_noise=[j(f"BA_info.noise.point2D.cam{c}-{base_name}.txt")
                       for c in cams],
        calibrations=[j(f"BA_info.calibrations.cam{c}.txt") for c in cams],
        odometry=j(f"BA_info.measurements.odometry-{base_name}.txt"),
        odometry_assocs=j(
            f"BA_info.measurements.odometryAssocs-{base_name}.txt"),
        point3D_added_idxs=j(
            f"BA_info.measurements.point3DAddedIdxs-{base_name}.txt"),
        points2D=[j(f"BA_info.measurements.points2D.cam{c}-{base_name}.txt")
                  for c in cams],
        point2D3D_assocs=[
            j(f"BA_info.measurements.point2D3DAssocs.cam{c}-{base_name}.txt")
            for c in cams],
        map_out=j(f"map_out-{base_name}-BA.pcd"),
        trajectories_out=[j(f"traj_out.cam{c}-{base_name}-BA.txt")
                          for c in cams],
    )


@dataclass
class BAData:
    """In-memory factor-graph dump (DataStructures.hpp:55-88 equivalent).

    Indexing: ``poses[cam][frame]`` is an (SE3 4x4 cam-to-world np array,
    timestamp) pair or None for a hole; ``odometry[step]`` is a list of 4x4
    relative transforms paired with ``odometry_assocs[step]`` entries
    (from_cam, from_frame, to_cam, to_frame); ``points2D[cam][frame]`` is an
    [n, 2] array; ``point2D3D_assocs[cam][step]`` is an [n, 3] int array of
    (frame, point2D_idx, point3D_idx); ``point3D_added_idxs[step]`` lists the
    landmark indices first optimized at that step.
    """
    nr_cameras: int
    pose_noise: List[NoiseModel] = field(default_factory=list)
    odometry_noise: List[List[Optional[NoiseModel]]] = field(
        default_factory=list)  # [from_cam][to_cam]
    point3D_noise: Optional[NoiseModel] = None
    point2D_noise: List[NoiseModel] = field(default_factory=list)
    calibrations: List[np.ndarray] = field(default_factory=list)  # [9] each
    odometry: List[List[np.ndarray]] = field(default_factory=list)
    odometry_assocs: List[List[Tuple[int, int, int, int]]] = field(
        default_factory=list)
    points3D: np.ndarray = None          # [P, 3]
    point_colors: np.ndarray = None      # [P] packed float (or None)
    point3D_added_idxs: List[List[int]] = field(default_factory=list)
    points2D: List[List[np.ndarray]] = field(default_factory=list)
    point2D3D_assocs: List[List[np.ndarray]] = field(default_factory=list)
    poses: List[List[Optional[Tuple[np.ndarray, float]]]] = field(
        default_factory=list)

    @property
    def nr_steps(self):
        return len(self.point3D_added_idxs)


def _read_sections(filename):
    """loadAscii (IO.hpp:141-185): list of sections, each a list of
    word-lists; '#' comments skipped, empty line starts a new section."""
    sections = [[]]
    with open(filename) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("#"):
                continue
            if line == "":
                sections.append([])
                continue
            sections[-1].append(line.split(" "))
    return sections


def _pose_from_words(words):
    """decode_Pose3 (IO.hpp:221-228): tx ty tz qx qy qz qw -> 4x4 cam-to-world."""
    return _pose_from_vals([float(v) for v in words])


def _pose_from_vals(vals):
    from mqslam_tpu_torch.io.nputil import quat_to_matrix_np
    t = np.array(vals[0:3])
    q = np.array(vals[3:7])
    P = np.eye(4)
    P[:3, :3] = quat_to_matrix_np(q)
    P[:3, 3] = t
    return P


def _pose_to_words(P):
    from mqslam_tpu_torch.io.nputil import matrix_to_quat_np
    q = matrix_to_quat_np(P[:3, :3])
    t = P[:3, 3]
    return list(map(float, t)) + list(map(float, q))


def load_ba_data(base_dir: str, base_name: str, nr_cameras: int,
                 fps: int = 1, start_time: float = 0.0,
                 first_frame_starts_after_start_time: bool = True) -> BAData:
    """Load a full BA_info dump (IO.hpp:366-406 loadData semantics, including
    trajectory hole-filling by fps snapping, IO.hpp:302-363)."""
    from mqslam_tpu_torch.io import pcd, tum

    fn = make_filenames(base_dir, base_name, nr_cameras)
    data = BAData(nr_cameras=nr_cameras)

    for c in range(nr_cameras):
        sec = _read_sections(fn.pose_noise[c])
        data.pose_noise.append(NoiseModel.decode(sec[0][0], 6))
    # odometry noise: matrix over (from_cam row, to_cam column); newline =
    # next column, empty line = next row (noise file header comments).
    sec = _read_sections(fn.odometry_noise)
    mat = []
    for row in sec[:nr_cameras]:
        mat.append([NoiseModel.decode(words, 6) if words else None
                    for words in row])
    data.odometry_noise = mat
    sec = _read_sections(fn.point3D_noise)
    data.point3D_noise = NoiseModel.decode(sec[0][0], 3)
    for c in range(nr_cameras):
        sec = _read_sections(fn.point2D_noise[c])
        data.point2D_noise.append(NoiseModel.decode(sec[0][0], 2))

    for c in range(nr_cameras):
        sec = _read_sections(fn.calibrations[c])
        data.calibrations.append(
            np.array([float(v) for v in sec[0][0]], dtype=np.float64))

    data.odometry = [[_pose_from_words(w) for w in s]
                     for s in _read_sections(fn.odometry)]
    data.odometry_assocs = [[tuple(int(v) for v in w) for w in s]
                            for s in _read_sections(fn.odometry_assocs)]

    pts, colors, _ = pcd.load_pcd(fn.map_in, use_alpha=True)
    data.points3D = pts.astype(np.float64)
    if colors is not None:
        data.point_colors = np.ascontiguousarray(colors).view(
            np.float32).reshape(-1)
    data.point3D_added_idxs = [[int(w[0]) for w in s]
                               for s in _read_sections(fn.point3D_added_idxs)]
    for c in range(nr_cameras):
        secs = _read_sections(fn.points2D[c])
        data.points2D.append([
            np.array([[float(v) for v in w] for w in s],
                     dtype=np.float64).reshape(-1, 2) for s in secs])
        secs = _read_sections(fn.point2D3D_assocs[c])
        data.point2D3D_assocs.append([
            np.array([[int(v) for v in w] for w in s],
                     dtype=np.int64).reshape(-1, 3) for s in secs])

    # trajectories + hole filling
    for c in range(nr_cameras):
        traj = tum.load_trajectory(fn.trajectories_in[c])
        nodes = []
        for i in range(len(traj)):
            nodes.append((_pose_from_vals(
                list(map(float, traj.locations[i])) +
                list(map(float, traj.quaternions[i]))), traj.timestamps[i]))
        data.poses.append(nodes)
    _fill_holes(data, fps, start_time, first_frame_starts_after_start_time)
    return data


def _fill_holes(data: BAData, fps: int, start_time: float,
                first_after: bool):
    """fillHolesInTrajectories (IO.hpp:302-363): snap timestamps to frame
    slots of width 1/fps; missing slots become None; pad to nr_steps."""
    nr_steps = data.nr_steps
    end_time = start_time
    for nodes in data.poses:
        if nodes and nodes[-1][1] > end_time:
            end_time = nodes[-1][1]
    if fps > 0:
        nr_frames = round((end_time - start_time) * fps)
        if not first_after:
            nr_frames += 1
        new_poses = []
        for nodes in data.poses:
            it = 0
            out = []
            for f in range(nr_frames):
                t = start_time + (f + (1 if first_after else 0)) / fps
                while it < len(nodes) and nodes[it][1] < t - 0.5 / fps:
                    it += 1
                if (it < len(nodes)
                        and t - 0.5 / fps <= nodes[it][1] < t + 0.5 / fps):
                    out.append(nodes[it])
                else:
                    out.append(None)
            new_poses.append(out)
        data.poses = new_poses
    else:
        nr_frames = len(data.poses[0])
    if nr_steps < nr_frames:
        raise ValueError(f"nr_steps ({nr_steps}) < nr_frames ({nr_frames})")
    for nodes in data.poses:
        nodes.extend([None] * (nr_steps - len(nodes)))


def save_ba_data(base_dir: str, base_name: str, data: BAData,
                 timestamps=None):
    """Write a complete BA_info dump the reference back-end could consume
    (mirrors slam2.py:791-865 BundleAdjustmentInfoContainer.write_all)."""
    from mqslam_tpu_torch.io import pcd

    os.makedirs(base_dir, exist_ok=True)
    fn = make_filenames(base_dir, base_name, data.nr_cameras)

    def write_sections(path, sections, header):
        with open(path, "w") as f:
            f.write(header)
            first = True
            for s in sections:
                if not first:
                    f.write("\n")
                first = False
                for line in s:
                    f.write(line + "\n")

    for c in range(data.nr_cameras):
        write_sections(fn.pose_noise[c], [[data.pose_noise[c].encode()]],
                       _NOISE_HDR % 6)
        write_sections(fn.point2D_noise[c],
                       [[data.point2D_noise[c].encode()]], _NOISE_HDR % 2)
        write_sections(
            fn.calibrations[c],
            [[" ".join(map(repr, map(float, data.calibrations[c])))]],
            "# Format: fx fy s u0 v0 k1 k2 p1 p2\n")
    write_sections(fn.point3D_noise, [[data.point3D_noise.encode()]],
                   _NOISE_HDR % 3)
    rows = []
    for row in data.odometry_noise:
        rows.append([nm.encode() if nm is not None else "Unit"
                     for nm in row])
    write_sections(fn.odometry_noise, rows, _NOISE_HDR_ODO)

    write_sections(
        fn.odometry,
        [[" ".join(map(repr, _pose_to_words(P))) for P in s]
         for s in data.odometry],
        "# Format: tx ty tz qx qy qz qw\n"
        "# Newline means next odometry; Empty line means next step\n")
    write_sections(
        fn.odometry_assocs,
        [[" ".join(map(str, a)) for a in s] for s in data.odometry_assocs],
        "# Format: from_cam from_frame to_cam to_frame\n"
        "# Newline means next odometry assoc; Empty line means next step\n")
    write_sections(
        fn.point3D_added_idxs,
        [[str(i) for i in s] for s in data.point3D_added_idxs],
        "# Format: point3D_idx\n"
        "# Newline means next idx; Empty line means next step\n")
    for c in range(data.nr_cameras):
        write_sections(
            fn.points2D[c],
            [["%.16e %.16e" % (p[0], p[1]) for p in s]
             for s in data.points2D[c]],
            "# Format: x y\n"
            "# Newline means next feature; Empty line means next frame, "
            "first feature\n")
        write_sections(
            fn.point2D3D_assocs[c],
            [[" ".join(map(str, map(int, a))) for a in s]
             for s in data.point2D3D_assocs[c]],
            "# Format: frame point2D_idx point3D_idx\n"
            "# Newline means next assoc; Empty line means next step\n")

    # map + trajectories (the front-end's live outputs)
    colors = None
    if data.point_colors is not None:
        colors = np.ascontiguousarray(
            data.point_colors.astype(np.float32)).view(np.uint8).reshape(-1, 4)
    pcd.save_pcd(fn.map_in, data.points3D, colors)
    from mqslam_tpu_torch.io import tum as tum_mod
    for c in range(data.nr_cameras):
        ts, locs, quats = [], [], []
        for f, node in enumerate(data.poses[c]):
            if node is None:
                continue
            P, t = node
            w = _pose_to_words(P)
            ts.append(t)
            locs.append(w[:3])
            quats.append(w[3:])
        tum_mod.save_trajectory(fn.trajectories_in[c], tum_mod.CamTrajectory(
            np.asarray(ts), np.asarray(locs).reshape(-1, 3),
            np.asarray(quats).reshape(-1, 4)))
    return fn


_NOISE_HDR = (
    '# Format: noiseType noiseSpecificValues\n'
    '# Where "noiseType" can be one of {"Unit", "Isotropic", "Diagonal", '
    '"Constrained"}\n'
    '# and "noiseSpecificValues" specify the sigma values,\n'
    '# the amount of values is dependent on "noiseType"\n'
    '# The dimension of the noise is equal to %d.\n')
_NOISE_HDR_ODO = (_NOISE_HDR % 6) + (
    '# Matrix structure (from cam at row to cam at column) : Newline means '
    'next column; Empty line means next row, first column\n')
