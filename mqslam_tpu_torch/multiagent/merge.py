"""Merge per-agent BA dumps into one joint multi-camera factor graph.

Each agent contributes its pose chain, landmarks, observations and odometry;
cross-agent between factors (known rig extrinsics, rendezvous constraints,
or co-visibility alignments) couple the chains — exactly the graph shape the
reference's 2-robot synthetic scenario builds in one piece
(reference: GenerateData.hpp:256-269 cross-camera odometry;
bundle_adjust.cpp:300-309 BetweenFactor insertion).

Landmark unification: with ``merge_landmarks=True``, landmarks from
different agents lying within ``merge_radius`` (after the optional per-agent
alignment transforms) collapse to a single landmark id, so joint BA enforces
map consensus instead of keeping duplicate points.

A copy of the JAX package's module (``mqslam_tpu/multiagent/merge.py``),
NumPy and SciPy on the host, line for line: the greedy union onto the
earliest agent, the compaction of ids and the overwrite of
``odometry_noise[from][to]`` by a cross-factor's ``sigmas`` (the last such
factor of a pair wins) are kept as they are, so both packages build the
same graph.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mqslam_tpu_torch.io import ba_info

__all__ = ["CrossOdometry", "merge_agents"]


@dataclass
class CrossOdometry:
    """A between-factor linking two agents' frames: measured = W_from^-1 W_to
    (cam-to-world convention, like the wire format)."""
    step: int
    from_agent: int
    from_frame: int
    to_agent: int
    to_frame: int
    measured: np.ndarray  # [4, 4]
    sigmas: Optional[np.ndarray] = None  # [6] rot+trans


def _apply_sim3(T, pts):
    return pts @ T[:3, :3].T + T[:3, 3]


def merge_agents(datas: Sequence[ba_info.BAData],
                 cross_odometry: Sequence[CrossOdometry] = (),
                 agent_transforms: Optional[Sequence[np.ndarray]] = None,
                 merge_landmarks: bool = False,
                 merge_radius: float = 0.1) -> ba_info.BAData:
    """Combine N single-camera BAData into one N-camera BAData.

    agent_transforms: optional per-agent 4x4 rigid transforms mapping each
    agent's world frame into the common frame (identity if None) — applied
    to poses, landmarks and odometry-free quantities before merging.
    """
    N = len(datas)
    S = max(d.nr_steps for d in datas)
    if agent_transforms is None:
        agent_transforms = [np.eye(4)] * N

    out = ba_info.BAData(nr_cameras=N)
    out.pose_noise = [d.pose_noise[0] for d in datas]
    out.point2D_noise = [d.point2D_noise[0] for d in datas]
    out.calibrations = [np.asarray(d.calibrations[0]) for d in datas]
    out.point3D_noise = datas[0].point3D_noise
    default_odo = datas[0].odometry_noise[0][0] if datas[0].odometry_noise \
        else ba_info.NoiseModel.diagonal([0.05] * 3 + [0.2] * 3)
    out.odometry_noise = [[
        (datas[a].odometry_noise[0][0]
         if a == b and datas[a].odometry_noise else default_odo)
        for b in range(N)] for a in range(N)]

    # --- landmarks: offset per agent, optional proximity unification ---
    offsets = []
    all_pts = []
    all_colors = []
    total = 0
    for a, d in enumerate(datas):
        offsets.append(total)
        pts = _apply_sim3(agent_transforms[a],
                          np.asarray(d.points3D, dtype=np.float64))
        all_pts.append(pts)
        if d.point_colors is not None:
            all_colors.append(np.asarray(d.point_colors))
        total += len(pts)
    points = np.concatenate(all_pts, axis=0) if all_pts else \
        np.zeros((0, 3))
    colors = (np.concatenate(all_colors) if len(all_colors) == N else None)

    remap = np.arange(total)
    if merge_landmarks and N > 1:
        # greedy proximity union onto the earliest agent's landmark
        from scipy.spatial import cKDTree
        for a in range(1, N):
            base_pts = points[:offsets[a]]
            if not len(base_pts):
                continue
            tree = cKDTree(base_pts)
            mine = points[offsets[a]:offsets[a] + len(all_pts[a])]
            dist, idx = tree.query(mine, distance_upper_bound=merge_radius)
            for i, (dd, j) in enumerate(zip(dist, idx)):
                if np.isfinite(dd):
                    remap[offsets[a] + i] = remap[j]
        # compact ids
        used = np.unique(remap)
        compact = -np.ones(total, dtype=np.int64)
        compact[used] = np.arange(len(used))
        remap = compact[remap]
        points = points[used]
        colors = colors[used] if colors is not None else None

    out.points3D = points
    out.point_colors = colors

    # --- per-step structures ---
    out.point3D_added_idxs = []
    out.odometry = []
    out.odometry_assocs = []
    seen = np.zeros(len(points), dtype=bool)
    for s in range(S):
        added = []
        for a, d in enumerate(datas):
            if s < d.nr_steps:
                for idx in d.point3D_added_idxs[s]:
                    g = int(remap[offsets[a] + idx])
                    if not seen[g]:
                        seen[g] = True
                        added.append(g)
        out.point3D_added_idxs.append(added)

        odos, oassocs = [], []
        for a, d in enumerate(datas):
            if s < len(d.odometry_assocs):
                T = agent_transforms[a]
                for M, (fc, ff, tc, tf) in zip(d.odometry[s],
                                               d.odometry_assocs[s]):
                    # relative measurements are frame-local: unchanged by a
                    # global agent transform
                    odos.append(M)
                    oassocs.append((a, ff, a, tf))
        for co in cross_odometry:
            if co.step == s:
                odos.append(np.asarray(co.measured))
                oassocs.append((co.from_agent, co.from_frame,
                                co.to_agent, co.to_frame))
                if co.sigmas is not None:
                    out.odometry_noise[co.from_agent][co.to_agent] = \
                        ba_info.NoiseModel.diagonal(co.sigmas)
        out.odometry.append(odos)
        out.odometry_assocs.append(oassocs)

    # --- per-agent observations + poses ---
    out.points2D = []
    out.point2D3D_assocs = []
    out.poses = []
    for a, d in enumerate(datas):
        frames = [np.asarray(fr).reshape(-1, 2) for fr in d.points2D[0]]
        frames += [np.zeros((0, 2))] * (S - len(frames))
        out.points2D.append(frames)
        assocs = []
        for s in range(S):
            if s < len(d.point2D3D_assocs[0]):
                arr = np.asarray(d.point2D3D_assocs[0][s],
                                 dtype=np.int64).reshape(-1, 3).copy()
                if len(arr):
                    arr[:, 2] = remap[offsets[a] + arr[:, 2]]
                assocs.append(arr)
            else:
                assocs.append(np.zeros((0, 3), np.int64))
        out.point2D3D_assocs.append(assocs)
        T = agent_transforms[a]
        poses = []
        for s in range(S):
            node = d.poses[0][s] if s < len(d.poses[0]) else None
            if node is None:
                poses.append(None)
            else:
                W, t = node
                poses.append((T @ W, t))
        out.poses.append(poses)
    return out
