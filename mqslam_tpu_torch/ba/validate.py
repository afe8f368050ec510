"""Structural validation of BA data: integrity + observability counting.

Python equivalents of the reference's defensive checks
(reference: Work/SLAM/tools/bundle_adjustment/DataStructures.hpp:94-164
validateDataIntegrity; bundle_adjust.cpp:42-177
validateDataSufficientlyConstrainted — cumulative unknowns-vs-constraints
counting per step: 3 per landmark + 6 per pose vs 2 per projection + 6 per
odometry/pose-prior + 3 per point prior; failure guarantees an
underdetermined system, success does not guarantee a determined one).
"""

import numpy as np

__all__ = ["validate_data_integrity", "validate_sufficiently_constrained",
           "ValidationError"]


class ValidationError(ValueError):
    pass


def validate_data_integrity(data):
    """Index bounds + no-future-references checks (DataStructures.hpp:94-164).

    Raises ValidationError on the first violation; returns True otherwise.
    """
    C = data.nr_cameras
    S = data.nr_steps
    P = len(data.points3D)

    if len(data.calibrations) != C or len(data.poses) != C:
        raise ValidationError("per-camera array length != nr_cameras")
    for c in range(C):
        if len(data.poses[c]) != S:
            raise ValidationError(f"poses[{c}] has {len(data.poses[c])} "
                                  f"frames, want {S}")

    added = np.zeros(P, dtype=bool)
    seen_pairs = set()  # (camera, frame, landmark) must be unique: the
    # solvers' block-Jacobi preconditioner forms the exact Schur diagonal
    # per observation (solver.py), which is only the true diagonal block
    # when each (pose, point) pair carries at most one observation.
    for s in range(S):
        for idx in data.point3D_added_idxs[s]:
            if not (0 <= idx < P):
                raise ValidationError(f"point3DAddedIdx {idx} out of range")
            if added[idx]:
                raise ValidationError(f"landmark {idx} added twice")
            added[idx] = True
        for c in range(C):
            if s < len(data.point2D3D_assocs[c]):
                for (f, p2, p3) in data.point2D3D_assocs[c][s]:
                    if not (0 <= f < S):
                        raise ValidationError(f"assoc frame {f} out of range")
                    if f > s:
                        raise ValidationError(
                            f"assoc at step {s} references future frame {f}"
                            " (DataStructures.hpp:139)")
                    if not (0 <= p2 < len(data.points2D[c][f])):
                        raise ValidationError(
                            f"point2D idx {p2} out of range for frame {f}")
                    if not (0 <= p3 < P) or not added[p3]:
                        raise ValidationError(
                            f"assoc references landmark {p3} not yet added"
                            " (DataStructures.hpp:156-158)")
                    if (c, f, p3) in seen_pairs:
                        raise ValidationError(
                            f"duplicate observation of landmark {p3} in "
                            f"camera {c} frame {f}: one observation per "
                            "(pose, point) pair required")
                    seen_pairs.add((c, f, p3))
        if s < len(data.odometry_assocs):
            for k, (fc, ff, tc, tf) in enumerate(data.odometry_assocs[s]):
                for (cc, f) in ((fc, ff), (tc, tf)):
                    if not (0 <= cc < C and 0 <= f < S):
                        raise ValidationError(
                            f"odometry assoc ({fc},{ff})->({tc},{tf}) "
                            "out of range")
                    if f > s:
                        raise ValidationError(
                            f"odometry at step {s} references future frame "
                            f"{f}")
            if len(data.odometry[s]) != len(data.odometry_assocs[s]):
                raise ValidationError(
                    f"odometry/assoc count mismatch at step {s}")
    return True


def validate_sufficiently_constrained(data, use_odometry=True,
                                      warn=print):
    """Cumulative observability counting (bundle_adjust.cpp:42-177).

    Returns True when constraints >= unknowns at every step; emits a warning
    per violating step and returns False otherwise.
    """
    C = data.nr_cameras
    S = data.nr_steps
    valid = True
    num_unknowns = 0
    num_constraints = 0

    for s in range(S):
        num_unknowns += 3 * len(data.point3D_added_idxs[s])
        for c in range(C):
            if data.poses[c][s] is not None:
                num_unknowns += 6
        if s == 0:
            for c in range(C):
                if data.poses[c][0] is not None:
                    num_constraints += 6  # pose prior
                num_constraints += 3 * len(data.point2D3D_assocs[c][0])
        for c in range(C):
            if s < len(data.point2D3D_assocs[c]):
                num_constraints += 2 * len(data.point2D3D_assocs[c][s])
        if use_odometry and s < len(data.odometry_assocs):
            num_constraints += 6 * len(data.odometry_assocs[s])
        if num_unknowns > num_constraints:
            valid = False
            warn(f"Warning: num_unknowns ({num_unknowns}) > "
                 f"num_constraints ({num_constraints}) at step {s}")
    return valid
