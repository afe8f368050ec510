"""Driver: one flight's map refined by batch bundle adjustment, job after
job.

The program's offline back end, ``cli/ba_run.py::refine`` in mode 0 (the
dense-Schur float32 LM on the card, then the float64 ``polish64`` on the
host), as ``ba_run`` runs it after a flight: each job hands over a
``BAData`` on the host and ends when the refined poses and landmarks are on
the host; the next job is handed over at once (a closed loop, one job in
flight).  The dump (``config["dump"]``) is loaded once in set-up, and every
job starts from its front-end estimate as dumped; the seed picks which jobs
are judged.  ``traffic["steps"]`` cuts the flight to its first steps (the
tests' tiny cell; null: the whole dump).  The traffic line counts each
job's LM outer iterations and polish iterations from ``refine``'s two
histories (attempts are ``lm_attempts.ba``'s, in a traced run).

``frames_per_s`` is the flight's frames refined per second: frames x jobs
over the window, which ends at the first job boundary after the given
seconds at which a judged job has run.  NumPy's BLAS pool is held to one
thread from set-up to release, as the harness holds torch to one: the
polish's products then do not spread with the host's load.
``threadpoolctl`` is not among the benchmark's dependencies, so
``one_blas_thread`` does what it does for NumPy's own OpenBLAS: calls the
library's ``set_num_threads`` through ``ctypes``.

For the comparison, one job in every ``judge_every`` (at positions drawn
from the seed before the window) keeps its answer; after the window the
plain reference (``reference/ba.py``) solves the dump from its start over
the whole graph once (``start_optimum``) and judges each kept answer.
``correct`` holds the LM's float32: the float64 finish lies below what
the determined map can show (``PERF.md`` §2), so a program without it
is not told apart, and the control is the reference's LM in bfloat16.
"""

import ctypes
import dataclasses
import glob
import os
import statistics
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import ba as ref

__all__ = ["Cell", "load_dump", "prefix", "judge_positions",
           "one_blas_thread", "NUMBERS"]

NUMBERS = ("cost_excess_rel", "cost_gap_rel", "center_gap_m", "rot_gap_rad",
           "point_gap_rel")


def one_blas_thread():
    """Hold NumPy's OpenBLAS (the library its wheel bundles beside it) to
    one thread; returns the call that restores the number it had."""
    libs = glob.glob(os.path.join(os.path.dirname(np.__file__) + ".libs",
                                  "*openblas*"))
    for path in libs:
        lib = ctypes.CDLL(path)
        # NumPy 2's wheels bundle scipy-openblas, NumPy 1's openblas64_
        for pre, post in (("scipy_", "64_"), ("", "64_")):
            get = getattr(lib, f"{pre}openblas_get_num_threads{post}", None)
            put = getattr(lib, f"{pre}openblas_set_num_threads{post}", None)
            if get is not None and put is not None:
                get.restype, put.argtypes = ctypes.c_int, [ctypes.c_int]
                before = get()
                put(1)
                return lambda: put(before)
    raise RuntimeError(f"no OpenBLAS beside NumPy {np.__version__} "
                       f"({np.__file__})")


def load_dump(dump):
    """The configuration's dump as a host ``BAData``."""
    from mqslam_tpu_torch.io import ba_info
    return ba_info.load_ba_data(os.path.join(harness.ROOT, dump["dir"]),
                                dump["name"], int(dump["cameras"]),
                                int(dump["fps"]))


def prefix(data, steps):
    """``data`` cut to its first ``steps`` steps (landmarks kept whole:
    those added later are not optimized)."""
    S = steps
    return dataclasses.replace(
        data, poses=[p[:S] for p in data.poses],
        point3D_added_idxs=data.point3D_added_idxs[:S],
        points2D=[p[:S] for p in data.points2D],
        point2D3D_assocs=[a[:S] for a in data.point2D3D_assocs],
        odometry=data.odometry[:S], odometry_assocs=data.odometry_assocs[:S])


def judge_positions(seed, every, n=1 << 12):
    """Which of the first ``n`` jobs are judged: one in every ``every``,
    at a position in each block drawn from the seed."""
    rng = np.random.default_rng(seed + 7)
    return set((np.arange(n // every) * every
                + rng.integers(every, size=n // every)).tolist())


def _spread(values):
    return dict(min=min(values), median=statistics.median(values),
                max=max(values)) if values else None


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.device = ctx.device
        self.traffic = ctx.traffic
        self.limits = ctx.workload["limits"]
        self.rule = ctx.workload["judge"]
        self.blas = self.optimum = None

    # ---- set-up: the dump, a warm-up job ----
    def setup(self):
        from mqslam_tpu_torch.cli.ba_run import refine
        self.refine = refine
        self.blas = one_blas_thread()
        data = load_dump(self.ctx.config["dump"])
        if self.traffic.get("steps"):
            data = prefix(data, int(self.traffic["steps"]))
        self.data = data
        self.frames = sum(n is not None for p in data.poses for n in p)
        for _ in range(int(self.traffic["warmup_jobs"])):
            self._job()

    def _job(self):
        """One refine of the dump: (its answer on the host, LM outer
        iterations, polish iterations)."""
        v, hist, hist64 = self.refine(self.data, mode=0, device=self.device)
        return (torch.cat([v.pose_r, v.pose_t, v.points]).cpu(),
                len(hist) - 1, len(hist64) - 1)

    # ---- the measured window ----
    def window(self, seconds, traced=False):
        judged = judge_positions(self.ctx.seed,
                                 int(self.traffic["judge_every"]))
        self.kept = []
        iters = []
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t_first = time.perf_counter()
        deadline = t_first + seconds
        j = 0
        while True:
            answer, lm, polish = self._job()
            t = time.perf_counter()
            iters.append((lm, polish))
            if j in judged:
                self.kept.append(answer)
            j += 1
            if t >= deadline and self.kept:
                break
        return dict(
            t_first=t_first, attempted=j, failed=0,
            metrics=dict(frames_per_s=self.frames * j / (t - t_first)),
            traffic=dict(
                jobs=j, lm_iterations=_spread([x[0] for x in iters]),
                polish_iterations=_spread([x[1] for x in iters])))

    # ---- the traced sub-window ----
    def profile_steps(self, on, off):
        """``profile_jobs`` jobs after the window's, under the profiler
        (which turns the program's spans on)."""
        n = int(self.traffic["profile_jobs"])
        on()
        for _ in range(n):
            self._job()
        off()
        return dict(jobs=n)

    def release(self):
        """Drop the program's objects; restore the BLAS pool."""
        if self.blas is not None:
            self.blas()
        self.refine = self.blas = None

    # ---- the comparison with the plain reference ----
    def _answer(self, flat):
        F = sum(len(p) for p in self.data.poses)
        flat = flat.to(torch.float64)
        return (ref.exp_so3(flat[:F]), flat[F:2 * F], flat[2 * F:])

    def _gaps(self, answers):
        if self.optimum is None:
            self.optimum = ref.start_optimum(self.data, self.device)
        worst = dict.fromkeys(NUMBERS, -float("inf"))
        for answer in answers:
            r = ref.gaps(self.data, answer, self.device, self.optimum,
                         min_obs=int(self.rule["min_obs"]),
                         max_rel_sigma=float(self.rule["max_rel_sigma"]))
            for k in NUMBERS:
                worst[k] = max(worst[k], r[k])
        return worst

    def judge(self):
        r = self._gaps([self._answer(a) for a in self.kept])
        return [(k, r[k], self.limits[k]) for k in NUMBERS]

    def control(self):
        """The same numbers for the control: the reference's own LM in
        bfloat16, the precision below the LM's float32, from the dump's
        start, with no float64 finish."""
        r = self._gaps([ref.control_answer(self.data, self.device,
                                           dtype=torch.bfloat16)])
        return [(k, r[k]) for k in NUMBERS]
