"""Driver: a fleet's merged map refined by the sharded bundle adjustment
over a group of ranks, one card a rank, job after job.

The program's multi-agent back end as ``cli/collab_demo.py`` and
``parallel/dryrun.py`` run it after the fleet lands: the fleet runner
(``make_multi_agent_runner(collect=True)``) tracks every agent's flight,
``fleet_dump.ba_data_from_scan`` rebuilds each agent's dump,
``merge_agents`` joins them with rendezvous cross-factors, and each job
builds the merged problem on every rank's device
(``problem_from_ba_data(pad_multiple=world)``) and solves it with
``sharded_lm_solve`` over the group, each rank holding its block of the
observation rows; rank 0 reads the answer to the host, and the next job
starts at once (a closed loop, one job in flight), every job from the
merged dump's front-end estimate.

This process is rank 0, on the harness's device.  Ranks 1 .. world - 1
are helper processes that the driver starts in set-up
(``python3 benchmark/drivers/joint_refine.py --rank r ...``, device
``cuda:r``, or the CPU with gloo): each receives the merged dump on its
standard input (a length-prefixed pickle written by rank 0), joins the
group, and then runs one job for every ``job`` line rank 0 writes there,
until ``stop``.  Every rank hashes the dump it holds and the hashes are
compared.  A helper checks before it exits that it loaded neither JAX
nor the JAX package.  Every collective, the group's start and the
helpers' exit are bounded by ``TIMEOUT_S``: a fault on any rank ends the
run with a non-zero exit, and rank 0 kills what is left of the helpers
on its way out.

``frames_per_s`` is the fleet's frames flown (agents x ``lap_frames``)
times the jobs completed, over the window, which ends at the first job
boundary after the given seconds at which a judged job has run.  One job
in every ``judge_every`` (at positions drawn from the seed before the
window) keeps rank 0's answer, and every rank's answer is compared with
rank 0's on the device (``rank_gap``, the largest difference).  After the
window the plain reference (``reference/ba_joint.py``) solves the merged
dump from its start once (``start_optimum``) and judges each kept answer
as ``ba_refine.py`` does; the control is the reference's LM in bfloat16.
"""

import argparse
import atexit
import hashlib
import inspect
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import torch

if __name__ == "__main__":       # a helper rank, started as a script
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402
from benchmark.drivers import fleet_stream  # noqa: E402
from benchmark.drivers.ba_refine import (NUMBERS, _spread,  # noqa: E402
                                         judge_positions)
from benchmark.traffic import plane  # noqa: E402

__all__ = ["Cell", "helper_main", "make_dump", "rendezvous", "job",
           "TIMEOUT_S"]

TIMEOUT_S = 120.0
ABORT_S = 10.0


def _flat(v):
    return torch.cat([v.pose_r.reshape(-1), v.pose_t.reshape(-1),
                      v.points.reshape(-1)])


def digest(blob):
    """The first 8 bytes of the SHA-256 of ``blob``, as an int64 tensor."""
    return torch.tensor(int.from_bytes(hashlib.sha256(blob).digest()[:8],
                                       "little", signed=True))


def rendezvous(centres, every, sigmas, seed):
    """Cross-factors between agents a and a + 1 at every ``every``-th
    frame: their cameras' relative pose (cam-to-world convention, axes
    aligned with the world's) from the true centres [A, N, 3], perturbed
    by half of ``sigmas`` (rad, m) a component from the seed."""
    from mqslam_tpu_torch.multiagent import CrossOdometry
    from mqslam_tpu_torch.multiagent.fleet_dump import rodrigues
    rng = np.random.RandomState((int(seed) + 3) % (2 ** 32))
    sig = np.asarray(sigmas, np.float64)
    cross = []
    for f in range(0, centres.shape[1], every):
        for a in range(centres.shape[0] - 1):
            meas = np.eye(4)
            meas[:3, 3] = centres[a + 1, f] - centres[a, f]
            D = np.eye(4)
            D[:3, :3] = rodrigues(0.5 * sig[:3] * rng.randn(3))
            D[:3, 3] = 0.5 * sig[3:] * rng.randn(3)
            cross.append(CrossOdometry(
                step=f, from_agent=a, from_frame=f, to_agent=a + 1,
                to_frame=f, measured=meas @ D, sigmas=sig))
    return cross


def make_dump(config, traffic, seed, device):
    """The fleet's flight and its merged dump: (merged ``BAData``, figures
    of the flight).  The frames are rendered from the seed
    (``traffic/plane.py``), every agent bootstrapped on its frame 0 and
    tracked by the program's fleet runner one frame-group a call, each
    agent's dump rebuilt, and the dumps merged with ``rendezvous``."""
    from mqslam_tpu_torch.frontend import tracker as trk
    from mqslam_tpu_torch.multiagent import (ba_data_from_scan,
                                             merge_agents, scan_to_host)
    camera, A = config["camera"], int(traffic["agents"])
    tcfg = fleet_stream.tracker_config(config)
    frames, centres = plane.stream(traffic, camera, seed, A, device)
    cal = fleet_stream.make_cal(camera, device)
    states = [fleet_stream.bootstrap_agent(
        frames[a, 0], centres[a, 0], camera, traffic, tcfg, cal, device)[0]
        for a in range(A)]
    init = trk.TrackerState(*(torch.stack(x) for x in zip(*states)))
    run = trk.make_multi_agent_runner(cal, tcfg, collect=True,
                                      device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    st, outs = fleet_stream.clone(init), []
    for f in range(frames.shape[1] - 1):
        st, out = run(st, frames[:, f:f + 2], generator=gen)
        outs.append(out)
    outs = tuple(torch.cat(x) for x in zip(*outs))
    h_init, h_final, h_outs = scan_to_host(init, st, outs)
    fps = float(camera["fps"])
    datas = [ba_data_from_scan(h_init, h_final, h_outs, cal, a, fps=fps)
             for a in range(A)]
    ren = config["rendezvous"]
    cross = rendezvous(centres, int(ren["every_frames"]),
                       list(ren["sigmas_rad_m"]), seed)
    merged = merge_agents(datas, cross_odometry=cross,
                          merge_landmarks=bool(config["merge_landmarks"]))
    acc = h_outs[0]
    return merged, dict(
        agents=A, frames=int(acc.size), rejected=int((acc == 0).sum()),
        keyframe_share=float((acc == 2).mean()),
        agent_landmarks=[int(n) for n in h_final.n_objp],
        store_full=bool((h_final.n_objp >= tcfg.max_landmarks).any()),
        cross_factors=len(cross))


def job(merged, group, device, solver, max_iters=None):
    """One refine of the merged dump over ``group``: the problem built on
    this rank's device, the sharded LM (``max_iters`` outer iterations at
    most, the solver's by default); (v, history)."""
    from mqslam_tpu_torch.ba import problem as bp
    from mqslam_tpu_torch.parallel import sharded_ba
    world = torch.distributed.get_world_size(group)
    prob = bp.problem_from_ba_data(merged, pad_multiple=world,
                                   device=device)
    return sharded_ba.sharded_lm_solve(
        prob, group, max_iters=int(max_iters or solver["max_iters"]),
        cg_iters=int(solver["cg_iters"]), cg_tol=float(solver["cg_tol"]),
        rtol=float(solver["rtol"]), layout=solver["layout"])


def _rank_gap(v, group, device):
    """The largest difference of any rank's answer from rank 0's (a
    0-dim tensor on ``device``, the same on every rank)."""
    import torch.distributed as dist
    mine = _flat(v).to(device)
    zero = mine.clone()
    dist.broadcast(zero, 0, group=group)
    gap = torch.max(torch.abs(mine - zero)).reshape(1)
    gap = torch.where(torch.isnan(gap), torch.inf, gap)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX, group=group)
    return gap[0]


def _peaks(group, device):
    """Every rank's peak device memory (bytes), on every rank."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    mine = torch.tensor([torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0],
                        dtype=torch.int64, device=device)
    out = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(out, mine, group=group)
    return [int(x) for x in out]


def _check_digests(blob, group, device):
    import torch.distributed as dist
    world = dist.get_world_size(group)
    mine = digest(blob).reshape(1).to(device)
    out = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(out, mine, group=group)
    if len({int(x) for x in out}) != 1:
        raise RuntimeError("the ranks hold different merged dumps")


def _leave_group(seconds):
    """Destroy the default group, if any, in a thread given ``seconds``:
    True once it is gone."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return True
    t = threading.Thread(target=dist.destroy_process_group, daemon=True)
    t.start()
    t.join(seconds)
    return not t.is_alive()


def _device(kind, rank):
    if kind == "cuda":
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    torch.set_num_threads(1)
    return torch.device("cpu")


def helper_main(argv=None):
    """A helper rank: the dump from standard input, the group, a job for
    every ``job`` line until ``stop``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    args = ap.parse_args(argv)
    import torch.distributed as dist
    from mqslam_tpu_torch.parallel import multihost
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = _device(args.device, args.rank)
    inp = sys.stdin.buffer
    head = inp.read(8)
    if len(head) < 8:
        return 1                     # rank 0 ended before handing over
    blob = inp.read(int.from_bytes(head, "little"))
    merged, solver = pickle.loads(blob)
    multihost.initialize(f"tcp://127.0.0.1:{args.port}", args.world,
                         args.rank, backend=multihost.backend_for(device),
                         timeout_s=TIMEOUT_S)
    group = dist.group.WORLD
    try:
        _check_digests(blob, group, device)
        for line in iter(inp.readline, b""):
            cmd = line.split()
            if cmd[0] == b"job":
                v, _ = job(merged, group, device, solver)
                if cmd[1] == b"1":
                    _rank_gap(v, group, device)
            elif cmd[0] == b"probe":
                job(merged, group, device, solver, max_iters=1)
            elif cmd[0] == b"peaks":
                _peaks(group, device)
            elif cmd[0] == b"stop":
                break
    finally:
        dist.destroy_process_group()
    found = harness.forbidden_modules()
    if found:
        print("joint_refine: rank {}: JAX or the JAX package was loaded: "
              "{}".format(args.rank, ", ".join(found)), file=sys.stderr)
        return 3
    return 0


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.device = ctx.device
        self.traffic = ctx.traffic
        self.limits = ctx.workload["limits"]
        self.rule = ctx.workload["judge"]
        self.world = int(ctx.spec["cell"]["chips"])
        self.helpers, self.group, self.optimum = [], None, None

    # ---- the helper ranks ----
    def helper_command(self, rank, port):
        """The command that starts helper rank ``rank``."""
        return [sys.executable, os.path.abspath(__file__), "--rank",
                str(rank), "--world", str(self.world), "--port", str(port),
                "--device", self.device.type]

    def _send(self, line):
        for p in self.helpers:
            p.stdin.write(line)
            p.stdin.flush()

    def _kill(self):
        for p in self.helpers:
            if p.poll() is None:
                p.kill()
            p.wait(TIMEOUT_S)
        self.helpers = []

    def _abort(self):
        """Kill the helpers and leave the group: the teardown, which may
        wait for the ranks just killed, gets ``ABORT_S`` in a thread of its
        own before the fault goes on up."""
        self._kill()
        self.group = None
        _leave_group(ABORT_S)

    # ---- set-up: the flight, the merged dump, the group, a warm-up ----
    def setup(self):
        import torch.distributed as dist
        from mqslam_tpu_torch.parallel import multihost, sharded_ba
        missing = {"rtol", "cg_tol"} - set(inspect.signature(
            sharded_ba.sharded_lm_solve).parameters)
        if missing:
            raise RuntimeError("the program's sharded_lm_solve takes no "
                               + " or ".join(sorted(missing)))
        cfg = self.ctx.config
        self.solver = dict(cfg["solver"])
        port = multihost.free_port()
        atexit.register(self._kill)
        self.helpers = [subprocess.Popen(
            self.helper_command(r, port), stdin=subprocess.PIPE,
            stdout=sys.stderr.fileno(), cwd=harness.ROOT)
            for r in range(1, self.world)]
        try:
            self.merged, self.flight = make_dump(cfg, self.traffic,
                                                 self.ctx.seed, self.device)
            blob = pickle.dumps((self.merged, self.solver))
            self._send(len(blob).to_bytes(8, "little") + blob)
            multihost.initialize(f"tcp://127.0.0.1:{port}", self.world, 0,
                                 backend=multihost.backend_for(self.device),
                                 timeout_s=TIMEOUT_S)
            self.group = dist.group.WORLD
            _check_digests(blob, self.group, self.device)
            self.frames = int(self.traffic["agents"]) * int(
                self.traffic["lap_frames"])
            for _ in range(int(self.traffic["warmup_jobs"])):
                self._job()
        except BaseException:
            self._abort()
            raise

    def _job(self, judged=False):
        """One job on every rank: (rank 0's answer on the host, outer
        iterations, the rank gap or None)."""
        self._send(b"job %d\n" % int(judged))
        v, hist = job(self.merged, self.group, self.device, self.solver)
        gap = _rank_gap(v, self.group, self.device) if judged else None
        return _flat(v).cpu(), len(hist) - 1, gap

    # ---- the measured window ----
    def window(self, seconds, traced=False):
        try:
            return self._window(seconds)
        except BaseException:
            self._abort()
            raise

    def _window(self, seconds):
        judged = judge_positions(self.ctx.seed,
                                 int(self.traffic["judge_every"]))
        self.kept, self.gaps, iters = [], [], []
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t_first = time.perf_counter()
        deadline = t_first + seconds
        j = 0
        while True:
            answer, n_it, gap = self._job(judged=j in judged)
            t = time.perf_counter()
            iters.append(n_it)
            if gap is not None:
                self.kept.append(answer)
                self.gaps.append(gap)
            j += 1
            if t >= deadline and self.kept:
                break
        self._send(b"peaks\n")
        peaks = _peaks(self.group, self.device)
        m = self.merged
        return dict(
            t_first=t_first, attempted=j, failed=0,
            metrics=dict(frames_per_s=self.frames * j / (t - t_first)),
            traffic=dict(
                jobs=j, seconds_a_job=(t - t_first) / j,
                lm_iterations=_spread(iters), ranks=self.world,
                poses=sum(p is not None for c in m.poses for p in c),
                landmarks=len(m.points3D),
                observations=int(sum(len(a) for c in m.point2D3D_assocs
                                     for a in c)),
                peak_bytes=peaks, **self.flight))

    # ---- the traced sub-window ----
    def profile_steps(self, on, off):
        """After the window, ``profile_jobs`` times each: under the
        profiler (``on`` / ``off``), a job's first outer iteration (the job
        at ``max_iters`` 1: the layout, the start's cost, a linearization
        and its attempts), which the device-trace readers take; then a
        whole job with the program's own tracing on (``utils/profiling``:
        CUDA events, no profiler) on rank 0, whose spans and counters the
        other readers take, the first iterations' dropped.  A whole job
        under the profiler is millions of events (~1,400 CG iterations of
        ~330 operators), more than a run has time to read."""
        from mqslam_tpu_torch.utils import profiling
        n = int(self.traffic["profile_jobs"])
        try:
            on()
            for _ in range(n):
                self._send(b"probe\n")
                job(self.merged, self.group, self.device, self.solver,
                    max_iters=1)
            off()
            profiling.reset()
            profiling.enable(self.device)
            for _ in range(n):
                self._job()
            profiling.disable()
        except BaseException:
            self._abort()
            raise
        return dict(jobs=n)

    def release(self):
        """Stop the helpers (each leaves the group, checks its modules and
        exits) and leave the group with them: NCCL's teardown waits for
        every rank, so rank 0 leaves before it waits for the helpers' exit.
        A teardown or a helper that has not ended ``TIMEOUT_S`` after the
        stop fails the run, the helper killed."""
        self._send(b"stop\n")
        for p in self.helpers:
            p.stdin.close()
        deadline = time.monotonic() + TIMEOUT_S
        self.group = None
        left = _leave_group(TIMEOUT_S)
        codes = []
        for p in self.helpers:
            try:
                codes.append(p.wait(max(deadline - time.monotonic(), 0.1)))
            except subprocess.TimeoutExpired:
                codes.append(None)
        self._kill()
        if not left:
            raise RuntimeError("the group's teardown did not end")
        if any(c != 0 for c in codes):
            raise RuntimeError(f"helper ranks exited with {codes}")

    # ---- the comparison with the plain reference ----
    def _graph(self):
        from benchmark.reference import ba as ref
        if self.optimum is None:
            from benchmark.reference import ba_joint
            self.g = ref.graph_from_data(self.merged, self.device)
            self.optimum = ba_joint.start_optimum(self.g, self.merged,
                                                  self.device)
        return self.g

    def _answer(self, flat):
        from benchmark.reference import ba as ref
        F = sum(len(p) for p in self.merged.poses)
        flat = flat.to(self.device, torch.float64)
        return (ref.exp_so3(flat[:3 * F].reshape(F, 3)),
                flat[3 * F:6 * F].reshape(F, 3),
                flat[6 * F:].reshape(-1, 3))

    def _worst(self, answers):
        from benchmark.reference import ba_joint
        g = self._graph()
        worst = dict.fromkeys(NUMBERS, -float("inf"))
        for answer in answers:
            r = ba_joint.gaps(g, answer, self.optimum,
                              min_obs=int(self.rule["min_obs"]),
                              max_rel_sigma=float(self.rule["max_rel_sigma"]))
            for k in NUMBERS:
                worst[k] = max(worst[k], r[k])
        return worst

    def judge(self):
        r = self._worst([self._answer(a) for a in self.kept])
        r["rank_gap"] = max(float(x) for x in self.gaps)
        return [(k, r[k], self.limits[k]) for k in NUMBERS + ("rank_gap",)]

    def control(self):
        """The same numbers for the control: the reference's LM in
        bfloat16 from the dump's start, on one device (its rank gap 0)."""
        from benchmark.reference import ba_joint
        R, c, X = ba_joint.control_answer(self._graph(), self.merged,
                                          self.device, torch.bfloat16)
        r = self._worst([tuple(x.to(torch.float64) for x in (R, c, X))])
        r["rank_gap"] = 0.0
        return [(k, r[k]) for k in NUMBERS + ("rank_gap",)]


if __name__ == "__main__":
    sys.exit(helper_main())
