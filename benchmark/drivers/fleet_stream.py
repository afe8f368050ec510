"""Driver: a fleet of drones streamed frame-group by frame-group.

The program's multi-quadrotor path, ``frontend/tracker.py::
make_multi_agent_runner`` (``collect=True``, as a fleet that keeps its
per-agent BA data runs it): each call is handed one frame-group, the
two-frame slice ``[A, 2, H, W]`` of 8-bit frames on the host, with the
states and one ``torch.Generator`` carried across calls, and the group's
poses are read to the host before the next group is handed over (a closed
loop).  Every agent flies its own closed circuit (``traffic/plane.py``),
bootstrapped from frame 0 of its lap by the program's ``bootstrap``; at the
end of a lap every agent starts its next flight from a fresh copy of that
bootstrap state (the state made in set-up is never handed to the
program).

A frame's latency runs from the hand-over of its group to its pose on the
host; ``frames_per_s`` is every frame handed over in the window over the
window's time, which ends at the first group boundary after the given
seconds.

For the comparison, the groups to judge (one in every ``judge_every``, at
positions drawn from the seed before the window) are copied on the device
as they pass: the states handed in, the outputs and the landmark store
after, so that nothing the program later does in place changes what is
judged.  The runner's outputs are read by the names its docstring gives
them (``OUTPUTS``).
"""

import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import frontend as ref
from benchmark.reference import geometry
from benchmark.traffic import plane

__all__ = ["Cell", "make_cal", "tracker_config", "init_points",
           "bootstrap_agent", "record_calls", "case_from_state", "OUTPUTS",
           "clone"]


NUMBERS = ref.NUMBERS + ("bootstrap_gap_px",)

# ``make_multi_agent_runner(collect=True)``'s per-frame outputs, in the
# order its docstring names them
OUTPUTS = ("accepted", "rvec", "tvec", "cur_uv", "track_alive",
           "track_triangulated", "new_landmarks", "pnp_inlier", "objp_idx")


def clone(x):
    """A copy on the same device of a tensor or a tuple of tensors."""
    if torch.is_tensor(x):
        return x.detach().clone()
    return type(x)(*(clone(y) for y in x)) if hasattr(x, "_fields") \
        else type(x)(clone(y) for y in x)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def make_cal(camera, device):
    from mqslam_tpu_torch import convert
    return convert.cal_from_numpy(
        [camera["fx"], camera["fy"], 0.0, camera["cx"], camera["cy"],
         0, 0, 0, 0], device=device)


def tracker_config(config):
    from mqslam_tpu_torch.frontend import tracker as trk
    return trk.TrackerConfig(**config["tracker"])


def init_points(frame0, centre0, camera, traffic, device):
    """Frame 0's 2D-3D correspondences: the program's corner detector
    picks the points, the benchmark's plane gives their 3D positions."""
    from mqslam_tpu_torch.ops import features
    img0 = frame0.to(device=device, dtype=torch.float32)
    H, W = img0.shape
    cells = -(-H // 14) * -(-W // 14)
    uv, valid = features.detect_corners(img0, max_corners=min(160, cells),
                                        cell=14)
    uv = uv[valid][:traffic["init_points"]].cpu().numpy().astype(np.float32)
    objp = plane.backproject(uv, centre0, camera,
                             traffic["plane_z"]).astype(np.float32)
    return uv, objp


def bootstrap_agent(frame0, centre0, camera, traffic, config, cal, device):
    """The program's bootstrap on frame 0 from ``init_points``: (state, the
    bootstrap's pairs and the true pose, for ``reference.frontend.
    bootstrap_gap``; the program's pose is added by the caller)."""
    from mqslam_tpu_torch.frontend import tracker as trk
    uv, objp = init_points(frame0, centre0, camera, traffic, device)
    state = trk.bootstrap(uv, objp, cal, frame0.to(torch.float32), config,
                          device=device)
    return state, boot_case(uv, objp, centre0)


def boot_case(uv, objp, centre0):
    """The bootstrap's pairs and the true world-to-camera pose (axes
    aligned with the world's, at ``centre0``)."""
    return dict(uv=np.asarray(uv, np.float64),
                objp=np.asarray(objp, np.float64), R_true=np.eye(3),
                t_true=-np.asarray(centre0, np.float64))


class record_calls:
    """Within the ``with`` block, ``module.<name>`` records what each call
    is handed (``what(*args, **kw)`` -> dict) before it runs."""

    def __init__(self, module, name, what):
        self.module, self.name, self.what = module, name, what
        self.calls = []

    def __enter__(self):
        self.real = real = getattr(self.module, self.name)

        def recorder(*args, **kw):
            self.calls.append(self.what(*args, **kw))
            return real(*args, **kw)
        setattr(self.module, self.name, recorder)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def k1_call(imgJ, imgI, cJ, cI, aJ, a0, valid, A, win, iters, eps, hiX,
            **kw):
    return dict(kernel="K1", numel=imgJ.numel(), px=imgJ.element_size(),
                tracks=int(cJ.shape[0]), valid=valid, win=int(win),
                hiX=float(hiX))


def _rot(rvec):
    return geometry.rodrigues(torch.as_tensor(rvec, dtype=torch.float64))


def case_from_state(prev_img, new_img, s0, out, objp_after):
    """One agent's case (``reference/frontend.py``) from the tracker state
    the program went into the frame with, its outputs for the frame (a
    mapping of ``OUTPUTS``' names, as ``StepOutput`` names them) and its
    landmark store after it; host tensors of one agent."""
    lm = s0.objp[s0.objp_idx.long()]
    lm = torch.where(s0.triangulated[:, None], lm, torch.zeros_like(lm))
    return ref.case_from_arrays(
        prev_img, new_img, s0.cur_uv, s0.active, s0.triangulated, lm,
        out["pnp_inlier"], s0.base_uv, (_rot(s0.rvec), s0.tvec),
        (_rot(s0.rvec_keyfr), s0.tvec_keyfr), s0.n_objp,
        dict(accepted=out["accepted"], uv=out["cur_uv"],
             alive=out["track_alive"], R=_rot(out["rvec"]), t=out["tvec"],
             new=out["new_landmarks"],
             new_X=objp_after[out["objp_idx"].long()]))


def judge_positions(seed, every, n=1 << 16):
    """Which of the first ``n`` groups (or frames) are judged: one in
    every ``every``, at a position in each block drawn from the seed."""
    rng = np.random.RandomState(seed % (2 ** 32))
    return set((np.arange(n // every) * every
                + rng.randint(every, size=n // every)).tolist())


def keyframe_shares(acc):
    """(share of frames, share of groups holding one) that keyframed, of
    accept flags [groups, agents]."""
    kf = np.asarray(acc) == 2
    return float(kf.mean()), float(kf.any(axis=1).mean())


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.device = ctx.device
        self.camera = ctx.config["camera"]
        self.traffic = ctx.traffic
        self.limits = ctx.workload["limits"]

    # ---- set-up: traffic, the program's state, warm-up ----
    def setup(self):
        from mqslam_tpu_torch.frontend import tracker as trk
        dev, tr = self.device, self.traffic
        self.config = tracker_config(self.ctx.config)
        A = int(tr["agents"])
        self.frames, self.centres = plane.stream(tr, self.camera,
                                                 self.ctx.seed, A, dev)
        self.lap = self.frames.shape[1] - 1
        cal = make_cal(self.camera, dev)
        states, self.boots = zip(*[bootstrap_agent(
            self.frames[a, 0], self.centres[a, 0], self.camera, tr,
            self.config, cal, dev) for a in range(A)])
        # the bootstrap states, never handed to the program: every flight
        # starts from a fresh copy
        self.init = trk.TrackerState(*(torch.stack(x) for x in zip(*states)))
        for b, s in zip(self.boots, states):
            b.update(R=_rot(s.rvec.cpu()).numpy(), t=s.tvec.cpu().numpy())
        self.run = trk.make_multi_agent_runner(cal, self.config,
                                               collect=True, device=dev)
        # warm-up: from the bootstrap until a keyframe group has run
        gen = torch.Generator(device=dev).manual_seed(self.ctx.seed + 1)
        st = clone(self.init)
        for f in range(int(tr["warmup_max_groups"])):
            st, outs = self.run(st, self.frames[:, f:f + 2], generator=gen)
            if f + 1 >= int(tr["warmup_groups"]) and bool(
                    (outs[OUTPUTS.index("accepted")] == 2).any()):
                break
        sync(dev)

    # ---- the measured window ----
    def window(self, seconds, traced=False):
        """Groups until the first boundary after ``seconds``; the state
        and outputs of one group in every ``judge_every`` (at positions
        drawn from the seed before the window) are copied for the
        comparison."""
        dev, A = self.device, self.frames.shape[0]
        gen = torch.Generator(device=dev).manual_seed(self.ctx.seed)
        judged = judge_positions(self.ctx.seed,
                                 int(self.traffic["judge_every"]))
        states, f = clone(self.init), 0
        lat, acc, kept, stages = [], [], [], []
        sync(dev)
        t_first = t_prev = time.perf_counter()
        deadline = t_first + seconds
        g = 0
        while True:
            if f == self.lap:
                states, f = clone(self.init), 0
            before = clone(states) if g in judged else None
            sm = {} if traced else None
            states, outs = self.run(states, self.frames[:, f:f + 2],
                                    generator=gen, stage_ms=sm)
            outs = dict(zip(OUTPUTS, outs))
            if before is not None:
                kept.append((f, before, clone(tuple(outs.values())),
                             clone(states.objp)))
            host = torch.cat([
                outs["accepted"].reshape(-1).to(torch.float32),
                outs["rvec"].reshape(-1), outs["tvec"].reshape(-1)]).cpu()
            t = time.perf_counter()
            lat.append(t - t_prev)
            t_prev = t
            acc.append(host[:A].numpy().astype(np.int64))
            if traced:
                stages.append(sm)
            f += 1
            g += 1
            if t >= deadline:
                break
        self.last = states
        self.window_f = f
        self.kept = kept
        n = len(lat)
        acc = np.stack(acc)
        kf, kf_groups = keyframe_shares(acc)
        out = dict(t_first=t_first, attempted=n * A,
                   failed=int((acc == 0).sum()),
                   metrics=dict(frames_per_s=n * A / (t_prev - t_first),
                                frame_p90_ms=harness.percentile(lat, 90)
                                * 1e3),
                   traffic=dict(keyframe_share=kf,
                                keyframe_group_share=kf_groups))
        if traced:
            out["trace"] = dict(stage_ms=stages)
        return out

    # ---- the traced sub-window ----
    def profile_steps(self, on, off):
        """A few frame-groups after the window, from its last state; K1's
        calls recorded."""
        from mqslam_tpu_torch.ops import lk_tile
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(self.ctx.seed + 2)
        states, f = self.last, self.window_f
        on()
        with record_calls(lk_tile, "lk_level", k1_call) as calls:
            for _ in range(int(self.traffic["profile_groups"])):
                if f == self.lap:
                    states, f = clone(self.init), 0
                states, outs = self.run(states, self.frames[:, f:f + 2],
                                        generator=gen)
                outs[OUTPUTS.index("rvec")].cpu()
                f += 1
        off()
        return dict(lk_calls=calls)

    def release(self):
        """Drop the program's objects; the kept groups become cases."""
        self.cases = [c for k in self.kept for c in self._cases(*k)]
        self.kept = self.run = self.init = self.last = None

    def _cases(self, f, s0, outs, objp_after):
        to = lambda x: x.detach().cpu()
        s0 = type(s0)(*(to(x) for x in s0))
        objp1 = to(objp_after)
        outs = {k: to(x[0]) for k, x in zip(OUTPUTS, outs)}
        return [case_from_state(
            self.frames[a, f], self.frames[a, f + 1],
            type(s0)(*(x[a] for x in s0)),
            {k: x[a] for k, x in outs.items()}, objp_after=objp1[a])
            for a in range(self.frames.shape[0])]

    # ---- the comparison with the plain reference ----
    def judge(self):
        r = ref.judge(self.cases, self.camera, self.ctx.config["tracker"],
                      self.device)
        r["bootstrap_gap_px"] = ref.bootstrap_gap(self.boots, self.camera,
                                                  self.device)
        return [(k, r[k], self.limits[k]) for k in NUMBERS]

    def control(self):
        """The same numbers for the lower-precision control's answers."""
        tracker = self.ctx.config["tracker"]
        r = ref.judge(self.cases, self.camera, tracker, self.device,
                      answers=ref.control_answers(self.cases, self.camera,
                                                  tracker, self.device))
        r["bootstrap_gap_px"] = ref.bootstrap_gap(
            self.boots, self.camera, self.device, dtype=torch.bfloat16)
        return [(k, r[k]) for k in NUMBERS]
