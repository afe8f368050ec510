"""The joint refine cell (``drivers/joint_refine.py``) on the CPU at a tiny
size: three agents over 16 frames at 160 x 120, rendezvous every 4
frames, two gloo ranks (this process and one helper).  A sound run comes
out correct and reports its metrics, traced and not, with no helper left
behind; the control comes out not correct; so does the program broken in
every rank (``joint_faults.py``: the LM capped at 1 outer iteration,
where the sound LM accepts 2 and stops at its third by ``rtol``, a pose
moved 1 mm, a tenth of the landmarks pushed 100x out) or one rank's
answer perturbed by 1e-6 (``rank_gap``).  The readers against hand-made
totals; a program whose ``sharded_lm_solve`` takes no ``rtol`` is
refused before any helper starts."""

import copy
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import joint_faults

CELL = "euroc_joint.joint_ba_x4"
SPANS = ("layout_ms.joint", "lm_ms.joint", "step_ms.joint",
         "cost_ms.joint")


def spec():
    """The cell cut to a size a CPU test holds (same code paths), over
    two ranks."""
    s = copy.deepcopy(harness.cell_spec(CELL))
    s["cell"]["chips"] = 2
    cfg, tr = s["config"], s["workload"]["traffic"]
    cfg["camera"].update(width=160, height=120, fx=97.6, fy=97.3, cx=78.1,
                         cy=62.0)
    cfg["tracker"].update(max_tracks=64, max_landmarks=1024,
                          target_keypoints=50, ransac_hypotheses=16)
    cfg["rendezvous"]["every_frames"] = 4
    tr.update(agents=3, lap_frames=16, init_points=40)
    return s


def driver():
    return harness.load_module("drivers", "joint_refine")


def faulty_cell(kind, seed):
    """The driver's cell whose helper ranks break their program by
    ``kind`` before they start."""
    base = driver().Cell

    class Cell(base):
        def helper_command(self, rank, port):
            cmd = base.helper_command(self, rank, port)
            code = ("import sys; sys.path.insert(0, {!r}); "
                    "from benchmark.tests import joint_faults; "
                    "joint_faults.apply({!r}, {}); "
                    "from benchmark.drivers import joint_refine; "
                    "sys.exit(joint_refine.helper_main(sys.argv[1:]))"
                    ).format(harness.ROOT, kind, rank)
            return [cmd[0], "-c", code] + cmd[2:]
    return Cell(harness.Context(spec(), seed, torch.device("cpu")))


def correct(checks):
    return all(v <= lim for _, v, lim in checks)


@pytest.fixture
def profiling():
    from mqslam_tpu_torch.utils import profiling
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def read(name, trace):
    return harness.load_module("layer_metrics", name).read(trace)


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct_and_reports_its_metrics(profiling, traced):
    out, checks = harness.run_cell(spec(), 2 ** 31 + 11, 0.5, traced,
                                   torch.device("cpu"), time.perf_counter())
    assert correct(checks), checks
    c = dict((k, v) for k, v, _ in checks)
    assert c["rank_gap"] == 0.0 and c["cost_excess_rel"] < 1e-5
    t = out["traffic"]
    assert t["jobs"] == out["attempted"] >= 1 and out["failed"] == 0
    assert t["agents"] == 3 and t["frames"] == 48 and t["rejected"] == 0
    assert t["ranks"] == 2 and t["cross_factors"] == 10
    assert not t["store_full"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    if not traced:
        assert set(m) == {"frames_per_s", "setup_s"}
        return
    # the CPU trace has no NCCL kernel: allreduce_ms.joint reads nothing
    assert set(m) == set(SPANS) | {"cg_iters.joint", "device_idle.joint"}
    assert all(v > 0 for v in m.values())
    assert m["step_ms.joint"] + m["cost_ms.joint"] <= 1.05 * m["lm_ms.joint"]
    assert m["cg_iters.joint"] == int(m["cg_iters.joint"])


def test_control_fails_the_comparison():
    c = driver().Cell(harness.Context(spec(), 2 ** 31 + 13,
                                      torch.device("cpu")))
    c.setup()
    c.window(0.5)
    c.release()
    limits = c.ctx.workload["limits"]
    assert any(v > limits[k] for k, v in c.control())


@pytest.mark.parametrize("kind", joint_faults.KINDS)
def test_faults_come_out_not_correct(monkeypatch, kind):
    from mqslam_tpu_torch.parallel import sharded_ba
    monkeypatch.setattr(sharded_ba, "sharded_lm_solve", joint_faults.patched(
        kind, 0, sharded_ba.sharded_lm_solve))
    c = faulty_cell(kind, 2 ** 31 + 11)
    c.setup()
    c.window(0.5)
    c.release()
    checks = c.judge()
    assert not correct(checks), checks
    over = dict((k, v > lim) for k, v, lim in checks)
    assert over["rank_gap"] == (kind == "rank_perturbed"), checks


def test_a_program_without_rtol_is_refused_at_once(monkeypatch):
    from mqslam_tpu_torch.parallel import sharded_ba

    def old(problem, group=None, max_iters=40, lam0=1e-6, cg_iters=1000,
            verbose=False, layout="auto"):
        raise AssertionError("not reached")
    monkeypatch.setattr(sharded_ba, "sharded_lm_solve", old)
    c = driver().Cell(harness.Context(spec(), 2 ** 31 + 11,
                                      torch.device("cpu")))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rtol"):
        c.setup()
    assert c.helpers == [] and time.perf_counter() - t0 < 5


def test_readers_against_span_and_counter_totals(profiling):
    profiling.enable()
    for job in range(2):
        with profiling.span("ba.sharded.layout"):
            time.sleep(1e-3)
        with profiling.span("ba.sharded.lm"):
            for _ in range(3 + job):
                with profiling.span("ba.sharded.step"):
                    profiling.count("ba.cg_iters", torch.tensor(7))
                with profiling.span("ba.sharded.cost"):
                    pass
    trace = dict(window_s=1.0, busy_s=0.25, recorded=dict(jobs=2),
                 kernels={"ncclDevKernel_AllReduce_Sum_f32": (0.004, 9),
                          "nccl:all_reduce": (0.004, 9),   # its annotation
                          "gemm": (0.5, 3)})
    s = profiling.span_stats("ba.sharded.")
    for name, span, field in (
            ("layout_ms.joint", "ba.sharded.layout", "end_ms"),
            ("lm_ms.joint", "ba.sharded.lm", "end_ms"),
            ("step_ms.joint", "ba.sharded.step", "end_ms"),
            ("cost_ms.joint", "ba.sharded.cost", "host_ms")):
        assert read(name, trace) == pytest.approx(s[span][field] / 2), name
    assert read("cg_iters.joint", trace) == 7 * 7 / 2
    assert read("allreduce_ms.joint", trace) == pytest.approx(2.0)
    assert read("device_idle.joint", trace) == 75.0


def test_readers_find_nothing_without_a_profiled_job(profiling,
                                                     monkeypatch):
    names = SPANS + ("cg_iters.joint", "allreduce_ms.joint",
                     "device_idle.joint")
    assert all(read(n, {}) is None for n in names)
    with profiling.span("ba.sharded.lm"):       # tracing off
        pass
    assert all(read(n, dict(window_s=1.0)) is None for n in names)
    profiling.enable()
    with profiling.span("ba.lm"):               # another layer's span
        pass
    assert all(read(n, dict(window_s=1.0)) is None for n in names)
    # a program without the counter API: the spans still read
    with profiling.span("ba.sharded.lm"):
        pass
    monkeypatch.delattr(profiling, "counter_stats")
    assert read("cg_iters.joint", dict(window_s=1.0)) is None
    assert read("lm_ms.joint", dict(window_s=1.0)) is not None
