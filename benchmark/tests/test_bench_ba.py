"""The BA refine cell (``drivers/ba_refine.py``) on the CPU at a tiny size
(the ICL dump's first 100 steps, 3 odometry factors): a sound run comes out
correct and reports its metrics, traced and not; the control and a timed
path broken underneath (the LM capped at 3 iterations, one refined pose
moved 1 mm, a tenth of the landmarks pushed 100 times farther out) come
out not correct; the BA span readers and ``device_idle.ba`` against
hand-made totals; on a card, outputs bit-equal with tracing off and on, no
synchronize in a span, and the job spans over 95 % of a refine.

Not checked, because no number of ``correct`` can see them without
refusing sound runs (``PERF.md`` §2): the polish skipped (the check holds
the LM's float32) and the odometry factors dropped.  Each leaves the
poses and the landmarks the map determines as close to the float64
optimum as the program's own answers are (on the card: cost 1.8e-8 to
9.7e-8 of it, centres 5e-7 to 5.2e-5 m, against the program's 1.7e-8 to
1.4e-5 and 5.7e-6 to 3.3e-4 m).

The reference's solve from the dump's start (``start_optimum``, ~27 s
here) is made once for the module."""

import copy
import time

import pytest
import torch

from benchmark import harness

CELL = "icl_nuim.icl_refine"
STEPS = 100
METRICS = ("build_ms.ba", "lm_ms.ba", "linearize_ms.ba", "step_ms.ba",
           "cost_ms.ba", "lm_attempts.ba", "polish_ms.ba")


@pytest.fixture(scope="module", autouse=True)
def one_optimum():
    """``start_optimum`` computed once for the module's runs (all of one
    start)."""
    from benchmark.reference import ba as ref
    real, memo = ref.start_optimum, {}

    def start_optimum(data, device, use_odometry=True):
        key = (len(data.point3D_added_idxs), use_odometry)
        if key not in memo:
            memo[key] = real(data, device, use_odometry)
        return memo[key]
    ref.start_optimum = start_optimum
    yield
    ref.start_optimum = real


def spec(steps=STEPS):
    """The cell cut to the dump's first ``steps`` steps (same code paths)."""
    s = copy.deepcopy(harness.cell_spec(CELL))
    s["workload"]["traffic"].update(steps=steps, warmup_jobs=0,
                                    judge_every=1)
    return s


def run(traced=False, seed=2 ** 31 + 11):
    return harness.run_cell(spec(), seed, 1.0, traced, torch.device("cpu"),
                            time.perf_counter())


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


def test_sound_run_is_correct_and_reports_its_metrics(profiling):
    out, checks = run()
    assert correct(checks), checks
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["traffic"]["jobs"] == out["attempted"]
    assert set(out["traffic"]) == {"jobs", "lm_iterations",
                                   "polish_iterations"}
    assert out["traffic"]["lm_iterations"]["min"] > 0
    assert out["traffic"]["polish_iterations"]["min"] >= 1
    assert dict((k, v) for k, v, _ in checks)["cost_excess_rel"] < 0


def test_traced_run_reads_the_ba_metrics(profiling):
    out, checks = run(traced=True)
    assert correct(checks), checks
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == set(METRICS) | {"device_idle.ba"}
    assert all(v > 0 for v in m.values())
    assert m["device_idle.ba"] == pytest.approx(100.0 * (
        1 - out["device"]["busy_s"] / out["device"]["window_s"]))
    assert m["linearize_ms.ba"] + m["step_ms.ba"] + m["cost_ms.ba"] \
        <= 1.05 * m["lm_ms.ba"]
    job = m["build_ms.ba"] + m["lm_ms.ba"] + m["polish_ms.ba"]
    assert job <= 1e3 * out["device"]["window_s"]


def test_control_fails_the_comparison():
    drv = harness.load_module("drivers", "ba_refine")
    c = drv.Cell(harness.Context(spec(), 2 ** 31 + 13, torch.device("cpu")))
    c.setup()
    c.window(0.5)
    c.release()
    limits = c.ctx.workload["limits"]
    assert any(v > limits[k] for k, v in c.control())


def _fault(monkeypatch, kind):
    from mqslam_tpu_torch.ba import solver
    from mqslam_tpu_torch.cli import ba_run
    if kind == "lm_capped":
        real_lm = solver.lm_solve
        monkeypatch.setattr(solver, "lm_solve", lambda *a, **k: real_lm(
            *a, **dict(k, max_iters=3)))
        return
    real = ba_run.refine

    def refine(data, **k):
        v, hist, hist64 = real(data, **k)
        if kind == "pose_moved":
            t = v.pose_t.clone()
            t[len(t) // 2, 0] += 1e-3
            return v._replace(pose_t=t), hist, hist64
        # every tenth landmark 100 times as far from the first camera,
        # out of the determined set: cost_excess_rel sees their residuals
        X = v.points.clone()
        c0 = v.pose_t[0]
        X[::10] = c0 + 100.0 * (X[::10] - c0)
        return v._replace(points=X), hist, hist64
    monkeypatch.setattr(ba_run, "refine", refine)


@pytest.mark.parametrize("kind", ["lm_capped", "pose_moved",
                                  "points_pushed"])
def test_faults_come_out_not_correct(monkeypatch, kind):
    _fault(monkeypatch, kind)
    _, checks = run()
    assert not correct(checks), checks
    if kind == "points_pushed":
        assert dict((k, v > lim) for k, v, lim in checks)[
            "cost_excess_rel"], checks


def test_readers_against_span_totals(profiling):
    profiling.enable()
    for job in range(2):
        with profiling.span("ba.build"):
            time.sleep(1e-3)
        with profiling.span("ba.lm"):
            for _ in range(3 + job):
                with profiling.span("ba.linearize"):
                    pass
                with profiling.span("ba.step"):
                    time.sleep(1e-4)
                with profiling.span("ba.cost"):
                    pass
        with profiling.span("ba.polish64"):
            time.sleep(2e-3)
    trace = dict(window_s=1.0)
    s = profiling.span_stats("ba.")
    for name, span, field in (
            ("build_ms.ba", "ba.build", "end_ms"),
            ("lm_ms.ba", "ba.lm", "end_ms"),
            ("linearize_ms.ba", "ba.linearize", "end_ms"),
            ("step_ms.ba", "ba.step", "end_ms"),
            ("cost_ms.ba", "ba.cost", "host_ms"),
            ("lm_attempts.ba", "ba.step", "count"),
            ("polish_ms.ba", "ba.polish64", "host_ms")):
        assert read(name, trace) == pytest.approx(s[span][field] / 2), name
    assert read("lm_attempts.ba", trace) == 3.5
    assert read("device_idle.ba", dict(window_s=2.0, busy_s=0.5)) == 75.0
    assert read("device_idle.ba", {}) is None


def test_readers_find_nothing_without_a_profiled_job(profiling,
                                                     monkeypatch):
    # no profiled window
    assert all(read(n, {}) is None for n in METRICS)
    # tracing off: nothing recorded
    with profiling.span("ba.lm"):
        pass
    assert all(read(n, dict(window_s=1.0)) is None for n in METRICS)
    # spans of another layer only
    profiling.enable()
    with profiling.span("fleet.group"):
        pass
    assert all(read(n, dict(window_s=1.0)) is None for n in METRICS)
    # a program without the span mechanism
    monkeypatch.delattr(profiling, "span_stats")
    assert all(read(n, dict(window_s=1.0)) is None for n in METRICS)


@pytest.mark.card
def test_ba_spans_on_the_card(cuda_device, profiling, monkeypatch):
    """A refine of the ICL dump's first steps off, on (``enable()``), off
    again: outputs bit-equal, no synchronize once tracing is on, the job
    spans (build, LM, polish) over 95 % of the refine's host time.  The
    solver's float sums (``index_add_``) are atomic on a card, so the three
    refines run under PyTorch's deterministic algorithms (cuBLAS needs its
    workspace setting before its first use in the process)."""
    from benchmark.drivers import ba_refine
    from mqslam_tpu_torch.cli.ba_run import refine
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    data = ba_refine.prefix(ba_refine.load_dump(
        harness.cell_spec(CELL)["config"]["dump"]), STEPS)

    def job():
        t0 = time.perf_counter()
        v, hist, hist64 = refine(data, device=cuda_device)
        return ([x.cpu() for x in v], (hist, hist64),
                time.perf_counter() - t0)

    torch.use_deterministic_algorithms(True)
    try:
        off = job()
        profiling.enable(cuda_device)
        synced = []
        real = torch.cuda.synchronize
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda d=None: synced.append(d))
        on = job()
        monkeypatch.setattr(torch.cuda, "synchronize", real)
        profiling.disable()
        again = job()
    finally:
        torch.use_deterministic_algorithms(False)
    assert synced == []
    for other in (on, again):
        assert other[1] == off[1]
        assert all(torch.equal(a, b) for a, b in zip(other[0], off[0]))
    s = profiling.span_stats("ba.")
    assert s["ba.lm"]["count"] == s["ba.build"]["count"] == 1
    covered = sum(s[k]["host_ms"] for k in ("ba.build", "ba.lm",
                                            "ba.polish64"))
    assert covered >= 0.95 * 1e3 * on[2]
    assert all(v["device_ms"] is not None for v in s.values())
