"""Every driver end to end on the CPU at a tiny size: sound runs come out
correct; the lower-precision control and a timed path broken underneath
(a step that returns its state unchanged, half of the fleet left out, an
answer altered where it is produced, a keyframe phase that adds none or
half of its new landmarks) come out not correct."""

import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

FLEET = "euroc_mav.fleet5_stream"
CELLS = [FLEET]
SECONDS = {FLEET: 2.0}


def run(cell, traced=False, seed=2 ** 31 + 11):
    return harness.run_cell(tiny.spec(cell), seed, SECONDS[cell], traced,
                            torch.device("cpu"), time.perf_counter())


def correct(checks):
    return all(v <= lim for _, v, lim in checks)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(cell):
    out, checks = run(cell)
    assert correct(checks), checks
    s = tiny.spec(cell)
    assert set(out["metrics"]) == {m["name"] for m in s["end_to_end"]}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_layer_metrics(cell):
    out, checks = run(cell, traced=True)
    assert correct(checks), checks
    names = {m["name"] for m in tiny.spec(cell)["per_layer"]}
    # the CPU has no device trace: the roofline readers find nothing
    found = set(out["metrics"])
    assert found <= names and found >= {
        n for n in names if "roofline" not in n}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_comparison(cell):
    c = tiny.cell(cell)
    c.setup()
    c.window(SECONDS[cell])
    c.release()
    limits = c.ctx.workload["limits"]
    assert any(v > limits[k] for k, v in c.control())


def _drop_landmarks(monkeypatch, half):
    """The keyframe phase stores none (or every other one) of the new
    landmarks it triangulated."""
    from mqslam_tpu_torch.frontend import tracker as trk
    real = trk.make_step

    def make(*a, **k):
        step, refill, step_pyr = real(*a, **k)
        pf = step_pyr.post_flow
        real_kf = pf.kf_phase

        def kf_phase(state, t, img):
            out = list(real_kf(state, t, img))
            can = out[6]
            kept = can & (torch.cumsum(can.to(torch.int32), -1) % 2 == 1) \
                if half else torch.zeros_like(can)
            out[5] = state.n_objp + kept.sum(-1).to(torch.int32)
            out[6] = kept
            out[8] = (t.inlier & t.tri_alive) | kept
            return tuple(out)
        pf.kf_phase = kf_phase
        return step, refill, step_pyr
    monkeypatch.setattr(trk, "make_step", make)


def _fleet_fault(monkeypatch, kind):
    from benchmark.drivers.fleet_stream import OUTPUTS
    from mqslam_tpu_torch.frontend import tracker as trk
    if kind.startswith("landmarks"):
        return _drop_landmarks(monkeypatch, kind == "landmarks_half")
    real = trk.make_multi_agent_runner
    rvec, tvec, uv = (OUTPUTS.index(n) for n in ("rvec", "tvec", "cur_uv"))

    def make(*a, **k):
        run_real = real(*a, **k)

        def run_faulty(states, imgs, *args, **kw):
            new, outs = run_real(states, imgs, *args, **kw)
            outs = list(outs)
            A = outs[0].shape[1]
            keep = torch.zeros(A, dtype=torch.bool)
            if kind == "unchanged":
                keep[:] = True
            elif kind == "half":
                keep[A // 2:] = True
            if kind == "altered":
                outs[uv] = outs[uv].clone()
                outs[uv][0, 0] += 0.5         # one agent's tracked points
                return new, tuple(outs)
            m = keep.to(outs[rvec].device)
            outs[rvec] = torch.where(m[None, :, None], states.rvec[None],
                                     outs[rvec])
            outs[tvec] = torch.where(m[None, :, None], states.tvec[None],
                                     outs[tvec])
            outs[uv] = torch.where(m[None, :, None, None],
                                   states.cur_uv[None], outs[uv])
            new = trk.TrackerState(*(torch.where(
                m.reshape((A,) + (1,) * (x.dim() - 1)), x, y)
                for x, y in zip(states, new)))
            return new, tuple(outs)
        return run_faulty
    monkeypatch.setattr(trk, "make_multi_agent_runner", make)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered",
                                  "landmarks_none", "landmarks_half"])
def test_fleet_faults_come_out_not_correct(monkeypatch, kind):
    _fleet_fault(monkeypatch, kind)
    _, checks = run(FLEET)
    assert not correct(checks), checks


@pytest.mark.parametrize("cell", CELLS)
def test_judged_copies_do_not_move_with_the_program(monkeypatch, cell):
    """A program that reuses the memory of what it was handed and of what
    it returned once the caller is done with them (here: zeroed at the
    next call) leaves the judged copies as they were: the run stays
    correct."""
    from mqslam_tpu_torch.frontend import tracker as trk
    handed = []

    def scribble():
        for x in handed:
            x.zero_()
        handed.clear()

    def hand_over(old_state, new_state, outs):
        live = {x.data_ptr() for x in new_state}
        handed.extend(x for x in list(old_state) + list(outs)
                      if x.data_ptr() not in live)

    real = trk.make_multi_agent_runner

    def make(*a, **k):
        run_real = real(*a, **k)

        def run_scribbling(states, imgs, *args, **kw):
            scribble()
            new, outs = run_real(states, imgs, *args, **kw)
            hand_over(states, new, outs)
            return new, outs
        return run_scribbling
    monkeypatch.setattr(trk, "make_multi_agent_runner", make)
    _, checks = run(cell)
    assert correct(checks), checks


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, torch\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        f"for c in {tuple(CELLS)!r}:"
        "\n    harness.run_cell(tiny.spec(c), 7, 0.1, True,"
        " torch.device('cpu'), time.perf_counter())\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_runner_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         FLEET, "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
