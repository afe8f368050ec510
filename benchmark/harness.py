"""The benchmark's runner: one run of one cell, and the line it prints.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration
(``benchmark/configs/<config>.json``) and its metrics;
``benchmark/workloads/<cell>.json`` names its driver
(``benchmark/drivers/<driver>.py``), holds its traffic parameters and the
limits of ``correct``; each per-layer metric is read by
``benchmark/layer_metrics/<metric>.py`` (``read(trace)``, None where it
finds nothing).  A driver's ``Cell`` has
``setup()``, ``window(seconds, traced)``, ``profile_steps(on, off)``,
``release()``, ``judge()`` (the compared numbers and their limits, from
the workload file) and ``control()`` (the same numbers for the
lower-precision control, which ``benchmark/control.py`` runs).

A run: set-up (traffic made on the card from the seed, the program's
state, a warm-up of every shape the window uses), the measured window,
with ``--trace 1`` a short profiled sub-window, the device's peak memory,
the program's state freed, the comparison with the plain reference, the
check that neither JAX nor the JAX package was loaded, and the result's
line last on standard output, the numbers compared beside their limits
last on standard error.
"""

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mqslam_tpu")

__all__ = ["main", "run_cell", "load_module", "cell_spec", "percentile",
           "forbidden_modules", "result_line", "Context"]


def load_module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(name, bench=None):
    """Everything a run of cell ``name`` needs: its entry, configuration,
    workload file and the names of the metrics it reports."""
    bench = bench or _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    applies = lambda m: name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m) and m["moves"] in reported]
    return dict(cell=cell, config=_json(os.path.join(ROOT, conf["file"])),
                workload=_json(os.path.join(HERE, "workloads",
                                            name + ".json")),
                end_to_end=e2e, per_layer=layer)


def percentile(values, q):
    """The q-th percentile (0..100) by linear interpolation between order
    statistics (numpy's default rule)."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


class Context:
    """What a driver gets: the cell's spec, the seed, the device."""

    def __init__(self, spec, seed, device):
        self.spec, self.seed, self.device = spec, int(seed), device
        self.config = spec["config"]
        self.workload = spec["workload"]
        self.traffic = spec["workload"]["traffic"]


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None, traffic=None):
    """The result's JSON line; ``traffic`` (what the window's traffic made
    the program do, such as its keyframe share) before the compared
    numbers, which come last."""
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    if traffic is not None:
        out["traffic"] = traffic
    # strict JSON has no infinity or NaN: a non-finite reading (a pose that
    # puts landmarks behind the camera) is written as a string
    num = lambda x: x if math.isfinite(x) else str(x)
    out["checks"] = {k: dict(value=num(v), limit=lim) for k, v, lim in checks}
    return json.dumps(out, allow_nan=False)


def _set_cache_dirs():
    """Kernel caches at fixed paths inside the checkout (the program's own
    nvcc builds go to ``mqslam_tpu_torch/_build/`` there)."""
    cache = os.path.join(ROOT, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")


def run_cell(spec, seed, seconds, traced, device, t_process):
    """One run of the cell ``spec`` on ``device``: (the result's fields,
    the compared numbers [(name, value, limit)])."""
    import torch
    from benchmark import trace as trace_mod
    cuda = device.type == "cuda"
    driver = load_module("drivers", spec["workload"]["driver"])
    cell = driver.Cell(Context(spec, seed, device))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell.setup()
    win = cell.window(seconds, traced=traced)
    setup_s = win["t_first"] - t_process
    out = dict(attempted=win["attempted"], failed=win["failed"],
               setup_s=setup_s, traffic=win.get("traffic"))
    if traced:
        trace = dict(win.get("trace", {}))
        trace.update(trace_mod.profile(cell.profile_steps))
        metrics = {}
        for m in spec["per_layer"]:
            value = load_module("layer_metrics", m["name"]).read(trace)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        out["breakdown"] = trace["breakdown"]
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in spec["end_to_end"]}
    out["metrics"] = metrics
    if cuda:
        torch.cuda.synchronize()
    out["device"] = dict(
        platform="gpu" if cuda else device.type,
        kind=torch.cuda.get_device_name(0) if cuda else device.type,
        count=int(spec["cell"]["chips"]),
        memory_peak_bytes=int(torch.cuda.max_memory_allocated())
        if cuda else 0)
    if traced:
        out["device"].update(busy_s=trace["busy_s"],
                             window_s=trace["window_s"])
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    return out, cell.judge()


def main(argv=None, t_process=None):
    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _set_cache_dirs()
    spec = cell_spec(args.workload)
    import torch
    chips = int(spec["cell"]["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one host thread: the program is bound by the host's launch rate, and
    # a pool of threads on a shared host makes its runs spread
    torch.set_num_threads(1)
    out, checks = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda"), t_process)
    found = forbidden_modules()
    if found:
        print("benchmark: JAX or the JAX package was loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    correct = all(v <= lim for _, v, lim in checks)
    print(f"benchmark: {args.workload} seed {args.seed}: setup_s "
          f"{out['setup_s']:.3f}, {out['attempted']} attempted, "
          f"{out['failed']} failed; traffic {out['traffic']}; card "
          f"{power_limit()}", file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(correct, out["attempted"], out["failed"],
                      out["metrics"], out["device"], checks,
                      out.get("breakdown"), out["traffic"]), flush=True)
    return 0
