"""Readings that set the limits of ``correct``: the program's and the
lower-precision control's, seed after seed in one process.

    python3 -m benchmark.control --workload <cell> --seconds <s>
                                 --seeds <n> [<n> ...] [--out FILE]

For each seed: the cell's set-up and a window of the given seconds as a
benchmark run makes them, then the compared numbers for the program's
answers (``Cell.judge``) and for the control's (``Cell.control``: the
plain reference put in the program's place and computed in bfloat16).
One JSON line a seed on standard output (and appended to ``--out``).  The
benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.cell_spec(args.workload)
    driver = harness.load_module("drivers", spec["workload"]["driver"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = driver.Cell(harness.Context(spec, seed, device))
        cell.setup()
        win = cell.window(args.seconds)
        cell.release()
        torch.cuda.empty_cache()
        program = {k: v for k, v, _ in cell.judge()}
        control = dict(cell.control())
        line = json.dumps(dict(
            workload=args.workload, seed=seed, seconds=args.seconds,
            metrics=win["metrics"], attempted=win["attempted"],
            failed=win["failed"], program=program, control=control,
            wall_s=time.perf_counter() - t0))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
