"""The correctness check's two readings for one cell, on the card, in one
process (set-up is long): the program's widest served-token logit gap on
many seeds, and on some of them the control's, the plain reference computed
in float8 e4m3 (``reference/common.py``), whose first-ranked token at each
served row is read in the f32 reference.

    python3 servebench/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 20

Each seed runs the cell as ``run.py`` does (its own weights, traffic and
window); one JSON line a seed. The limit in ``limits/<cell>.json`` is set
from these readings (see PERF.md). The benchmark's own runs do not run the
control.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch
    from servebench import harness

    cell = harness.load_cell(args.workload, ROOT)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        run = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0,
                               control=seed in ctrl)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": run.result["correct"], **run.check,
                          "seconds": time.monotonic() - t0}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
