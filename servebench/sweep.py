"""The sweep that fixes an open-loop cell's offered rate: the cell's window
at each of a few rates, in one process, and for each the completed tokens
per second, the TTFT tail in each half of the window and the backlog (due
but not admitted) at the close. The highest rate whose backlog stays small
and whose TTFT tail does not grow from the first half to the second is the
knee; the traffic file's ``rate_rps`` is 4/5 of it.

    python3 servebench/sweep.py --workload <cell> --rates 2,3,4,5 --seconds 30 --seed 1
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch
    from servebench import harness

    cell = harness.load_cell(args.workload, ROOT)
    for rate in (float(r) for r in args.rates.split(",")):
        c = dataclasses.replace(cell, traffic=dict(cell.traffic, rate_rps=rate))
        t0 = time.monotonic()
        run = harness.run_cell(c, args.seed, args.seconds, False, "cuda", t0)
        w = run.window
        mid = (w.t_open + w.t_end) / 2
        e2e = harness.end_to_end(w, 0.0, run.peak_bytes)
        halves = [harness.end_to_end(dataclasses.replace(
            w, due=[r for r in w.due if (r.created_at < mid) == first]), 0.0, 0)["ttft_p90_s"]
            for first in (True, False)]
        backlog = sum(1 for r in w.due if not 0 < r.admitted_at <= w.t_end)
        print(json.dumps({"workload": args.workload, "rate_rps": rate, "due": len(w.due),
                          "backlog_at_close": backlog,
                          "output_tokens_per_s": e2e["output_tokens_per_s"],
                          "ttft_p90_s": e2e["ttft_p90_s"], "ttft_p90_s_halves": halves,
                          "itl_p95_ms": e2e["itl_p95_ms"], "correct": run.result["correct"]}),
              flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
