"""The serving benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. It prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit. Those comparisons are also
the last lines of standard error. Without CUDA, with fewer cards than the
cell asks for, or with JAX or the JAX package loaded, it prints no result
and exits non-zero.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or the toolchain keeps stays in the checkout, at
# fixed paths (the port's kernels build into build/kernels by themselves)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "servebench" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from servebench import harness

    cell = harness.load_cell(args.workload, ROOT)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"servebench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"servebench: JAX or the JAX package is loaded: {bad}", file=sys.stderr)
        return 3
    result = dict(run.result)
    checks = result.pop("checks")
    result["device"] = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
                            memory_peak_bytes=run.peak_bytes, **result["device"])
    result["checks"] = checks
    for line in run.log:
        print(line, file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
