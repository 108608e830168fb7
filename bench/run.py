"""The benchmark of the port: one run of one cell.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

From the root of a checkout, on a machine with a CUDA card; without one
it exits non-zero and prints no result. Prints on the last line of its
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``, then ``checks``,
each number compared with its limit; the same numbers are the last lines
of its standard error. See bench/README.md.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _environment():
    """Caches inside the checkout at fixed paths; no library loads JAX."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (str(ROOT / "src"), str(BENCH)):
        if path not in sys.path:
            sys.path.insert(0, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from harness import cells
    from harness.run import Run, forbidden_modules
    chips = 1
    bench = ROOT / "BENCHMARK.json"
    if bench.is_file():
        for w in json.loads(bench.read_text())["workloads"]:
            if w["name"] == args.workload:
                chips = w["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    cells.workload(args.workload)
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace),
              device="cuda", t_start=T_START)
    run.setup()
    run.serve()
    run.after_window()
    run.report_lines()
    run.check()
    found = forbidden_modules()
    if found:
        print(f"bench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    result = run.result()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
