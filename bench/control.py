"""Readings that set a cell's correctness limits: the program's widest
served-token gap and share of mismatched tokens, and the control's, seed
after seed in one process.

  python3 bench/control.py --workload granite-3-8b.conv10 \
      --seeds 11,12,13 --seconds 20

Each seed is a run of the cell at its own load for ``--seconds`` (no
trace), judged as ``run.py`` judges it; then the control, the plain
reference computed with TF32 on (the precision just below the
configuration's float32 with TF32 off), is read on the same requests:
the widest gap, in the float32 reference's logits, of the token it puts
first, and the share of positions where that is not the reference's
first. The control's readings are then put in the program's place and
judged by the cell's own limits: ``control_correct`` has to be false.
One JSON line per seed; exits 1 where a control came out correct or the
program did not. On a CUDA card only.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as entry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    entry._environment()
    import torch
    from harness import check
    from harness.run import Run
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        run = Run(args.workload, seed, args.seconds, False, device="cuda")
        run.control = True
        run.setup()
        run.serve()
        run.check()
        control_correct = check.passes(run.control_checks)
        if control_correct or not run.correct:
            rc = 1
        print(json.dumps({"seed": seed, "correct": run.correct,
                          "control_correct": control_correct,
                          **run.readings, "checks": run.checks,
                          "control_checks": run.control_checks,
                          "check_s": run.check_s}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return rc


if __name__ == "__main__":
    sys.exit(main())
