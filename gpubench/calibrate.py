"""Readings for a cell's limits: the program's numbers over many seeds, and the control's.

    python3 gpubench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 21,22,23] [--seconds 0] [--out FILE]

For each of ``--seeds`` it runs the cell as ``run.py`` does, with a window
of ``--seconds`` (0: set-up, which drives the program through the steps the
reference follows, then the comparison), and prints the numbers compared. For each of
``--control-seeds`` it puts the reference computed one precision below the
configuration's (fp8 for bf16: ``reference/unet3d.py``) in the program's
place and prints the same numbers, which have to fail a limit. One JSON line
per reading, on standard output and appended to ``--out``. The lower
reading of a number is the largest the program gives, the upper the
smallest the control gives; a limit lies between them (PERF.md says which).
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gpubench import common  # noqa: E402

LOWER = {"bf16": "fp8", "fp16": "fp8"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    common.cache_env()
    import torch

    if not torch.cuda.is_available():
        common.say("gpubench: calibration needs a CUDA device")
        return 2
    bench = common.benchmark()
    files = common.cell_files(bench, args.workload)
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        out = files["loop"].run(workload=files["workload"], config=files["config"],
                                mix=files["mix"], cell=files["cell"], seed=seed,
                                seconds=args.seconds, trace=False, device="cuda", t0=t)
        emit({"workload": args.workload, "seed": seed, "side": "program",
              "numbers": out["numbers"], "seconds": time.perf_counter() - t,
              "device": out["device"]})
    precision = LOWER[files["config"]["precision"]]
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t = time.perf_counter()
        numbers = files["loop"].control(files["config"], files["mix"], seed, "cuda", precision)
        emit({"workload": args.workload, "seed": seed, "side": f"control ({precision})",
              "numbers": numbers, "seconds": time.perf_counter() - t})
    if common.forbidden_modules():
        common.say(f"gpubench: loaded {common.forbidden_modules()}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
