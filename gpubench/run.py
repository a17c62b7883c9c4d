"""Run one cell of the port's benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic loop (``loops/<loop>.py``, named by its mix) builds the
program's objects from the seed, warms them up, measures for ``--seconds``
and checks what the timed path produced against the plain reference in
``reference/``. With ``--trace 0`` the line carries the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read by
``metrics/<metric>.py`` from the traced part of the window, and a
``breakdown``. Needs as many CUDA devices as the cell asks for; it never
falls back to the CPU.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gpubench import common  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_kernels() -> dict:
    """Load the port's kernel library, which the first run of a checkout
    builds with nvcc. ``setup_s`` holds this time; the result line gives it
    apart too, so that a run that built reads as one."""
    from multimodal_segmentation_project_tpu_torch.ops import _build

    built = not _build.library_path().exists()
    t = time.perf_counter()
    _build.load()
    return {"kernel_library_s": time.perf_counter() - t, "kernel_library_built": built}


def execute(args, device: str = "cuda", t0: float = T0, overrides: dict | None = None,
            set_up: dict | None = None) -> dict:
    """Run the cell and return its result object (the line's content). The
    caller has checked the device; tests run it on the CPU with
    ``overrides`` of the configuration and the mix at a small size.
    ``set_up`` holds parts of ``setup_s`` that the line gives apart."""
    bench = common.benchmark()
    files = common.cell_files(bench, args.workload)
    for key, extra in (overrides or {}).items():
        files[key] = {**files[key], **extra}
    out = files["loop"].run(
        workload=files["workload"], config=files["config"], mix=files["mix"], cell=files["cell"],
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device, t0=t0)
    checks = out["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if args.trace:
        metrics = common.read_per_layer(bench, args.workload, out["layer"])
    else:
        wanted = [m["name"] for m in common.metrics_for(bench, args.workload, "end_to_end")]
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {k: {"value": float(out["e2e"][k]), "unit": units[k]} for k in wanted}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": out["device"]}
    if args.trace:
        result["device"] = {**out["device"], "busy_s": out["layer"]["trace"].busy_s,
                            "window_s": out["layer"]["trace"].window_s}
        result["breakdown"] = out["breakdown"]
    if set_up:
        result["set_up"] = set_up
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    common.cache_env()
    import torch

    bench = common.benchmark()
    chips = common.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        common.say(f"gpubench: the cell needs {chips} CUDA device(s); this machine has "
                   f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    set_up = load_kernels()
    common.say(f"gpubench: kernel library {'built and ' if set_up['kernel_library_built'] else ''}"
               f"loaded in {set_up['kernel_library_s']:.2f} s")
    result = execute(args, set_up=set_up)
    loaded = common.forbidden_modules()
    if loaded:
        common.say(f"gpubench: the process loaded {loaded}: the port's benchmark may load "
                   "neither JAX nor the JAX package")
        return 3
    for name, c in result["checks"].items():
        common.say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
