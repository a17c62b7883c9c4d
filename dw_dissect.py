#!/usr/bin/env python3
"""Where the dW body's time goes, on one NVIDIA GPU (Hopper, sm_90a).

    python3 dw_dissect.py

Builds copies of ``multimodal_segmentation_project_tpu_torch/csrc/conv3_dw.cu``
with parts of the tile loop removed, each into its own library under
``build/dw_dissect/``, and times each copy's bare launch (kernel 2 or 6:
the partial sums and the block-order reduce) at the train step's dW shapes
by CUDA events: the mean of 4 runs over 3 distinct inputs, the median of 3
such windows. The copies without a part compute wrong sums; only their
times mean anything:

* ``full``: the body as it is;
* ``no_mma``: no fragment loads and no MMAs (the staging alone);
* ``no_transform``: the next tile's raw input is not written channel minor;
* ``no_loads``: the next tile's input and cotangent are not loaded;
* ``mma_only``: neither the loads nor the transform of the next tile.

Prints the card's name and power limit first, then one line per shape.
Exits non-zero without a GPU or when the source no longer holds a part.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "dw_dissect"

# (Cin, Cout, S, prologue): the dW shapes of one 192^3 train step (chip_smoke.py)
SHAPES = [(1, 16, 192, False), (16, 32, 96, False), (32, 64, 48, False), (64, 32, 96, False),
          (32, 16, 192, False), (64, 64, 48, False),
          (16, 16, 192, True), (32, 32, 96, True), (64, 64, 48, True)]

MMA = """        f.load(gs, xs, r, a_vox, a_half);
        f.mma(acc);
"""
TRANSFORM = """        if (stager) transform<PRO>(smem + C::x_at, raw_g, pa, pt, at);
      }"""
LOADS = """        if (stager) load_raw(smem_s + C::raw_at, raw_g, x, at, vec);
        load_g<COUT>(smem_s + (s ^ 1) * C::g_bytes, smem + (s ^ 1) * C::g_bytes, g, at, Cout,
                     vec);
"""


def variants(src: str) -> dict:
    for part in (MMA, TRANSFORM, LOADS):
        if part not in src:
            raise SystemExit(f"conv3_dw.cu no longer holds:\n{part}")
    return {"full": src, "no_mma": src.replace(MMA, ""),
            "no_transform": src.replace(TRANSFORM, "      }"),
            "no_loads": src.replace(LOADS, ""),
            "mma_only": src.replace(LOADS, "").replace(TRANSFORM, "      }")}


def build(name: str, text: str, csrc: Path, nvcc: str, flags) -> subprocess.Popen:
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "conv3_dw.cu").write_text(text)
    return subprocess.Popen([nvcc, *flags, "-shared", "-I", str(csrc), str(d / "conv3_dw.cu"),
                             "-o", str(d / "lib.so")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import _build, conv3

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is false", flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    nvcc = _build.find_nvcc()
    procs = {name: build(name, text, _build.CSRC, nvcc, _build.NVCC_FLAGS)
             for name, text in variants((_build.CSRC / "conv3_dw.cu").read_text()).items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed on {name}:\n{out}", flush=True)
            return 1
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn, n_ptr in (("mmseg_conv3_dw", 4), ("mmseg_conv3_dw_prologue", 6)):
            getattr(lib, fn).argtypes = ((ctypes.c_void_p,) * n_ptr + (ctypes.c_int,) * 7
                                         + (ctypes.c_void_p,))
        libs[name] = lib

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for cin, cout, s, pro in SHAPES:
        xs = [torch.randn(1, cin, s, s, s, generator=gen, device=dev).bfloat16() for _ in range(3)]
        gs = [torch.randn(1, cout, s, s, s, generator=gen, device=dev).bfloat16()
              for _ in range(3)]
        a, t = torch.rand(1, cin, device=dev) + 0.5, torch.randn(1, cin, device=dev)
        partial, dw, args = conv3.dw_operands("dw_dissect", xs[0], gs[0])
        times = []
        for name, lib in libs.items():
            def launch(i, lib=lib):
                head = (xs[i].data_ptr(), gs[i].data_ptr())
                tail = (partial.data_ptr(), dw.data_ptr(), *args, stream)
                if pro:
                    return lib.mmseg_conv3_dw_prologue(*head, a.data_ptr(), t.data_ptr(), *tail)
                return lib.mmseg_conv3_dw(*head, *tail)

            if any(launch(i) != 0 for i in range(3)):  # warm-up
                print(f"{name}: launch refused", flush=True)
                return 1
            torch.cuda.synchronize()
            windows = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(4):
                    for i in range(3):
                        launch(i)
                end.record()
                end.synchronize()
                windows.append(start.elapsed_time(end) / 12)
            times.append(f"{name} {statistics.median(windows):.4f}")
        kernel = 6 if pro else 2
        print(f"[dw-dissect] kernel {kernel} {cin}->{cout} @{s}^3, ms: " + " | ".join(times),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
