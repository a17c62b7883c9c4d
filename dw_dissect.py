#!/usr/bin/env python3
"""Where the dW body's time goes, on one NVIDIA GPU (Hopper, sm_90a); and
the fp32 conv body's.

    python3 dw_dissect.py                      # the bf16 body, csrc/conv3_dw.cu
    python3 dw_dissect.py --fp32 [--port ROOT] # the fp32 body, csrc/conv3_dw_f32.cu
    python3 dw_dissect.py --conv-f32 [--port ROOT]  # the fp32 conv body, csrc/conv3_f32.cu

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

With ``--fp32`` it does the same for ``csrc/conv3_dw_f32.cu`` (kernels 2
and 6 in fp32) at the fp32 train step's 11 dW shapes, and prints each
variant's sums per step. It knows the parts of two designs of that body,
the FFMA body and the 3xTF32 one, and takes the set that the source holds:

* ``full``: the body as it is;
* ``no_fma``: no multiplies (the FFMA loop, or the MMA loop): the staging
  alone;
* ``no_prologue``: kernel 6 without the prologue's pass over the staged
  input (kernel 2 is unchanged);
* ``no_loads``: the next tile's input and cotangent are not loaded;
* ``no_transform`` (3xTF32 body only): the landed tiles after the first
  are not split into the hi and lo planes;
* ``mma_only`` (3xTF32 body only): neither ``no_loads``' loads nor the
  split: the MMA loop and the block's fixed costs;
* ``mma_only_1x`` (3xTF32 body only): ``mma_only`` with one MMA in place
  of each k step's three, so that the two tell the tensor pipe's share.

With ``--conv-f32`` it builds copies of ``csrc/conv3_f32.cu`` (the 3xTF32
wgmma body) and times each copy's bare launch of kernel 7 (the eval conv)
at the fp32 eval forward's 11 convs and of kernel 12 (the prologue conv)
at the train step's 5 conv1 shapes, each summed per pass:

* ``full``: the body as it is;
* ``no_mma``: no wgmma (and so no A path, which feeds only them): the
  staging, the loop's barriers, the chunk sums and the epilogue;
* ``no_a_path``: the A values constant: no ld.shared, prologue or split;
* ``no_split``: the loads kept, the raw values given as hi and lo;
* ``mma_1x``: one wgmma a k step and m64 tile in place of three;
* ``no_loads``: the items past the ring's first not loaded, no wait;
* ``no_prologue``: kernel 12 without the prologue (kernel 7 unchanged).

``--port ROOT`` imports the port (and so takes the source) from another
checkout, e.g. a parent commit unpacked by ``git archive`` under build/, so
that two bodies are timed by the same code in one call.

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


# the fp32 body's parts: [(the text, what replaces it), ...], per design
F32_PARTS = {
    "ffma": {
        "no_fma": [("    if (active) {\n      const float* xs",
                    "    if (false) {\n      const float* xs")],
        "no_prologue": [("    if (PRO) {\n      const TileAt at = tile_at(p, tile);",
                         "    if (false) {\n      const TileAt at = tile_at(p, tile);")],
        "no_loads": [("      issue_tile(smem_s + uint32_t((s ^ 1) * STAGE_FLOATS) * 4u, p, "
                      "tile + gridDim.x, c0, o0,\n                 vx, vg);\n", "")],
    },
    "3xtf32": {
        "no_fma": [("    for (int ks = kp; ks < KSTEPS; ks += ksplit) {",
                    "    for (int ks = kp; ks < 0; ks += ksplit) {")],
        "no_prologue": [("        in_lo = at.w0 == 0 ? 1 : 0, in_hi = min(XW, p.W - at.w0 + 1);",
                         "        ;")],
        # the first two tiles' copies only, and no wait for the others
        "no_loads": [("      issue_tile<MW, PRO>(smem_s + uint32_t(C::PLANES + s * C::STAGE) * 4u, "
                      "bar0 + 8u * s, p,\n                          &tx, &tg, tile + 2 * step, c0, "
                      "o0);", "      cp_async_commit();"),
                     ("    if (p.tma) mbar_wait(bar0 + 8u * s, (n >> 1) & 1);",
                      "    if (p.tma && n < 2) mbar_wait(bar0 + 8u * s, (n >> 1) & 1);")],
        "no_transform": [("    for (int u = tid; u < rows; u += DW_THREADS) split_row",
                          "    for (int u = tid; u < 0; u += DW_THREADS) split_row")],
    },
}
F32_PARTS["3xtf32"]["mma_only"] = F32_PARTS["3xtf32"]["no_loads"] + F32_PARTS["3xtf32"][
    "no_transform"]
# one MMA a k step and column group in place of three: the tensor pipe's share
F32_PARTS["3xtf32"]["mma_only_1x"] = F32_PARTS["3xtf32"]["mma_only"] + [(
    "          mma_tf32(d, alo, bh[kw], bh[kw + 1], zero);\n"
    "          mma_tf32(d, ahi, bl[kw], bl[kw + 1], d);\n"
    "          mma_tf32(d, ahi, bh[kw], bh[kw + 1], d);\n",
    "          mma_tf32(d, ahi, bh[kw], bh[kw + 1], zero);\n")]
# (Cin, Cout, S, prologue): the fp32 train step's dW shapes, 2-fp32 over
# conv0's and dec1.conv1's, 6-fp32 over conv1's (chip_smoke.py)
F32_SHAPES = [(1, 16, 192, False), (16, 32, 96, False), (32, 64, 48, False),
              (64, 32, 96, False), (32, 16, 192, False), (64, 64, 48, False),
              (16, 16, 192, True), (32, 32, 96, True), (64, 64, 48, True), (32, 32, 96, True),
              (16, 16, 192, True)]


# the fp32 conv body's parts (csrc/conv3_f32.cu, the 3xTF32 wgmma body)
CONV_F32_PARTS = {
    # no A path and no wgmma: the staging, the loop's barriers and the epilogue
    "no_mma": [("        MMA::mma(acc[mt], lo[mt], dhi, s != 0);\n"
                "        MMA::mma(acc[mt], hi[mt], dlo, 1);\n"
                "        MMA::mma(acc[mt], hi[mt], dhi, 1);\n", "")],
    # the A values constant: no ld.shared, prologue or split in the k loop
    "no_a_path": [("        v[mt][0] = p0[4 * XW * mt];\n        v[mt][1] = p0[4 * XW * mt + 8];\n"
                   "        v[mt][2] = p1[4 * XW * mt];\n        v[mt][3] = p1[4 * XW * mt + 8];\n",
                   "        v[mt][0] = v[mt][1] = v[mt][2] = v[mt][3] = 1.0f;\n")],
    # the loads kept, no split: hi = lo = the raw value
    "no_split": [("          hi[mt][i] = (__float_as_uint(v[mt][i]) + 0x1000u) & 0xffffe000u;\n"
                  "          lo[mt][i] = __float_as_uint(__fsub_rn(v[mt][i], "
                  "__uint_as_float(hi[mt][i]))) &\n                      0xffffe000u;\n",
                  "          hi[mt][i] = lo[mt][i] = __float_as_uint(v[mt][i]);\n")],
    # one wgmma a k step and m64 tile in place of three: the tensor pipe's share
    "mma_1x": [("        MMA::mma(acc[mt], lo[mt], dhi, s != 0);\n"
                "        MMA::mma(acc[mt], hi[mt], dlo, 1);\n"
                "        MMA::mma(acc[mt], hi[mt], dhi, 1);\n",
                "        MMA::mma(acc[mt], hi[mt], dhi, s != 0);\n")],
    # items past the ring's first not loaded (the stages' stale data), no wait
    "no_loads": [("    if (it + p.nst < items) issue(it + p.nst);",
                  "    if (false) issue(it + p.nst);"),
                 ("    mbar_wait(bar0 + 8u * st, uint32_t(it / p.nst) & 1u);",
                  "    if (it < p.nst) mbar_wait(bar0 + 8u * st, uint32_t(it / p.nst) & 1u);")],
    # kernel 12 without the prologue in the split (kernel 7 is unchanged)
    "no_prologue": [("      if (PRO) {\n        const float2 a0 = at_c", "      if (false) {\n"
                     "        const float2 a0 = at_c")],
}
# (Cin, Cout, S): the fp32 eval forward's convs (7-fp32) and the train
# step's conv1 shapes (12-fp32, the prologue's instance with no epilogue sums)
CONV_F32_EVAL = [(1, 16, 192), (16, 16, 192), (16, 32, 96), (32, 32, 96), (32, 64, 48),
                 (64, 64, 48), (64, 64, 48), (64, 32, 96), (32, 32, 96), (32, 16, 192),
                 (16, 16, 192)]
CONV_F32_CONV1 = [(16, 16, 192), (32, 32, 96), (64, 64, 48), (32, 32, 96), (16, 16, 192)]


def with_parts(src: str, part_sets: dict, what: str) -> dict:
    """{"full": src, name: src with each (text, replacement) of the set}."""
    out = {"full": src}
    for name, parts in part_sets.items():
        text = src
        for part, repl in parts:
            if text.count(part) != 1:
                raise SystemExit(f"{what} no longer holds once:\n{part}")
            text = text.replace(part, repl)
        out[name] = text
    return out


def variants(src: str) -> dict:
    for part in (MMA, TRANSFORM, LOADS):
        if part not in src:
            raise SystemExit(f"conv3_dw.cu no longer holds:\n{part}")
    return {"full": src, "no_mma": src.replace(MMA, ""),
            "no_transform": src.replace(TRANSFORM, "      }"),
            "no_loads": src.replace(LOADS, ""),
            "mma_only": src.replace(LOADS, "").replace(TRANSFORM, "      }")}


def build(name: str, text: str, csrc: Path, nvcc: str, flags, out: Path = OUT,
          file: str = "conv3_dw.cu") -> subprocess.Popen:
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    (d / file).write_text(text)
    return subprocess.Popen([nvcc, *flags, "-shared", "-I", str(csrc), str(d / file),
                             "-o", str(d / "lib.so")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_all(procs: dict, out: Path, entries) -> dict | None:
    """Wait for the builds; load each library with the entries' argtypes
    ((name, pointers, ints) each)."""
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed on {name}:\n{text}", flush=True)
            return None
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        for fn, n_ptr, n_int in entries:
            getattr(lib, fn).argtypes = ((ctypes.c_void_p,) * n_ptr + (ctypes.c_int,) * n_int
                                         + (ctypes.c_void_p,))
        libs[name] = lib
    return libs


def time_ms(launch) -> float:
    """The mean of 4 runs over 3 distinct inputs, the median of 3 windows."""
    import torch

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
    return statistics.median(windows)


def load_port_variants(port: Path, source: str, variants_of, out_name: str,
                        entries) -> dict | None:
    """Import the port from ``port``, build ``variants_of`` its csrc/``source``
    (one library each, under build/``out_name``) and load them; None on a
    failure."""
    sys.path.insert(0, str(port))
    import multimodal_segmentation_project_tpu_torch as pkg
    from multimodal_segmentation_project_tpu_torch.ops import _build

    if not Path(pkg.__file__).resolve().is_relative_to(port):
        print(f"port imported from {pkg.__file__}, not from {port}", flush=True)
        return None
    src = _build.CSRC / source
    print(f"[dissect] {source} from {src}", flush=True)
    out = port / "build" / out_name
    nvcc = _build.find_nvcc()
    procs = {name: build(name, text, _build.CSRC, nvcc, _build.NVCC_FLAGS, out, source)
             for name, text in variants_of(src.read_text()).items()}
    return load_all(procs, out, entries)


def time_variants(libs: dict, launch_of) -> dict | None:
    """{variant: ms} of ``launch_of(lib)``'s bare launches (time_ms) after a
    warm-up over the 3 inputs; None if a launch is refused."""
    import torch

    times = {}
    for name, lib in libs.items():
        launch = launch_of(lib)
        if any(launch(i) != 0 for i in range(3)):
            print(f"{name}: launch refused", flush=True)
            return None
        torch.cuda.synchronize()
        times[name] = time_ms(launch)
    return times


def main_f32(port: Path) -> int:
    """The fp32 dW body's variants at the fp32 train step's 11 dW shapes."""
    def variants_of(src):
        design = "3xtf32" if "mma.sync.aligned.m16n8k8" in src else "ffma"
        return with_parts(src, F32_PARTS[design], f"conv3_dw_f32.cu ({design})")

    libs = load_port_variants(port, "conv3_dw_f32.cu", variants_of, "dw_dissect_f32",
                              (("mmseg_conv3_dw_f32", 4, 11),
                               ("mmseg_conv3_dw_f32_prologue", 6, 11)))
    if libs is None:
        return 1
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import conv3

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    per_step = {(k, name): 0.0 for k in (2, 6) for name in libs}
    for cin, cout, s, pro in F32_SHAPES:
        xs = [torch.randn(1, cin, s, s, s, generator=gen, device=dev) for _ in range(3)]
        gs = [torch.randn(1, cout, s, s, s, generator=gen, device=dev) for _ in range(3)]
        a, t = torch.rand(1, cin, device=dev) + 0.5, torch.randn(1, cin, device=dev)
        partial, dw, args = conv3.dw_f32_operands("dw_dissect", xs[0], gs[0])

        def launch_of(lib):
            def launch(i):
                head = (xs[i].data_ptr(), gs[i].data_ptr())
                tail = (partial.data_ptr(), dw.data_ptr(), *args, stream)
                if pro:
                    return lib.mmseg_conv3_dw_f32_prologue(*head, a.data_ptr(), t.data_ptr(),
                                                           *tail)
                return lib.mmseg_conv3_dw_f32(*head, *tail)
            return launch

        times = time_variants(libs, launch_of)
        if times is None:
            return 1
        kernel = 6 if pro else 2
        for name, ms in times.items():
            per_step[kernel, name] += ms
        print(f"[dw-dissect] fp32 kernel {kernel} {cin}->{cout} @{s}^3, ms: "
              + " | ".join(f"{name} {ms:.4f}" for name, ms in times.items()), flush=True)
        del xs, gs
        torch.cuda.empty_cache()
    for kernel in (2, 6):
        print(f"[dw-dissect] fp32 kernel {kernel} per train step, ms: " + " | ".join(
            f"{name} {per_step[kernel, name]:.4f}" for name in libs), flush=True)
    return 0


def main_conv_f32(port: Path) -> int:
    """The fp32 conv body's variants: 7-fp32 over the fp32 eval forward, 12-fp32
    over the train step's conv1 shapes."""
    libs = load_port_variants(port, "conv3_f32.cu",
                              lambda src: with_parts(src, CONV_F32_PARTS, "conv3_f32.cu"),
                              "conv_dissect_f32", (("mmseg_conv3_f32_bias_relu", 4, 11),
                                                   ("mmseg_conv3_f32_prologue", 6, 11)))
    if libs is None:
        return 1
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import conv3, conv3_fused

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for kernel, shapes in ((7, CONV_F32_EVAL), (12, CONV_F32_CONV1)):
        per_pass = dict.fromkeys(libs, 0.0)
        for cin, cout, s in shapes:
            xs = [torch.randn(1, cin, s, s, s, generator=gen, device=dev) for _ in range(3)]
            w = torch.randn(3, 3, 3, cin, cout, generator=gen, device=dev) * (2 / (27 * cin)) ** 0.5
            b = torch.randn(cout, generator=gen, device=dev) * 0.1
            a, t = torch.rand(1, cin, device=dev) + 0.5, torch.randn(1, cin, device=dev)
            if kernel == 7:
                calls = [conv3.relu_f32_call(x, w, b) for x in xs]
            else:
                calls = [conv3_fused.boundary_call(x, w, b, a, t) for x in xs]

            def launch_of(lib):
                fn = getattr(lib, calls[0].entry)
                return lambda i: fn(*calls[i].args, stream)

            times = time_variants(libs, launch_of)
            if times is None:
                return 1
            for name, ms in times.items():
                per_pass[name] += ms
            print(f"[conv-dissect] fp32 kernel {kernel} {cin}->{cout} @{s}^3, ms: "
                  + " | ".join(f"{name} {ms:.4f}" for name, ms in times.items()), flush=True)
            del xs, calls
            torch.cuda.empty_cache()
        print(f"[conv-dissect] fp32 kernel {kernel} per pass, ms: " + " | ".join(
            f"{name} {ms:.4f}" for name, ms in per_pass.items()), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is false", flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    args = sys.argv[1:]
    port = Path(args[args.index("--port") + 1]).resolve() if "--port" in args else ROOT
    if "--conv-f32" in args:
        return main_conv_f32(port)
    if "--fp32" in args:
        return main_f32(port)

    from multimodal_segmentation_project_tpu_torch.ops import _build, conv3

    nvcc = _build.find_nvcc()
    procs = {name: build(name, text, _build.CSRC, nvcc, _build.NVCC_FLAGS)
             for name, text in variants((_build.CSRC / "conv3_dw.cu").read_text()).items()}
    libs = load_all(procs, OUT, (("mmseg_conv3_dw", 4, 7), ("mmseg_conv3_dw_prologue", 6, 7)))
    if libs is None:
        return 1

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for cin, cout, s, pro in SHAPES:
        xs = [torch.randn(1, cin, s, s, s, generator=gen, device=dev).bfloat16() for _ in range(3)]
        gs = [torch.randn(1, cout, s, s, s, generator=gen, device=dev).bfloat16()
              for _ in range(3)]
        a, t = torch.rand(1, cin, device=dev) + 0.5, torch.randn(1, cin, device=dev)
        partial, dw, args = conv3.dw_operands("dw_dissect", xs[0], gs[0])

        def launch_of(lib):
            def launch(i):
                head = (xs[i].data_ptr(), gs[i].data_ptr())
                tail = (partial.data_ptr(), dw.data_ptr(), *args, stream)
                if pro:
                    return lib.mmseg_conv3_dw_prologue(*head, a.data_ptr(), t.data_ptr(), *tail)
                return lib.mmseg_conv3_dw(*head, *tail)
            return launch

        times = time_variants(libs, launch_of)
        if times is None:
            return 1
        kernel = 6 if pro else 2
        print(f"[dw-dissect] kernel {kernel} {cin}->{cout} @{s}^3, ms: "
              + " | ".join(f"{name} {ms:.4f}" for name, ms in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
