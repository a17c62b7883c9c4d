"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use into one shared library with
a plain C interface, which is then loaded with ``ctypes``. The sources
compile in parallel, one ``nvcc`` process each, and one more call links
them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -Xptxas -v -c csrc/<name>.cu -o <name>.o               (all at once)
    nvcc -shared -o build/torch_kernels/libmmseg_kernels_<hash>.so *.o

What the compilers print (ptxas's registers, spills and static shared
memory of every kernel) is kept beside the library in ``<name>.log``.

The library lands in ``build/torch_kernels/`` at the root of the checkout
under a name keyed by a hash of the sources and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is. Nothing is
built or loaded when this module is imported.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` calls one on a tensor's device and stream and raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, spills and static shared memory, to the log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of every C entry point (restype is int: a cudaError_t)
_SIGNATURES = {
    "mmseg_conv3_bias_relu": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_conv3_f32_bias_relu": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _P),
    "mmseg_conv3_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_conv3_f32_prologue": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _P),
    "mmseg_conv3_f32_stats": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _P),
    "mmseg_conv3_f32_prologue_stats": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _I, _I, _P),
    "mmseg_conv3_f32_dx_epilogue": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _P),
    "mmseg_conv3": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_conv3_prologue": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_conv3_stats": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_conv3_prologue_stats": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_conv3_dx_epilogue": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_conv3_dw": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_conv3_dw_prologue": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_conv3_dw_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_conv3_dw_f32_prologue": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _P),
    "mmseg_pool2x": (_P, _P, _I, _I, _I, _I, _I, _P),
    "mmseg_pool2x_f32": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_pool2x_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "mmseg_pool2x_bwd_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_upconv_d2s": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "mmseg_head1x1": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _P),
    "mmseg_head1x1_f32": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, ctypes.c_longlong, _I,
                          _I, _P),
    "mmseg_head1x1_dx": (_P, _P, _P, _I, _I, _I, ctypes.c_longlong, _P),
    "mmseg_head1x1_dx_f32": (_P, _P, _P, _I, _I, _I, ctypes.c_longlong, ctypes.c_longlong, _I,
                             _P),
    "mmseg_head1x1_dw": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I, _P),
    "mmseg_head1x1_dw_f32": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I, _I, _I, _P),
}
# name -> argtypes of the C functions that launch nothing (restype int)
_QUERIES = {"mmseg_conv3_smem_bytes": (_I, _I), "mmseg_conv3_f32_smem_bytes": (_I, _I),
            "mmseg_conv3_dw_smem_bytes": (_I,), "mmseg_conv3_dw_f32_smem_bytes": (),
            "mmseg_upconv_smem_bytes": (_I,)}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it failed on the kernel sources."""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmmseg_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin or /usr/local/cuda/bin): "
        "the port's CUDA kernels cannot be built on this machine"
    )


def build_log_path() -> Path:
    """nvcc's output (ptxas's resource lines) of the library's build."""
    return library_path().with_suffix(".log")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise with the output of the first
    that fails, else return what they all printed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}\n{err}"
            )
    return "".join(out + err for out, err in outs)


def build() -> Path:
    """Compile the library if no build of the current sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(sources, objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        build_log_path().write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in {**_SIGNATURES, **_QUERIES}.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mmseg_error_string.argtypes = (ctypes.c_int,)
            lib.mmseg_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, code: int) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if code != 0:
        text = load().mmseg_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {text}")


def require(name: str, t, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank
    ``ndim``: what the kernel behind ``name`` takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected a rank-{ndim} tensor, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


class Launch(NamedTuple):
    """One call of a kernel's C entry point, ready to run: its C arguments
    before the stream, what the wrapper returns, and every tensor the
    arguments point into (alive while this is). The ops' ``*_call``
    builders make one with its operands packed and its outputs allocated,
    so that a timing can launch it bare."""

    entry: str
    args: tuple
    result: object
    tensors: tuple


def run(name: str, call: Launch, t):
    """Launch ``call`` on the device of ``t``; return its result."""
    launch(name, call.entry, t, *call.args)
    return call.result


def launch(name: str, entry: str, t, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current stream,
    on the device of ``t``; raise if the launch reported a CUDA error."""
    import torch

    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(name, getattr(load(), entry)(*args, stream))
