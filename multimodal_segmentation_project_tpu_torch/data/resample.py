"""Offline resampling: RAS reorient -> 1 mm isotropic -> 192^3.

The port's copy of ``multimodal_segmentation_project_tpu/data/resample.py``
(the reference preprocessing recipe): reorient to RAS+, zoom to 1 mm
isotropic spacing (cubic for images, nearest for labels), zoom to the
192^3 grid, crop or edge-pad an off-by-one, and rewrite the affine to
diag(spacing) with the original translation. Two backends:

* ``scipy``: ``scipy.ndimage.zoom`` on the host (order 3 without
  prefilter, or 0; mode ``nearest``), the JAX package's code, bit for bit;
* ``torch``: the counterpart of the JAX package's ``_zoom_jax``
  (``jax.image.resize``, antialias on), on a GPU by default (``device``).
  Each axis whose size changes is contracted with a dense weight matrix,
  built as ``jax/_src/image/scale.py:compute_weight_mat`` builds it (jax
  0.9), all in float32 as JAX computes it with x64 off: half-pixel centres,
  Keys' cubic kernel (a = -0.5) widened by max(in/out, 1) so that
  downsampling low-pass filters, columns normalised to sum 1 (zero where
  the sum is under 1000 eps), and columns whose sample falls outside
  [-0.5, n - 0.5] zeroed; with XLA's fused multiply-adds and its
  reciprocal for the division by the kernel scale, so that the weights
  agree with JAX's on the CPU to a few float32 ulps of 1 (the column sums
  run in another order). The contraction is an fp32 ``tensordot`` with
  TF32 off for the call. Labels take ``jax.image``'s nearest neighbour,
  index floor((i + 0.5) * in / out) computed in float32 as XLA computes it
  (JAX keeps float32 there on purpose: float64 picks other indices at the
  boundaries, and so would another rounding).
  Like JAX with x64 off, 64-bit inputs are taken as 32-bit and the result
  is cast back to the input's dtype. Between the two zooms the volume
  stays on the device.

``torch`` is the default, on the GPU, and raises where there is none
unless the caller passes ``device="cpu"``. It is not the scipy backend:
Keys' cubic convolution is not a non-prefiltered cubic B-spline, so pass
``backend="scipy"`` (the JAX package's default) where bit parity with the
JAX package's scipy output and reference-trained models matters.

Also the TotalSegmentator per-organ mask merge: spleen 1, liver 2, left and
right kidney 3.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from multimodal_segmentation_project_tpu_torch.data.nifti import (
    NiftiImage,
    load_nifti,
    reorient_to_ras,
    save_nifti,
    voxel_spacing,
)

TARGET_SPACING = (1.0, 1.0, 1.0)
TARGET_SHAPE = (192, 192, 192)
BACKENDS = ("scipy", "torch")

# TotalSegmentator mask filenames -> harmonized class
TOTALSEG_ORGANS = {
    "spleen": 1,
    "liver": 2,
    "kidney_left": 3,
    "kidney_right": 3,
}

# what JAX with x64 off makes of a 64-bit array
_X64_OFF = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
            np.dtype(np.uint64): np.uint32}
# unsigned dtypes torch cannot index: gathered as the signed type of their width
_AS_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}
EPS32 = float(np.finfo(np.float32).eps)


def _zoom_scipy(data: np.ndarray, factors, order: int) -> np.ndarray:
    from scipy.ndimage import zoom

    return zoom(data, factors, order=order, mode="nearest", prefilter=False)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c of float32 ``a`` and float32 values ``b``, ``c``, rounded
    once to float32: the fused multiply-add XLA emits for a multiply and an
    add (the float64 product of two float32 values is exact)."""
    return (a.double() * (b.double() if isinstance(b, torch.Tensor) else b) + c).float()


def cubic_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s cubic
    method, antialiased, for one axis: ``compute_weight_mat`` with Keys'
    kernel, a = -0.5, as XLA compiles it (jax 0.9, x64 off). Its
    multiply-adds are fused, and its division by the kernel scale is a
    multiplication by the float32 reciprocal, folded into the kernel's
    constants: 1.5 x - 2.5 is fma(|d|, 1.5 / s, -2.5), and so on."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)  # Python floats, as JAX takes them
    recip = f32(1.0) / f32(max(inv_scale, 1.0))  # 1 / kernel scale
    centres = torch.arange(out_size, dtype=torch.float32, device=device) + 0.5
    sample_f = _fma(centres, float(f32(inv_scale)), -0.5)
    d = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]
         ).abs()
    x = d * float(recip)
    near = _fma(_fma(d, float(f32(1.5 * recip)), -2.5) * x, x, 1.0)  # |x| < 1
    far = _fma(_fma(_fma(d, float(f32(-0.5 * recip)), 2.5), x, -4.0), x, 2.0)  # 1 <= |x| < 2
    zero = torch.zeros((), dtype=torch.float32, device=device)
    weights = torch.where(x >= 2.0, zero, torch.where(x >= 1.0, far, near))
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * EPS32,
                          weights / torch.where(total != 0, total, torch.ones_like(total)), zero)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, zero)


def nearest_indices(in_size: int, out_size: int, device) -> torch.Tensor:
    """``jax.image``'s nearest source index of each output index:
    floor((i + 0.5) * in / out) in float32, as XLA compiles it (the division
    by a constant becomes a multiplication by its float32 reciprocal, folded
    with ``in``: (i + 0.5) * f32(in * f32(1 / out)))."""
    f32 = np.float32
    step = float(f32(f32(in_size) * (f32(1.0) / f32(out_size))))
    offsets = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * step
    return torch.floor(offsets).to(torch.int64).clamp_(max=in_size - 1)  # JAX's gather clamps


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def zoom_torch(x: torch.Tensor, factors, order: int) -> torch.Tensor:
    """``jax.image.resize(x, round(shape * factors), 'cubic' or 'nearest')``
    of a tensor, on its device. Axes whose size is unchanged are skipped,
    as ``jax.image.resize`` skips them."""
    out_shape = tuple(int(round(s * f)) for s, f in zip(x.shape, factors))
    for d, (m, n) in enumerate(zip(x.shape, out_shape)):
        if m == n:
            continue
        if order == 0:
            x = x.index_select(d, nearest_indices(m, n, x.device))
        else:
            with _no_tf32():
                x = torch.tensordot(x, cubic_weights(m, n, x.device), dims=([d], [0]))
            x = x.movedim(-1, d)
    return x


def _upload(data: np.ndarray, order: int, device) -> tuple[torch.Tensor, np.dtype]:
    """``data`` on ``device`` as JAX takes it: 64-bit as 32-bit, and float32
    for the cubic zoom. Returns the tensor and that dtype.

    The JAX package casts an image to float64 on the host, and JAX (x64
    off) to float32. One cast to float32 gives the same values for every
    dtype but 64-bit integers (whose float64 cast already rounds), so an
    image goes up in its own dtype and is cast on the device: the host
    neither writes a float64 copy nor uploads one."""
    if order != 0:
        if data.dtype.kind in "iu" and data.dtype.itemsize == 8:
            data = data.astype(np.float64)
        elif data.dtype.kind == "u" and data.dtype.itemsize > 1:
            data = data.astype(np.float32)  # torch's wider unsigned types cast poorly
        t = torch.from_numpy(np.ascontiguousarray(data)).to(device)
        return t.to(torch.float32), np.dtype(np.float32)
    canon = data.astype(_X64_OFF.get(data.dtype, data.dtype), copy=False)
    # a gather moves bits: uint16 and uint32 go as the signed type of their width
    signed = canon.view(_AS_SIGNED.get(canon.dtype, canon.dtype))
    return torch.from_numpy(np.ascontiguousarray(signed)).to(device), canon.dtype


def _download(x: torch.Tensor, canon: np.dtype, out_dtype: np.dtype) -> np.ndarray:
    """The inverse of :func:`_upload`, cast to ``out_dtype`` as ``_zoom_jax``
    casts its result to the input's dtype."""
    return x.cpu().numpy().view(canon).astype(out_dtype, copy=False)


def resolve_device(device) -> torch.device:
    """The torch backend's device: never a silent fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this machine. The torch backend runs on a "
                           "GPU; pass device 'cpu' (--device cpu) to run it on the CPU.")
    return device


def resample_volume(
    img: NiftiImage,
    is_label: bool = False,
    target_spacing=TARGET_SPACING,
    target_shape=TARGET_SHAPE,
    backend: str = "torch",
    device="cuda",
):
    """RAS reorient + two-stage zoom to target spacing then shape.

    Returns (data, new_affine). The reference's two zoom calls (spacing
    first, then the exact-shape resize), not one fused resample. ``device``
    is the torch backend's.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of {BACKENDS}")
    order = 0 if is_label else 3

    img = reorient_to_ras(img)
    out_dtype = np.dtype(np.float64) if not is_label else img.data.dtype
    spacing = voxel_spacing(img.affine)

    scale = spacing / np.asarray(target_spacing, dtype=np.float64)
    if backend == "scipy":
        data = _zoom_scipy(img.data.astype(out_dtype), scale, order)
        resize = [t / s for t, s in zip(target_shape, data.shape)]
        data = _zoom_scipy(data, resize, order)
    else:
        x, dtype = _upload(img.data, order, resolve_device(device))
        x = zoom_torch(x, scale, order)
        resize = [t / s for t, s in zip(target_shape, x.shape)]
        data = _download(zoom_torch(x, resize, order), dtype, out_dtype)
    # guard off-by-one from rounding
    data = data[: target_shape[0], : target_shape[1], : target_shape[2]]
    if data.shape != tuple(target_shape):
        pad = [(0, t - s) for t, s in zip(target_shape, data.shape)]
        data = np.pad(data, pad, mode="edge")

    new_affine = np.array(img.affine, copy=True)
    new_affine[:3, :3] = np.diag(target_spacing)
    return data, new_affine


def process_pair(
    image_path: str,
    output_path: str,
    label_path: str | None = None,
    label_out_path: str | None = None,
    backend: str = "torch",
    verbose: bool = True,
    device="cuda",
) -> None:
    img = load_nifti(image_path)
    if verbose:
        print(f"Processing {os.path.basename(image_path)}: shape {img.data.shape}, "
              f"spacing {np.round(voxel_spacing(img.affine), 3)}")
    data, affine = resample_volume(img, is_label=False, backend=backend, device=device)
    save_nifti(data.astype(np.float32), output_path, affine)

    if label_path and os.path.exists(label_path) and label_out_path:
        lbl = load_nifti(label_path)
        ldata, laffine = resample_volume(lbl, is_label=True, backend=backend, device=device)
        save_nifti(ldata.astype(np.uint8), label_out_path, laffine)
    elif label_path and verbose:
        print(f"  label missing for {image_path}, skipping label")


def merge_totalseg_masks(mask_dir: str, backend: str = "torch") -> NiftiImage:
    """Merge TotalSegmentator per-organ binary masks into one label map
    (resample_totalseg_ras_mri.py:77-96). ``backend`` is unused, as in the
    JAX package."""
    merged = None
    affine = None
    for organ, cls in TOTALSEG_ORGANS.items():
        path = None
        for ext in (".nii.gz", ".nii"):
            cand = os.path.join(mask_dir, organ + ext)
            if os.path.exists(cand):
                path = cand
                break
        if path is None:
            continue
        m = load_nifti(path)
        if merged is None:
            merged = np.zeros(m.data.shape, dtype=np.uint8)
            affine = m.affine
        merged[m.data > 0] = cls
    if merged is None:
        raise FileNotFoundError(f"no organ masks found in {mask_dir}")
    return NiftiImage(data=merged, affine=affine)


def resample_dataset(
    input_dir: str,
    output_dir: str,
    labels_dir: str | None = None,
    labels_out_dir: str | None = None,
    backend: str = "torch",
    device="cuda",
) -> int:
    """Resample every NIfTI under input_dir (reference script main loop)."""
    os.makedirs(output_dir, exist_ok=True)
    if labels_out_dir:
        os.makedirs(labels_out_dir, exist_ok=True)
    n = 0
    for filename in sorted(os.listdir(input_dir)):
        if not (filename.endswith(".nii") or filename.endswith(".nii.gz")):
            continue
        process_pair(
            os.path.join(input_dir, filename),
            os.path.join(output_dir, filename),
            label_path=os.path.join(labels_dir, filename) if labels_dir else None,
            label_out_path=(
                os.path.join(labels_out_dir, filename) if labels_out_dir else None
            ),
            backend=backend,
            device=device,
        )
        n += 1
    return n
