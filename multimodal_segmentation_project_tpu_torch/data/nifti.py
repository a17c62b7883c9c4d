"""First-party NIfTI-1 reader/writer (no nibabel dependency).

The reference delegates all NIfTI IO to nibabel
(utils/dataloader.py:149-150, test_model.py:306-309,
scripts/resampling/amos_ct_resample.py:29-36). This framework ships its
own minimal, dependency-free implementation covering everything those
call sites need:

  * .nii and .nii.gz single-file NIfTI-1 ("n+1") read/write
  * dtype codes used by medical volumes (u)int8/16/32, float32/64
  * scl_slope / scl_inter scaling on read
  * affine from sform (preferred) or qform (quaternion) or pixdim
  * header passthrough on save (predictions keep original affine/header,
    matching test_model.py:306-309)
  * RAS reorientation (reorient_to_ras) replicating the
    io_orientation -> axcodes2ornt -> apply_orientation pipeline of the
    reference resampling scripts

Format reference: the public NIfTI-1.1 specification (nifti1.h).
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

HEADER_SIZE = 348
MAGIC_SINGLE = b"n+1\x00"

# NIfTI datatype code -> numpy dtype
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """A loaded NIfTI volume: data + affine + (optional) raw header bytes."""

    data: np.ndarray
    affine: np.ndarray
    header_bytes: bytes | None = None
    extra: dict = field(default_factory=dict)

    @property
    def shape(self):
        return self.data.shape

    def get_fdata(self) -> np.ndarray:
        """nibabel-compatible accessor returning float64 data."""
        return self.data.astype(np.float64)


def _quaternion_to_affine(b, c, d, qx, qy, qz, pixdim):
    """qform quaternion -> 4x4 affine (NIfTI-1 spec, Method 2)."""
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    qfac = 1.0 if pixdim[0] >= 0 else -1.0
    spacing = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
    affine = np.eye(4)
    affine[:3, :3] = R * spacing
    affine[:3, 3] = [qx, qy, qz]
    return affine


def _read_bytes(path: str) -> bytes:
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _parse_affine(raw: bytes, end: str) -> np.ndarray:
    """Affine from the 348-byte header: sform > qform > pixdim fallback."""
    pixdim = struct.unpack_from(end + "8f", raw, 76)
    qform_code, sform_code = struct.unpack_from(end + "2h", raw, 252)
    if sform_code > 0:
        affine = np.eye(4)
        affine[0] = struct.unpack_from(end + "4f", raw, 280)
        affine[1] = struct.unpack_from(end + "4f", raw, 296)
        affine[2] = struct.unpack_from(end + "4f", raw, 312)
        return affine
    if qform_code > 0:
        quat = struct.unpack_from(end + "6f", raw, 256)
        return _quaternion_to_affine(*quat, pixdim)
    return np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])


def _header_endianness(path: str, raw: bytes) -> str:
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    if sizeof_hdr == 348:
        return "<"
    if struct.unpack_from(">i", raw, 0)[0] == 348:
        return ">"
    raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")


def load_nifti_header(path: str) -> tuple[np.ndarray, bytes]:
    """Header-only probe: (affine, raw 348-byte header) without decoding
    the voxel payload.

    The prediction-export path (test_model.py:306-309 semantics) needs
    only the source affine/header to stamp onto the saved prediction;
    for a gzipped 192^3 volume a full decode costs seconds of host
    inflate. ``gzip.GzipFile.read(348)`` decompresses only the leading
    stream blocks, so this is ~constant-time regardless of volume size.
    """
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            raw = f.read(HEADER_SIZE)
    else:
        with open(path, "rb") as f:
            raw = f.read(HEADER_SIZE)
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")
    end = _header_endianness(path, raw)
    return _parse_affine(raw, end), raw


def load_nifti(path: str) -> NiftiImage:
    """Load a .nii or .nii.gz NIfTI-1 file."""
    raw = _read_bytes(path)
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")

    end = _header_endianness(path, raw)

    dim = struct.unpack_from(end + "8h", raw, 40)
    datatype, bitpix = struct.unpack_from(end + "2h", raw, 70)
    (vox_offset,) = struct.unpack_from(end + "f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(end + "2f", raw, 112)

    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + max(ndim, 1)])
    # squeeze trailing singleton dims (4D files with T=1 are common)
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(end)

    offset = int(vox_offset) if vox_offset >= HEADER_SIZE else HEADER_SIZE + 4
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    else:
        data = np.asarray(data)
        if data.dtype.byteorder not in ("=", "|"):
            data = data.astype(data.dtype.newbyteorder("="))

    affine = _parse_affine(raw, end)
    return NiftiImage(data=data, affine=affine, header_bytes=raw[:HEADER_SIZE])


def save_nifti(
    image: np.ndarray | NiftiImage,
    path: str,
    affine: np.ndarray | None = None,
    header: bytes | None = None,
) -> str:
    """Save a volume as single-file NIfTI-1 (.nii or .nii.gz).

    When ``header`` bytes from a source image are given, geometry fields
    are carried over and only shape/dtype/scaling fields are rewritten —
    the analog of nibabel's ``Nifti1Image(data, affine, header)`` used
    for prediction export (test_model.py:306-309).
    """
    if isinstance(image, NiftiImage):
        affine = image.affine if affine is None else affine
        header = image.header_bytes if header is None else header
        image = image.data
    data = np.asarray(image)
    if affine is None:
        affine = np.eye(4)

    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _DTYPE_CODES:
        data = data.astype(np.float32)
    dtype_code = _DTYPE_CODES[np.dtype(data.dtype)]

    hdr = bytearray(header[:HEADER_SIZE]) if header else bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<2h", hdr, 70, dtype_code, data.dtype.itemsize * 8)
    spacing = np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(axis=0))
    if not header:
        struct.pack_into("<8f", hdr, 76, 1.0, *spacing, *([1.0] * 4))
    struct.pack_into("<f", hdr, 108, float(HEADER_SIZE + 4))
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform off, sform on
    struct.pack_into("<4f", hdr, 280, *np.asarray(affine)[0, :4])
    struct.pack_into("<4f", hdr, 296, *np.asarray(affine)[1, :4])
    struct.pack_into("<4f", hdr, 312, *np.asarray(affine)[2, :4])
    hdr[344:348] = MAGIC_SINGLE

    payload = bytes(hdr) + b"\x00\x00\x00\x00" + data.tobytes(order="F")
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=4) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
    return str(path)


def io_orientation(affine: np.ndarray):
    """Greedy axis orientation of an affine: per data axis (world_axis, sign).

    Equivalent in behavior to nibabel.orientations.io_orientation for
    non-degenerate affines (used by the reference's reorient_to_ras,
    scripts/resampling/amos_ct_resample.py:29-36).
    """
    R = np.asarray(affine, dtype=np.float64)[:3, :3]
    mag = np.abs(R)
    ornt = np.zeros((3, 2), dtype=np.int64)
    used_rows: set[int] = set()
    used_cols: set[int] = set()
    for _ in range(3):
        best = (-1.0, -1, -1)
        for i in range(3):
            if i in used_rows:
                continue
            for j in range(3):
                if j in used_cols:
                    continue
                if mag[i, j] > best[0]:
                    best = (mag[i, j], i, j)
        _, i, j = best
        ornt[j] = (i, 1 if R[i, j] > 0 else -1)
        used_rows.add(i)
        used_cols.add(j)
    return ornt


def reorient_to_ras(img: NiftiImage) -> NiftiImage:
    """Reorient a volume to RAS+ axes, updating the affine accordingly."""
    data, affine = img.data, img.affine
    ornt = io_orientation(affine)

    # flip axes with negative direction, then transpose so data axis k
    # maps to world axis k.
    flips = [ax for ax in range(3) if ornt[ax, 1] < 0]
    if flips:
        data = np.flip(data, axis=flips)
    perm = np.argsort(ornt[:, 0])
    data = np.transpose(data, axes=tuple(perm) + tuple(range(3, data.ndim)))

    # rebuild the affine: column permutation + flip offsets
    old_shape = img.data.shape[:3]
    T = np.eye(4)
    for ax in flips:
        T[ax, ax] = -1.0
        T[ax, 3] = old_shape[ax] - 1
    P = np.zeros((4, 4))
    P[3, 3] = 1.0
    for new_ax, old_ax in enumerate(perm):
        P[old_ax, new_ax] = 1.0
    new_affine = affine @ T @ P

    return NiftiImage(
        data=np.ascontiguousarray(data),
        affine=new_affine,
        header_bytes=img.header_bytes,
    )


def voxel_spacing(affine: np.ndarray) -> np.ndarray:
    """Column norms of the 3x3 affine block (mm per voxel per axis)."""
    return np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(axis=0))
