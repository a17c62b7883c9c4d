"""The port's resampling stage (``data/resample.py``, ``workloads/resample.py``)
against the JAX package's ``data/resample.py`` on the CPU:

* the torch backend's per-axis cubic weights against ``jax.image``'s
  ``compute_weight_mat`` within 4 float32 ulps of 1 (XLA fuses the
  multiply-adds, which the port emulates, and sums the columns in its own
  order; a wrong antialias scale is off by 1e-2 and more), and its nearest
  indices equal;
* ``zoom_torch`` against ``_zoom_jax`` within 1e-5 * max |x| for up-, down-
  and mixed anisotropic zooms, one shrinking axis, odd sizes; labels
  bit-equal in every dtype;
* ``resample_volume``: the torch backend against the JAX backend (images
  within 1e-5 * max |x|, labels equal), the scipy backend bit-equal to the
  JAX package's, shapes and affines;
* ``resample_dataset``, ``merge_totalseg_masks`` and the CLI as
  ``tests/test_resample.py`` tests the JAX package's, and the CLI's
  refusal of the GPU where there is none.
"""

import jax
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

from multimodal_segmentation_project_tpu.data import resample as jax_rs
from multimodal_segmentation_project_tpu_torch.data import NiftiImage, load_nifti, save_nifti
from multimodal_segmentation_project_tpu_torch.data import resample as rs
from multimodal_segmentation_project_tpu_torch.workloads import resample as cli
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

ULP1 = 2.0 ** -23  # a float32 ulp of 1


@pytest.mark.parametrize("m,n", [(20, 32), (33, 17), (512, 399), (399, 192), (160, 400),
                                 (7, 21), (13, 5), (61, 97), (100, 99), (3, 40), (2, 41),
                                 (14, 16), (25, 16)])
def test_cubic_weights_and_nearest_indices_are_jaxs(m, n):
    want = np.asarray(jax.jit(lambda: compute_weight_mat(
        m, n, n / m, 0.0, _fill_keys_cubic_kernel, True))())
    got = rs.cubic_weights(m, n, "cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    assert np.abs(got - want).max() <= 4 * ULP1
    # the indices jax.image.resize's nearest method gathers (a jitted resize)
    want_idx = np.asarray(jax.image.resize(jax.numpy.arange(m, dtype=np.int32), (n,), "nearest"))
    np.testing.assert_array_equal(rs.nearest_indices(m, n, "cpu").numpy(), want_idx)


@pytest.mark.parametrize("shape,factors", [
    ((12, 10, 8), (2.0, 1.5, 3.0)),        # up
    ((40, 36, 30), (0.5, 0.37, 0.8)),      # down (antialiased)
    ((32, 32, 12), (0.78, 0.78, 2.5)),     # a CT scan's mix: in-plane down, slices up
    ((17, 9, 31), (1.0, 0.5, 1.0)),        # one axis shrinks, two stay
    ((23, 19, 29), (1.37, 0.61, 1.13)),    # odd sizes
])
def test_zoom_torch_matches_zoom_jax(shape, factors):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0.0, 300.0, size=shape)
    want = jax_rs._zoom_jax(x, factors, 3)
    got = rs.zoom_torch(torch.from_numpy(x.astype(np.float32)), factors, 3).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for dtype in (np.uint8, np.int16, np.uint16, np.int32, np.int64, np.float64):
        lbl = rng.integers(0, 5, size=shape).astype(dtype)
        want = jax_rs._zoom_jax(lbl, factors, 0)
        x_t, canon = rs._upload(lbl, 0, "cpu")
        got = rs._download(rs.zoom_torch(x_t, factors, 0), canon, lbl.dtype)
        assert got.dtype == want.dtype == lbl.dtype
        np.testing.assert_array_equal(got, want)


def _ct_case(shape=(40, 36, 16), spacing=(0.78, 0.78, 2.5), seed=0, dtype=np.int16):
    """An anisotropic, LPS-flipped CT-like volume (int16 HU) and its labels."""
    rng = np.random.default_rng(seed)
    img = rng.normal(40.0, 200.0, size=shape)
    img = (img - img.min() if np.dtype(dtype).kind == "u" else img).astype(dtype)
    lbl = np.zeros(shape, np.uint8)
    lbl[5:20, 8:30, 3:12] = 2
    lbl[22:35, 4:14, 6:10] = 1
    affine = np.diag([-spacing[0], -spacing[1], spacing[2], 1.0])
    affine[:3, 3] = (10.0, -4.0, 7.5)
    return NiftiImage(data=img, affine=affine), NiftiImage(data=lbl, affine=affine)


@pytest.mark.parametrize("target,dtype", [((24, 24, 24), np.int16), ((23, 31, 29), np.int16),
                                          ((24, 24, 24), np.uint16), ((24, 24, 24), np.float32),
                                          ((24, 24, 24), np.int64), ((24, 24, 24), np.float64)])
def test_resample_volume_torch_matches_the_jax_backend(target, dtype):
    img, lbl = _ct_case(dtype=dtype)
    want, want_aff = jax_rs.resample_volume(img, target_shape=target, backend="jax")
    got, got_aff = rs.resample_volume(img, target_shape=target, backend="torch", device="cpu")
    assert got.shape == want.shape == target and got.dtype == want.dtype == np.float64
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(got_aff, want_aff)
    want, _ = jax_rs.resample_volume(lbl, is_label=True, target_shape=target, backend="jax")
    got, _ = rs.resample_volume(lbl, is_label=True, target_shape=target, backend="torch",
                                device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("is_label", [False, True])
def test_the_scipy_backend_is_the_jax_packages_bit_for_bit(is_label):
    img, lbl = _ct_case(seed=3)
    src = lbl if is_label else img
    want, want_aff = jax_rs.resample_volume(src, is_label=is_label, target_shape=(20, 22, 24))
    got, got_aff = rs.resample_volume(src, is_label=is_label, target_shape=(20, 22, 24),
                                      backend="scipy")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_aff, want_aff)


def test_an_unknown_backend_and_a_missing_gpu_are_refused():
    img, _ = _ct_case()
    with pytest.raises(ValueError, match="unknown backend"):
        rs.resample_volume(img, backend="jax")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot show")
    with pytest.raises(RuntimeError, match="--device cpu"):
        rs.resample_volume(img)  # the default: the torch backend on the GPU


# ---- the dataset loop, the TotalSegmentator merge and the CLI ---------------------------


def _write_pair(img_dir, lbl_dir, name, seed):
    img, lbl = _ct_case(shape=(20, 18, 10), seed=seed)
    save_nifti(img.data, str(img_dir / name), img.affine)
    save_nifti(lbl.data, str(lbl_dir / name), lbl.affine)


@pytest.mark.parametrize("backend", ["scipy", "torch"])
def test_resample_dataset_as_the_jax_package(tmp_path, monkeypatch, backend):
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    for i in range(2):
        _write_pair(tmp_path / "images", tmp_path / "labels", f"c{i}.nii.gz", seed=i)
    (tmp_path / "images" / "notes.txt").write_text("not a volume")
    target = (16, 16, 16)
    monkeypatch.setattr(rs.resample_volume, "__defaults__",
                        (False, rs.TARGET_SPACING, target, "torch", "cuda"))
    n = rs.resample_dataset(str(tmp_path / "images"), str(tmp_path / "out_img"),
                            str(tmp_path / "labels"), str(tmp_path / "out_lbl"),
                            backend=backend, device="cpu")
    assert n == 2
    for i in range(2):
        src = load_nifti(str(tmp_path / "images" / f"c{i}.nii.gz"))
        out = load_nifti(str(tmp_path / "out_img" / f"c{i}.nii.gz"))
        want, aff = jax_rs.resample_volume(src, target_shape=target,
                                           backend="jax" if backend == "torch" else "scipy")
        assert out.data.dtype == np.float32 and out.data.shape == target
        np.testing.assert_allclose(out.data, want.astype(np.float32), rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(out.affine[:3, :3], np.eye(3), atol=1e-6)
        lbl = load_nifti(str(tmp_path / "out_lbl" / f"c{i}.nii.gz"))
        want, _ = jax_rs.resample_volume(load_nifti(str(tmp_path / "labels" / f"c{i}.nii.gz")),
                                         is_label=True, target_shape=target,
                                         backend="jax" if backend == "torch" else "scipy")
        assert lbl.data.dtype == np.uint8
        np.testing.assert_array_equal(lbl.data, want.astype(np.uint8))


def test_merge_totalseg_masks(tmp_path):
    shape = (8, 8, 8)
    for organ in ["spleen", "liver", "kidney_left", "kidney_right"]:
        m = np.zeros(shape, np.uint8)
        if organ == "spleen":
            m[0:2] = 1
        elif organ == "liver":
            m[2:4] = 1
        else:
            m[4:6] = 1
        save_nifti(m, str(tmp_path / f"{organ}.nii.gz"), np.eye(4))
    merged = rs.merge_totalseg_masks(str(tmp_path))
    np.testing.assert_array_equal(merged.data, jax_rs.merge_totalseg_masks(str(tmp_path)).data)
    assert set(np.unique(merged.data)) == {0, 1, 2, 3}
    with pytest.raises(FileNotFoundError):
        rs.merge_totalseg_masks(str(tmp_path / "nothing"))


def test_cli_resamples_a_totalseg_layout_on_the_torch_backend(tmp_path, monkeypatch):
    monkeypatch.setattr(rs.resample_volume, "__defaults__",
                        (False, rs.TARGET_SPACING, (12, 12, 12), "torch", "cuda"))
    images, masks = tmp_path / "images", tmp_path / "segs"
    images.mkdir()
    img, lbl = _ct_case(shape=(14, 12, 8), seed=5)
    save_nifti(img.data, str(images / "case0.nii.gz"), img.affine)
    (masks / "case0").mkdir(parents=True)
    for organ, cls in (("liver", 2), ("spleen", 1)):
        save_nifti((lbl.data == cls).astype(np.uint8), str(masks / "case0" / f"{organ}.nii.gz"),
                   lbl.affine)
    n = cli.main(["--input_dir", str(images), "--output_dir", str(tmp_path / "out"),
                  "--merge_masks_root", str(masks), "--labels_out_dir", str(tmp_path / "lbl"),
                  "--backend", "torch", "--device", "cpu"])
    assert n == 1
    out = load_nifti(str(tmp_path / "lbl" / "case0.nii.gz"))
    assert out.data.shape == (12, 12, 12) and set(np.unique(out.data)) <= {0, 1, 2}
    assert load_nifti(str(tmp_path / "out" / "case0.nii.gz")).data.shape == (12, 12, 12)
    if not torch.cuda.is_available():  # the default backend is torch, on the GPU
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["--input_dir", str(images), "--output_dir", str(tmp_path / "o2")])
    with pytest.raises(SystemExit):  # the JAX CLI's backend name is not the port's
        cli.main(["--input_dir", str(images), "--output_dir", str(tmp_path / "o3"),
                  "--backend", "jax"])
