"""Offline resampling CLI: RAS reorient + 1 mm isotropic + 192^3.

Port of ``scripts/resampling/resample.py``: the same flags, with
``--backend {scipy,torch}`` (``torch``, the default, is the counterpart of
the JAX CLI's ``jax`` backend, ``data/resample.py``) and ``--device`` for
the torch backend (default ``cuda``; with no GPU it raises unless
``--device cpu``). ``--backend scipy`` is the host path, bit-equal to the
JAX CLI's default.

    # AMOS CT (amos_ct_resample.py recipe), on the GPU
    python -m multimodal_segmentation_project_tpu_torch.workloads.resample \\
        --input_dir datasets/amos22_ct/images \\
        --output_dir datasets/resampled/train/amos_ras_ct/images \\
        --labels_dir datasets/amos22_ct/labels \\
        --labels_out_dir datasets/resampled/train/amos_ras_ct/labels

    # TotalSegmentator: merge the per-organ masks of <root>/<case>/ first
    python -m multimodal_segmentation_project_tpu_torch.workloads.resample \\
        --input_dir ... --output_dir ... \\
        --merge_masks_root datasets/totalseg/segmentations --labels_out_dir ...
"""

from __future__ import annotations

import argparse
import os

from multimodal_segmentation_project_tpu_torch.data import resample as rs
from multimodal_segmentation_project_tpu_torch.data.nifti import save_nifti


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Offline resampling (PyTorch/CUDA)")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--labels_dir", default=None)
    p.add_argument("--labels_out_dir", default=None)
    p.add_argument("--backend", default="torch", choices=list(rs.BACKENDS),
                   help="torch (default, on --device) or scipy (host, the JAX CLI's bits)")
    p.add_argument(
        "--merge_masks_root", default=None,
        help="TotalSegmentator layout: <root>/<case>/ contains per-organ masks; "
        "merged label maps are resampled into --labels_out_dir",
    )
    p.add_argument("--device", default="cuda",
                   help="the torch backend's device: 'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = rs.resolve_device(args.device) if args.backend == "torch" else None

    if args.merge_masks_root:
        if not args.labels_out_dir:
            raise ValueError("--labels_out_dir required with --merge_masks_root")
        os.makedirs(args.labels_out_dir, exist_ok=True)
        os.makedirs(args.output_dir, exist_ok=True)
        n = 0
        for case in sorted(os.listdir(args.merge_masks_root)):
            case_dir = os.path.join(args.merge_masks_root, case)
            if not os.path.isdir(case_dir):
                continue
            merged = rs.merge_totalseg_masks(case_dir, backend=args.backend)
            ldata, laffine = rs.resample_volume(merged, is_label=True, backend=args.backend,
                                                device=device)
            save_nifti(ldata.astype("uint8"),
                       os.path.join(args.labels_out_dir, f"{case}.nii.gz"), laffine)
            img_path = None
            for ext in (".nii.gz", ".nii"):
                cand = os.path.join(args.input_dir, case + ext)
                if os.path.exists(cand):
                    img_path = cand
                    break
            if img_path:
                rs.process_pair(img_path,
                                os.path.join(args.output_dir, os.path.basename(img_path)),
                                backend=args.backend, device=device)
            print(f"merged + resampled {case}")
            n += 1
        return n

    n = rs.resample_dataset(args.input_dir, args.output_dir, labels_dir=args.labels_dir,
                            labels_out_dir=args.labels_out_dir, backend=args.backend,
                            device=device)
    print(f"Processed {n} volumes.")
    return n


if __name__ == "__main__":
    main()
