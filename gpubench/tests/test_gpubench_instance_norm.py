"""``metrics/instance_norm_ms.train.py`` on synthetic trace summaries: the
device ms a step of the kernels named ``instance_norm``, and nothing where
the trace holds none or the window is not a training one."""

from types import SimpleNamespace

import pytest

from gpubench import common

NAME = "instance_norm_ms.train"


def test_reader_sums_the_instance_norm_kernels():
    reader = common.load_module(common.BENCH_DIR / "metrics" / f"{NAME}.py", NAME)
    kernels = [("instance_norm_moments", "elementwise", 0.004),
               ("instance_norm_bwd_apply", "elementwise", 0.006),
               ("window_attn_fwd", "elementwise", 1.0),
               ("void at::native::RowwiseMomentsCUDAKernel<float>", "elementwise", 2.0)]
    layer = {"kind": "train", "trace": SimpleNamespace(kernels=kernels), "units": 2}
    assert reader.read(layer) == pytest.approx(5.0)
    assert reader.read({**layer, "kind": "eval"}) is None
    assert reader.read({**layer, "units": 0}) is None
    assert reader.read({**layer, "trace": None}) is None
    assert reader.read({**layer, "trace": SimpleNamespace(kernels=kernels[2:])}) is None
    entry = next(m for m in common.benchmark()["per_layer"] if m["name"] == NAME)
    assert entry == {"name": NAME, "unit": "ms/step", "better": "lower", "source": "device_trace",
                     "layer": "kernels", "moves": "train_samples_per_s",
                     "workloads": ["swin-unetr-bf16.train"]}
