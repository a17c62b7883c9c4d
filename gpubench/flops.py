"""Operations and bytes of the UNet3D recipes, counted from the configuration's shapes.

Every 3x3x3 conv (SAME padding, 27 taps a voxel), 2x2x2 stride-2 transpose
conv and the 1x1x1 head is one call; each call's forward, input gradient
(dx) and weight gradient (dW) are counted as 2 * MACs. The first conv takes
no input gradient. Nothing recomputed is counted, and a mesh's halo planes
are not counted: this is the model's work, not the implementation's.

Bytes, for a roofline: each input read once and each output written once,
activations in the compute dtype, a dW written in fp32.

A DANN step is a supervised step on the source volume, the target
volume's whole train-mode forward, the backward of the target's encoder and
bottleneck (its features feed the discriminator), and the discriminator's
three matmul passes on two rows.
"""

from __future__ import annotations

from dataclasses import dataclass

DTYPE_BYTES = {"bf16": 2, "fp16": 2, "fp32": 4}
DISC_HIDDEN = (256, 128, 64, 2)  # the discriminator's widths after its input


@dataclass(frozen=True)
class Call:
    kind: str  # conv3 | upconv | head | linear
    cin: int
    cout: int
    vox_in: int
    vox_out: int
    part: str  # encoder | bottleneck | decoder | head | disc
    first: bool = False


def unet3d_calls(features, size: int, in_channels: int = 1, classes: int = 4) -> list:
    out, cin, s = [], in_channels, size
    for f in features:
        v = s ** 3
        out += [Call("conv3", cin, f, v, v, "encoder", first=not out), Call("conv3", f, f, v, v,
                                                                            "encoder")]
        cin, s = f, s // 2
    b, v = 2 * features[-1], s ** 3
    out += [Call("conv3", features[-1], b, v, v, "bottleneck"), Call("conv3", b, b, v, v,
                                                                     "bottleneck")]
    cin = b
    for f in reversed(features):
        s *= 2
        v = s ** 3
        out += [Call("upconv", cin, f, v // 8, v, "decoder"), Call("conv3", 2 * f, f, v, v,
                                                                   "decoder"),
                Call("conv3", f, f, v, v, "decoder")]
        cin = f
    out.append(Call("head", features[0], classes, size ** 3, size ** 3, "head"))
    return out


def _macs(c: Call) -> int:
    taps = {"conv3": 27, "upconv": 1, "head": 1, "linear": 1}[c.kind]
    return c.vox_out * c.cin * c.cout * taps


def _weights(c: Call) -> int:
    return c.cin * c.cout * {"conv3": 27, "upconv": 8, "head": 1, "linear": 1}[c.kind]


def passes(c: Call, e: int, grad: bool) -> list:
    """[(pass, flops, bytes)] of one call: the forward, then with ``grad`` its
    dW and (unless it is the first conv) its dx."""
    flops = 2 * _macs(c)
    x, y, w = c.vox_in * c.cin * e, c.vox_out * c.cout * e, _weights(c)
    out = [("fwd", flops, x + y + w * e)]
    if grad:
        out.append(("dw", flops, x + y + w * 4))
        if not c.first:
            out.append(("dx", flops, x + y + w * e))
    return out


def step_work(config: dict, step: str) -> list:
    """[(call, pass, flops, bytes)] of one step: ``train``, ``dann`` or
    ``eval`` (the forward alone)."""
    calls = unet3d_calls(config["features"], config["volume_size"], config["in_channels"],
                         config["classes"])
    e = DTYPE_BYTES[config["precision"]]
    out = [(c, *p) for c in calls for p in passes(c, e, grad=step != "eval")]
    if step == "dann":
        for c in calls:  # the target volume
            grad = c.part in ("encoder", "bottleneck")
            out += [(c, *p) for p in passes(c, e, grad=grad)]
        cin = 2 * config["features"][-1]  # the bottleneck's pooled features
        for cout in DISC_HIDDEN:
            c = Call("linear", cin, cout, 2, 2, "disc")
            cin = cout
            out += [(c, *p) for p in passes(c, 4, grad=True)]
    return out


def model_flops(work: list) -> float:
    return float(sum(flops for _, _, flops, _ in work))


def conv_least_seconds(work: list, peak_flops: float, bytes_per_s: float) -> float:
    """The least time of the convolution work (3x3x3 and transpose convs):
    per pass the larger of its FLOPs over the peak and its bytes over the
    memory rate, summed."""
    return float(sum(max(flops / peak_flops, nbytes / bytes_per_s)
                     for c, _, flops, nbytes in work if c.kind in ("conv3", "upconv")))
