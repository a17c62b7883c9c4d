"""Operations and bytes of a SwinUNETR training step, counted from the configuration's shapes.

Every convolution (3x3x3 SAME, the 2x2x2 stride-2 patch embedding, the
1x1x1 residual convs and head), 2x2x2 stride-2 transpose conv, Linear and
window-attention pass of MONAI's SwinUNETR at the configuration's widths
(``models/swin_unetr.py``). A conv, transpose conv or Linear is one call
whose forward, weight gradient (dW) and input gradient (dx) each count
2 * MACs; the first conv of the image (the patch embedding, encoder1's
conv1 and its residual conv) takes no dx. Nothing recomputed is counted.

Windowed attention, each block's (W-MSA or SW-MSA): the queries count over
the N real tokens (the padded tokens' outputs are cropped), the keys and
values over the whole window of n tokens, padded ones included (their
keys and values are the qkv bias): forward 4 N n C FLOPs (q k^T and P v),
backward 10 N n C (the scores again, dP, dS's products dQ and dK, and dV).
Its bytes are the real tokens' q, k, v and output (forward) and q, k, v,
output, dO, dq, dk and dv (backward) in the compute dtype, and the bias
table in fp32 (read forward, and its gradient written backward). A kernel
that skips the padded query rows then cannot read above 100 %.

Bytes of the other calls, for a roofline: each input read once and each
output written once, activations in the compute dtype, a dW in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass

DTYPE_BYTES = {"bf16": 2, "fp16": 2, "fp32": 4}
TABLE_ROWS = (2 * 7 - 1) ** 3  # the relative-position table of MONAI's 7^3 window


@dataclass(frozen=True)
class Op:
    kind: str  # conv | upconv | linear | attn
    cin: int
    cout: int  # attn: the heads
    tokens: int  # output voxels (conv, upconv) or tokens (linear, attn: the real ones)
    taps: int  # weights a MAC reads per output and input channel (27, 8, 1); attn: window tokens
    part: str  # encoder | decoder | head | swin
    first: bool = False


def _window(side: int, window: int) -> int:
    """Tokens a window holds on a cube of ``side`` (MONAI clips the window
    to a smaller volume)."""
    return min(side, window) ** 3


def swin_unetr_ops(config: dict) -> list:
    fs, size, win = config["feature_size"], config["volume_size"], config["window_size"]
    depths, heads = config["depths"], config["num_heads"]
    out = []
    v = size ** 3
    # encoder1 (Res(in -> fs) at full size) and the patch embedding read the image
    out += [Op("conv", config["in_channels"], fs, v, 27, "decoder", first=True),
            Op("conv", fs, fs, v, 27, "decoder"),
            Op("conv", config["in_channels"], fs, v, 1, "decoder", first=True)]
    side = size // config["patch_size"]
    out.append(Op("conv", config["in_channels"], fs, side ** 3, config["patch_size"] ** 3,
                  "swin", first=True))
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c, n_tok = fs * 2 ** i, side ** 3
        for _ in range(depth):
            out += [Op("linear", c, 3 * c, n_tok, 1, "swin"),
                    Op("attn", c, h, n_tok, _window(side, win), "swin"),
                    Op("linear", c, c, n_tok, 1, "swin"),
                    Op("linear", c, config["mlp_ratio"] * c, n_tok, 1, "swin"),
                    Op("linear", config["mlp_ratio"] * c, c, n_tok, 1, "swin")]
        side //= 2
        out.append(Op("linear", 8 * c, 2 * c, side ** 3, 1, "swin"))  # patch merging
    # encoder2..4 on hs0..hs2, encoder10 on hs4
    side = size // config["patch_size"]
    for i in range(3):
        c = fs * 2 ** i
        out += [Op("conv", c, c, (side >> i) ** 3, 27, "decoder")] * 2
    c4 = fs * 16
    out += [Op("conv", c4, c4, (side >> 4) ** 3, 27, "decoder")] * 2
    # up blocks: decoder5 (16fs -> 8fs) ... decoder1 (fs -> fs)
    cin, s = c4, side >> 4
    for cout in (8 * fs, 4 * fs, 2 * fs, fs, fs):
        s *= 2
        vox = s ** 3
        out += [Op("upconv", cin, cout, vox, 1, "decoder"),
                Op("conv", 2 * cout, cout, vox, 27, "decoder"),
                Op("conv", cout, cout, vox, 27, "decoder"),
                Op("conv", 2 * cout, cout, vox, 1, "decoder")]
        cin = cout
    out.append(Op("conv", fs, config["classes"], v, 1, "head"))
    return out


def passes(op: Op, e: int) -> list:
    """[(pass, flops, bytes)] of one op in a training step."""
    if op.kind == "attn":
        n, c = op.tokens, op.cin
        table = TABLE_ROWS * op.cout * 4
        return [("fwd", 4 * n * op.taps * c, 4 * n * c * e + table),
                ("bwd", 10 * n * op.taps * c, 8 * n * c * e + 2 * table)]
    tokens_in = op.tokens // 8 if op.kind == "upconv" else op.tokens
    if op.kind == "conv" and op.taps == 8:  # the stride-2 patch embedding reads 8 voxels an output
        tokens_in = op.tokens * 8
    macs = op.tokens * op.cin * op.cout * op.taps
    weights = op.cin * op.cout * (8 if op.kind == "upconv" else op.taps)
    x, y = tokens_in * op.cin * e, op.tokens * op.cout * e
    out = [("fwd", 2 * macs, x + y + weights * e), ("dw", 2 * macs, x + y + weights * 4)]
    if not op.first:
        out.append(("dx", 2 * macs, x + y + weights * e))
    return out


def step_work(config: dict) -> list:
    """[(op, pass, flops, bytes)] of one training step."""
    e = DTYPE_BYTES[config["precision"]]
    return [(op, *p) for op in swin_unetr_ops(config) for p in passes(op, e)]


def model_flops(work: list) -> float:
    return float(sum(flops for _, _, flops, _ in work))


def attn_least_seconds(work: list, peak_flops: float, bytes_per_s: float) -> float:
    """The least time of the window-attention passes: per pass the larger of
    its FLOPs over the peak and its bytes over the memory rate, summed."""
    return float(sum(max(flops / peak_flops, nbytes / bytes_per_s)
                     for op, _, flops, nbytes in work if op.kind == "attn"))


def window_attn_seconds(layer: dict) -> float | None:
    """Device seconds of the traced window in kernels whose names start with
    ``window_attn``; None where a training trace holds none."""
    s = layer["trace"]
    if layer["kind"] != "train" or s is None or not layer["units"]:
        return None
    spent = sum(t for name, _, t in s.kernels if name.startswith("window_attn"))
    return spent if spent > 0 else None
