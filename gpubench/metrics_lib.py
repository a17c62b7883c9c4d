"""Arithmetic the per-layer metric readers share."""

from __future__ import annotations

from gpubench import flops


def idle_share(layer) -> float | None:
    s = layer["trace"]
    if s is None:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def peak_gib(layer) -> float | None:
    peak = layer["window_peak_bytes"]
    return peak / 2**30 if peak else None


def mfu(layer) -> float | None:
    s = layer["trace"]
    if s is None or not layer["units"]:
        return None
    done = flops.model_flops(layer["work"]) * layer["units"]
    return 100.0 * done / (s.window_s * layer["chips"] * layer["peak_flops"])


def conv_roofline(layer) -> float | None:
    s = layer["trace"]
    if s is None or not layer["units"]:
        return None
    kinds = set(layer["classes"]["conv_work"])
    spent = sum(t for cls, t in s.seconds_by_class().items() if cls in kinds)
    if spent <= 0:
        return None
    least = flops.conv_least_seconds(layer["work"], layer["peak_flops"],
                                     layer["hbm_bytes_per_s"]) * layer["units"]
    return 100.0 * least / (spent * layer["chips"])


def per_unit_ms(layer, keep) -> float | None:
    s = layer["trace"]
    if s is None or not layer["units"]:
        return None
    return 1e3 * sum(t for cls, t in s.seconds_by_class().items() if keep(cls)) / layer["units"]
