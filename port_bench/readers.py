"""Arithmetic the per-layer readers share: a model share of the card's peak
over the window, a kernel's share of its roofline in the trace, and device
time per unit of work."""

from __future__ import annotations

from port_bench import attention_bound, flops, peaks


def mfu_percent(facts) -> float:
    """The window's forward (and, for training, backward) FLOPs of every
    model, each at its own peak, as seconds at peak over the window's
    seconds, in percent."""
    table = peaks.peaks(facts.get("device_kind", ""))
    if table is None or not facts.get("window_s"):
        return None
    at_peak = 0.0
    for f in facts["forwards"]:
        n = f["count"] * f.get("passes", 1) * flops.forward_flops(f["backbone"], f["batch"])
        at_peak += n / table[flops.peak_key(f["backbone"])]
    return 100.0 * at_peak / facts["window_s"]


def attention_roofline_percent(facts, patterns, backward: bool = False):
    """The traced forwards' packed-attention bound over the device time of
    the kernels named by ``patterns``, in percent; None without a trace or
    without such kernels in it."""
    tr = facts.get("trace")
    table = peaks.peaks(facts.get("device_kind", ""))
    if tr is None or table is None:
        return None
    spent = tr.device_s(patterns)
    if spent <= 0:
        return None
    bound = 0.0
    for f in facts["traced"]["forwards"]:
        dtype = "bf16" if f["backbone"].get("use_fp16") else "f32"
        for t, h in attention_bound.kernel_sites(f["backbone"]):
            bound += f["count"] * attention_bound.bound_s(f["batch"], t, h, dtype, table,
                                                          backward)[0]
    return 100.0 * bound / spent if bound > 0 else None


def device_ms_per(facts, patterns, unit_key: str):
    """Device milliseconds of the kernels named by ``patterns`` in the trace,
    over the traced units ``facts["traced"][unit_key]``."""
    tr = facts.get("trace")
    n = facts.get("traced", {}).get(unit_key)
    if tr is None or not n or tr.count(patterns) == 0:
        return None
    return 1e3 * tr.device_s(patterns) / n


def idle_percent(facts):
    tr = facts.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def peak_gib(facts):
    b = facts.get("peak_mem_window")
    return b / 2 ** 30 if b else None
