"""The GroupNorm kernel's share of its roofline in the traced batches: the
bytes bound of every GroupNorm site of the traced forwards
(``port_bench.norm_bound``: each site's input read once and output written
once in the torso's type, at the card's memory rate) over the device time
of the kernels named ``gn_act_``. None without a trace or without such
kernels in it."""

from port_bench import norm_bound, peaks

PATTERNS = ("gn_act_",)


def read(facts, run):
    tr = facts.get("trace")
    table = peaks.peaks(facts.get("device_kind", ""))
    if tr is None or table is None:
        return None
    spent = tr.device_s(PATTERNS)
    if spent <= 0:
        return None
    bound = sum(f["count"] * norm_bound.bound_s(f["backbone"], f["batch"], table)
                for f in facts["traced"]["forwards"])
    return 100.0 * bound / spent
