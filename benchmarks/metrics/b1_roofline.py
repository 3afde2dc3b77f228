"""``b1_roofline``: the W8A16 matmul's (B1) share of its roofline, in percent:
the least time of the W8A16 products the traced window's work needs (each
forward's int8 products a layer, as the model's family counts them: prompts
at their own length, gamma+1 tokens a live row-step; forwards whose split of
rows is not known are bounded from below) over the time in which a B1 kernel
ran on the device."""

from benchmarks import roofline


def read(ctx):
    w8 = ctx.counts.get("w8a16")
    spent = ctx.trace.family_s("b1") if ctx.trace is not None else None
    if not w8 or not spent:
        return None
    least = 0.0
    for role, calls in w8.items():
        w = ctx.widths[role]
        least += sum(n * roofline.w8a16_forward_time(w, m) for m, n in calls["exact"].items())
        least += sum(roofline.w8a16_forwards_time(w, f, m) for f, m in calls["pooled"])
    return 100.0 * least / spent if least else None
