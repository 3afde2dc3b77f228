"""``moe_roofline``: the grouped expert product's (B4) share of its
roofline, in percent: the least time of the routed-expert products the
traced window's work needs over the time in which a B4 kernel ran on the
device. A forward of ``m`` token rows needs, each layer, the family's
``expert_work``: the experts it touches (expected under uniform routing)
read once, the routed rows in and out, and their FLOPs; each forward's
least time is the larger of its bytes and FLOPs over the peaks. Forwards
are counted as ``b1_roofline`` counts them (prompts at their own length,
gamma+1 tokens a live row-step; a split of rows that is not known taken as
equal rows over the fewest forwards it can be)."""

from benchmarks import families, roofline


def read(ctx):
    w8 = ctx.counts.get("w8a16")
    spent = ctx.trace.family_s("b4") if ctx.trace is not None else None
    if not w8 or not spent:
        return None
    least = 0.0
    for role, calls in w8.items():
        w = ctx.widths[role]
        if not w.get("experts"):
            continue
        fam = families.of(w)

        def forward(m):
            return w["layers"] * roofline.least_time(*fam.expert_work(w, m))
        least += sum(n * forward(m) for m, n in calls["exact"].items())
        least += sum(f * forward(m / f) for f, m in calls["pooled"] if f > 0)
    return 100.0 * least / spent if least else None
