"""``step_mfu.code``: the whole step's share of the chip's bf16 peak, in
percent, as ``step_mfu`` reads it, with each token's routed-expert and
router products counted beside its dense ones (the family's
``expert_work`` and ``router_flops`` at one row): the matmul FLOPs the
traced window's work needs over the peak times the window."""

from benchmarks import families, roofline


def read(ctx):
    c = ctx.counts
    needed = c.get("needed_tokens")
    if not needed or not c.get("segment_s"):
        return None
    flops = 0.0
    for role, n in needed.items():
        w = ctx.widths[role]
        fam = families.of(w)
        routed = fam.expert_work(w, 1)[1] + fam.router_flops(w, 1) if w.get("experts") else 0.0
        flops += n * (roofline.model_flops_per_token(w) + w["layers"] * routed)
    return 100.0 * flops / (roofline.FLOPS_PER_S * c["segment_s"]) if flops else None
