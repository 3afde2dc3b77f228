"""``step_mfu``: the whole step's share of the chip's bf16 peak, in percent:
the matmul FLOPs that the traced window's work needs (every token the draft
and the target forward: prompts at their own length, and gamma+1 a model
for each speculative step of a live request) over the peak times the
window. Padding, dead rows and masked steps are not needed work."""

from benchmarks import roofline


def read(ctx):
    c = ctx.counts
    needed = c.get("needed_tokens")
    if not needed or not c.get("segment_s"):
        return None
    flops = sum(n * roofline.model_flops_per_token(ctx.widths[role])
                for role, n in needed.items())
    return 100.0 * flops / (roofline.FLOPS_PER_S * c["segment_s"]) if flops else None
