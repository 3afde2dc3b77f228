"""``expert_skew``: the routed expert layers' load imbalance: in each layer
the busiest expert's routed rows over the mean expert's, averaged over the
layers (1 is even). Read once, after the run, from the program's
per-(layer, expert) totals, which the family's pair hands over under
``widths["routed_rows"]`` (``benchmarks/families/mellum.py``; the align op
of ``models/moe.py`` adds each forward's pairs, with no launch of its
own). The totals run from the pair's birth: set-up, fill and the whole
window, all of the cell's own traffic; None when the pair keeps none."""


def read(ctx):
    if ctx.trace is None:
        return None
    routed = ctx.widths.get("routed_rows")
    if routed is None:
        return None
    ratios = [float(row.max()) / float(row.double().mean())
              for row in routed.cpu() if row.sum() > 0]
    return sum(ratios) / len(ratios) if ratios else None
