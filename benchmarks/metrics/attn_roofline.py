"""``attn_roofline``: the short-block attention kernel's share of its
roofline, in percent (B2 over the contiguous cache in the single stream, B3
over the paged pool in serving; the cell's driver module names the
family): the least time for the KV bytes (K and V over the kv heads) and
FLOPs the traced window's live rows need, each step's prefix rebuilt from
the request's prompt and accepted lengths, over the time in which a kernel
of the family ran. The bytes and FLOPs of all calls are summed before the
roofline is taken, a lower bound of the least time."""

from benchmarks import roofline


def read(ctx):
    c = ctx.counts
    fam = c.get("attention_family")
    spent = ctx.trace.family_s(fam) if ctx.trace is not None and fam else None
    if not spent:
        return None
    least = 0.0
    for role, t in c["attention"].items():
        w = ctx.widths[role]
        nbytes = (t["prefix"] * roofline.kv_bytes_per_position(w, c["kv_dtype"])
                  + t["new"] * roofline.new_token_bytes(w))
        flops = 4.0 * w["heads"] * w["head_dim"] * (t["new_x_prefix"] + t["causal"])
        least += w["layers"] * roofline.least_time(nbytes, flops)
    return 100.0 * least / spent if least else None
