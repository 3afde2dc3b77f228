"""``attn_roofline.code``: the short-block attention kernel's share of its
roofline, in percent, as ``attn_roofline`` reads it, for a model whose
window layers read only the last ``window`` positions: each row's (prefix,
new tokens) from the tallies' ``shapes``; a full layer needs the whole
prefix's K and V, a window layer the ``min(prefix, window - 1)`` cached
positions its first new token sees (new token j sees ``min(prefix, window
- 1 - j)`` of them). Bytes and FLOPs of every row and layer are summed
before the roofline is taken, over the time in which a kernel of the
family ran."""

from benchmarks import roofline

WINDOW = "sliding_attention"


def read(ctx):
    c = ctx.counts
    fam = c.get("attention_family")
    spent = ctx.trace.family_s(fam) if ctx.trace is not None and fam else None
    if not spent:
        return None
    nbytes = flops = 0.0
    for role, t in c["attention"].items():
        w = ctx.widths[role]
        kinds = w.get("layer_types") or ["full_attention"] * w["layers"]
        n_win = sum(k == WINDOW for k in kinds)
        n_full = len(kinds) - n_win
        win = w.get("window") or 0
        kvb = roofline.kv_bytes_per_position(w, c["kv_dtype"])
        ntb = roofline.new_token_bytes(w)
        per_key = 4.0 * w["heads"] * w["head_dim"]
        for (prefix, s), n in t["shapes"].items():
            block = s * (s + 1) / 2
            nbytes += n * n_full * (prefix * kvb + s * ntb)
            flops += n * n_full * per_key * (s * prefix + block)
            if n_win:
                seen = sum(min(prefix, max(win - 1 - j, 0)) for j in range(s))
                nbytes += n * n_win * (min(prefix, win - 1) * kvb + s * ntb)
                flops += n * n_win * per_key * (seen + block)
    least = roofline.least_time(nbytes, flops)
    return 100.0 * least / spent if least else None
