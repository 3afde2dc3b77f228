"""``accept_len``: tokens committed per speculative step of one request (its
accepted drafts plus one), over the traced window: new tokens over steps in
the single-request engine, committed tokens over row-steps (from each
request's accepted lengths) in the serving engine."""


def read(ctx):
    c = ctx.counts
    if "row_steps" in c:
        return c["committed_tokens"] / c["row_steps"] if c["row_steps"] else None
    return c["new_tokens"] / c["steps"] if c.get("steps") else None
