"""``chunk_ms``: milliseconds of the traced window per serving chunk (the sum
of ``run_until_idle``'s returns), in the serving engine."""


def read(ctx):
    chunks = ctx.counts.get("chunks")
    return ctx.counts["segment_s"] / chunks * 1e3 if chunks else None
