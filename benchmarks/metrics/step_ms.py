"""``step_ms``: milliseconds of the traced window per speculative step the
requests made (the engine's ``target_call_times``), in the single-request
engine."""


def read(ctx):
    steps = ctx.counts.get("steps")
    return ctx.counts["segment_s"] / steps * 1e3 if steps else None
