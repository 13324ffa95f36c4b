"""The share of the traced window in which no device kernel or copy ran,
in percent (device)."""


def read(ctx):
    window = ctx.get("window_us") or 0.0
    if window <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_us"] / window)
