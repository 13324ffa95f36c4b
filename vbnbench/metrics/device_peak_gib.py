"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()``, in GiB (device)."""


def read(ctx):
    peak = ctx.get("peak_bytes")
    return None if not peak else peak / 2**30
