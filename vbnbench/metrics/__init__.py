"""One reader a per-layer metric, ``metrics/<name>.py`` with ``read(ctx)``,
found by the metric's name. ``ctx`` is the traced window
(``trace.reduce_trace``'s record, plus ``least_ms`` a call from
``work/`` and ``peak_bytes`` of the window). A reader that finds nothing
to read returns None, and the metric is left out of the line.
"""
