"""One reader a metric, ``metrics/<name>.py``: ``read(ctx) -> value or
None`` on a ``harness.Context``.  A reader that finds nothing to read
returns None and the metric is left out of the line."""
