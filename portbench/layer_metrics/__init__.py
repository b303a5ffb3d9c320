"""Per-layer metric readers, one module a metric, found by the part of the
metric's name before its first dot (``idle_share.serve`` and
``idle_share.fleet`` are both read by ``idle_share.py``).  Each module has
``read(ctx)``, which returns the metric's number or None where the traced
window holds nothing for it to read; ``ctx`` is a ``harness.TraceContext``.
"""
