"""Per-layer metrics, a module each, named as in ``BENCHMARK.json``: each
has ``read(window) -> float | None``, over what the entry's window and its
traced span hold (``entries.serve_fused.Window``). A reader that finds
nothing to read returns None, and the metric is left out of the line."""
