"""The card's idle share of the window, in %: one minus the union of the
device intervals that the window's calls recorded (``ServeRun.trace``'s
``compute[...]`` lane: each call's eager warm-up and each graph replay),
over the window from the first call's ``serve.call`` start to the last
one's end, both on the profiler's clock. Idle inside a replay counts as
busy, so this is the share that per-call set-up (cache, warm-up, capture,
the ids' copy) and the gaps between replays and between calls cost."""



def _covered(intervals, lo: int, hi: int) -> int:
    """How much of [lo, hi] the union of ``intervals`` ((start, end) pairs)
    covers."""
    total, reach = 0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total


def read(window):
    calls, device = [], []
    for run in getattr(window, "runs", None) or ():
        trace = getattr(run, "trace", None)
        if trace is None:
            return None
        for s in trace.spans:
            if s.lane == "host" and s.name == "serve.call":
                calls.append(s)
            elif s.lane.startswith("compute["):
                device.append((s.start, s.end))
    if not calls or not device:
        return None
    first, last = min(c.start for c in calls), max(c.end for c in calls)
    return 100.0 * (1.0 - _covered(device, first, last) / (last - first))
