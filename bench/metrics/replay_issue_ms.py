"""Host milliseconds issuing one launch of the timed loop (a graph replay
and the copy of its ids; ``ServeRun.issue_ms``) while the launch queue has
room: the least of each call's launches, the median over the window's
calls. Most launches of a call wait in ``cudaGraphLaunch`` for the card to
free queue slots (the trace names those gaps "Command Buffer Full"), so
their issue time is the card's time for the replay ahead of them, not the
host's cost."""

import statistics


def read(window):
    runs = [run for run in getattr(window, "runs", None) or () if run.graphs and run.issue_ms]
    return statistics.median(min(run.issue_ms) for run in runs) if runs else None
