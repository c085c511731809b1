"""Seconds a call spends capturing its CUDA graphs (``ServeRun.capture_s``,
the serve driver's own span), the mean over the window's calls."""


def read(window):
    runs = getattr(window, "runs", None)
    if not runs or not any(run.graphs for run in runs):
        return None
    return sum(run.capture_s for run in runs) / len(runs)
