"""Device milliseconds a decode step of the timed loops: the driver's CUDA
events around each call's replays (``ServeRun.device_ms``), summed over the
window's calls, over the steps they produced."""


def read(window):
    runs = getattr(window, "runs", None)
    if not runs or any(run.device_ms is None for run in runs):
        return None
    return sum(run.device_ms for run in runs) / sum(run.produced for run in runs)
