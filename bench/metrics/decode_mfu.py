"""The whole decode step's share of the card's peak, in %: the least time
of every step of the window's timed loops by the frozen counts
(``counts.<family>.step``: the larger of its FLOPs at the bf16 peak and its
bytes at the HBM bandwidth), over the device time of those loops (the
driver's CUDA events)."""


def read(window):
    runs, peak = getattr(window, "runs", None), getattr(window, "peak", None)
    if not runs or peak is None or any(run.device_ms is None for run in runs):
        return None
    least = 0.0
    for run in runs:
        first = window.steps - run.produced  # the timed loop's first position
        for pos in range(first, window.steps):
            flops, nbytes = window.counts.step(window.config, window.batch, pos)
            least += max(flops / peak["bf16_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])
    return 100.0 * least / (sum(run.device_ms for run in runs) / 1e3)
