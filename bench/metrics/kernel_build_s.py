"""Seconds this process spent compiling the program's kernels with
``nvcc``: the summed ``nvcc`` spans of ``repro_torch.kernels._build.builds()``
(every process builds what it launches; none is taken from a cache)."""


def read(window):
    from repro_torch.kernels import _build

    builds = getattr(_build, "builds", None)
    found = builds() if builds is not None else []
    return sum(b.seconds for b in found) if found else None
