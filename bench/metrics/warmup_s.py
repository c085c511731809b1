"""Seconds from a call's ``serve.warmup`` start (the host's) to its
warm-up's device interval's end (the card's, on the same clock): the eager
warm-up of ``fuse`` steps as the card finishes it, the mean over the
window's calls. The interval ends inside ``serve.capture``, whose
synchronise drains it, so this overlaps ``capture_s``."""


def read(window):
    seconds = []
    for run in getattr(window, "runs", None) or ():
        spans = getattr(getattr(run, "trace", None), "spans", ())
        host = [s for s in spans if s.lane == "host" and s.name == "serve.warmup"]
        card = [s for s in spans if s.lane.startswith("compute[") and s.name == "serve.warmup"]
        if host and card:
            seconds.append((card[0].end - host[0].start) / 1e9)
    return sum(seconds) / len(seconds) if seconds else None
