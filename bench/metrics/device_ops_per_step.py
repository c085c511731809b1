"""Device operations (kernels, copies, fills) a decode step, from the
device trace of the traced span of replays."""


def read(window):
    span = getattr(window, "span", None)
    if span is None or not span.ops or not span.steps:
        return None
    return len(span.ops) / span.steps
