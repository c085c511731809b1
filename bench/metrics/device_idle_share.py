"""The card's idle share of the traced span of replays, in %: one minus
the union of the device operations' intervals over the span's length on
the host's clock."""


def read(window):
    span = getattr(window, "span", None)
    if span is None or not span.ops or span.window_s <= 0:
        return None
    return 100.0 * (1.0 - span.busy_s / span.window_s)
