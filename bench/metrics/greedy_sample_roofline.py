"""``greedy_sample``'s share of its roofline, in %: its launches in the
traced span times its least time (B x V bf16 logits read once and B int32
ids written once, at the card's HBM bandwidth), over its device time there
by kernel name."""


def read(window):
    span, peak = getattr(window, "span", None), getattr(window, "peak", None)
    if span is None or peak is None:
        return None
    found = [(s, n) for name, (s, n) in span.by_name().items() if "greedy_sample" in name]
    seconds, launches = sum(s for s, _ in found), sum(n for _, n in found)
    if not launches or seconds <= 0:
        return None
    b, v = window.batch, window.vocab
    least = (b * v * 2 + b * 4) / peak["hbm_bytes_per_s"]
    return 100.0 * launches * least / seconds
