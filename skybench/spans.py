"""The per-layer metrics read from the program's own spans
(`cloudscape_tpu_torch.utils.profiling.span`): they record only while a
profiler runs, so their totals cover the traced groups of a `--trace 1`
run and nothing else."""


def mean_ms(layer: dict, match):
    """The mean host duration (ms) of the program's spans whose name
    `match(name)` accepts, over the traced groups. None without a device
    trace, for a program that records no spans, or where none matched."""
    if layer.get("trace") is None:
        return None
    from cloudscape_tpu_torch.utils import profiling

    stats = getattr(profiling, "span_stats", None)
    if stats is None:
        return None
    hit = [s for name, s in stats().items() if match(name)]
    count = sum(s["count"] for s in hit)
    return sum(s["total_s"] for s in hit) * 1e3 / count if count else None
