"""Share of the traced fused ticks' composites that were one launch of the
program's composite kernel: its `composite.kernel` spans over its
`composite_display` spans, over the traced ticks (1.0 where every
composite was one kernel launch). None without a trace, for a program
without that kernel (no `cloudscape_tpu_torch.ops.composite_kernel`) or
that records no spans, or where no composite was traced."""

import importlib.util


def read(layer: dict):
    if layer.get("trace") is None:
        return None
    from cloudscape_tpu_torch.utils import profiling

    stats = getattr(profiling, "span_stats", None)
    if stats is None or importlib.util.find_spec(
            "cloudscape_tpu_torch.ops.composite_kernel") is None:
        return None
    s = stats()
    composites = s.get("composite_display", {}).get("count", 0)
    if not composites:
        return None
    return s.get("composite.kernel", {}).get("count", 0) / composites
