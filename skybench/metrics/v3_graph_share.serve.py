"""Share of the traced v3 tiles that replayed a captured CUDA graph: the
program's `v3.replay` spans over its `tile.v3` spans, over the traced ticks
(1.0 where every v3 tile was one graph launch). None without a trace, for a
program that has no `v3.replay` span (no `v3_graph_replays` counter beside
it) or records no spans, or where no v3 tile was traced."""


def read(layer: dict):
    if layer.get("trace") is None:
        return None
    from cloudscape_tpu_torch import engine
    from cloudscape_tpu_torch.utils import profiling

    stats = getattr(profiling, "span_stats", None)
    if stats is None or not hasattr(engine, "v3_graph_replays"):
        return None
    s = stats()
    tiles = s.get("tile.v3", {}).get("count", 0)
    if not tiles:
        return None
    return s.get("v3.replay", {}).get("count", 0) / tiles
