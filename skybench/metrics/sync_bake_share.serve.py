"""Share of the traced rotations that built the new snapshot's cone cache,
sky LUT and tile-cull map synchronously: the program's `engine.sync_bake`
spans over its `engine.rotate` spans, over the traced ticks (0.0 where
every traced rotation picked up the prebaked cycle). None without a trace,
for a program that has no `engine.sync_bake` span (no `sync_bakes` counter
beside it) or records no spans, or where no rotation was traced."""


def read(layer: dict):
    if layer.get("trace") is None:
        return None
    from cloudscape_tpu_torch import engine
    from cloudscape_tpu_torch.utils import profiling

    stats = getattr(profiling, "span_stats", None)
    if stats is None or not hasattr(engine, "sync_bakes"):
        return None
    s = stats()
    rotations = s.get("engine.rotate", {}).get("count", 0)
    if not rotations:
        return None
    return s.get("engine.sync_bake", {}).get("count", 0) / rotations
