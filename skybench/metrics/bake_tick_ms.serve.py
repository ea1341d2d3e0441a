"""Mean wall time (ms, device-complete) of the window's ticks that bake a
stage of the next cycle: `_prebake_stage()`, read before the tick, names
a stage other than the pending cycle's first tick ("fresh"); a scene
cut's tick ("cut") bakes no stage."""

_NO_BAKE = ("bake:none", "bake:fresh", "bake:rotate", "cut")


def read(layer: dict):
    ms = [t for t, label, _ in layer.get("ticks", []) if label not in _NO_BAKE]
    return sum(ms) / len(ms) if ms else None
