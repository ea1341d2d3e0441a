"""Mean wall time (ms, device-complete) of the window's ticks whose tile
took the v3 arm (a tile-cull bucket strictly between 0 and 1) and baked
nothing."""

_NO_BAKE = ("bake:none", "bake:fresh")


def read(layer: dict):
    ms = [t for t, label, arm in layer.get("ticks", []) if arm == "v3" and label in _NO_BAKE]
    return sum(ms) / len(ms) if ms else None
