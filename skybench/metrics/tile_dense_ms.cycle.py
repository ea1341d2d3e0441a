"""Mean host time (ms) of one tile's dense march, 64 a `update_cycle`
call: the program's `tile.dense` span, over the traced calls."""

from skybench import spans


def read(layer: dict):
    return spans.mean_ms(layer, lambda name: name == "tile.dense")
