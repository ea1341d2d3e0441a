"""Mean host time (ms) of one tile's march on the v3 arm: the program's
`tile.v3` span, over the traced ticks."""

from skybench import spans


def read(layer: dict):
    return spans.mean_ms(layer, lambda name: name == "tile.v3")
