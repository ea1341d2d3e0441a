"""Mean host time (ms) of a tick's bake work, on the ticks that bake: the
program's `bake.tick` span (one a baking tick, around its `prebake.<stage>`
steps, several where the schedule groups them), over the traced ticks."""

from skybench import spans


def read(layer: dict):
    return spans.mean_ms(layer, lambda name: name == "bake.tick")
