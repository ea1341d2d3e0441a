"""Mean host time (ms) of one prebake stage step, whatever its stage: the
program's `prebake.<stage>` spans together, over the traced ticks."""

from skybench import spans


def read(layer: dict):
    return spans.mean_ms(layer, lambda name: name.startswith("prebake."))
