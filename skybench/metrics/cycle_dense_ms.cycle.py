"""Mean host time (ms) of an `update_cycle` call's batched dense march of
its remaining tiles, one a call: the program's `cycle.dense` span, over the
traced calls."""

from skybench import spans


def read(layer: dict):
    return spans.mean_ms(layer, lambda name: name == "cycle.dense")
