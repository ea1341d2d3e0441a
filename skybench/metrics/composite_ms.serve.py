"""Mean host time (ms) of the fused tick's composite of the view: the
program's `composite_display` span, over the traced ticks."""

from skybench import spans


def read(layer: dict):
    return spans.mean_ms(layer, lambda name: name == "composite_display")
