"""Mean host time (ms) of the synchronous cone-cache build of an
`update_cycle` call's snapshot: the program's `cone.build` span, over the
traced calls."""

from skybench import spans


def read(layer: dict):
    return spans.mean_ms(layer, lambda name: name == "cone.build")
