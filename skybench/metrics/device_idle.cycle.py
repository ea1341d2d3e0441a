"""The card's idle share (%) of the traced re-renders: 1 − the union of
the device's activity intervals over the calls' wall time."""


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None or trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
