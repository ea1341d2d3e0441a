"""Device activities (kernels, copies, fills) one `update_cycle` call
launches, from the profiler's trace of the traced calls."""


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None or trace.calls == 0:
        return None
    return trace.activities / trace.calls
