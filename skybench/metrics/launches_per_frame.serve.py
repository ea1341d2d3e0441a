"""Device activities (kernels, copies, fills) a serving tick launches, from
the profiler's trace of one whole cycle of ticks."""


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None or trace.calls == 0:
        return None
    return trace.activities / trace.calls
