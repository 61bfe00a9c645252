"""The device's idle share of the serving window: 100 minus the device's
busy time a view, from the trace of the views after the window (the union
of its events' intervals over the traced views), over the window's own
untraced time a view. The profiler stretches the host between launches,
so the traced wall time would read the profiler's idle share."""


def read(ctx, trace):
    if trace.get("kind") != "render":
        return None
    busy_view = trace["profile"]["busy_s"] / trace["profiled_views"]
    return 100.0 * (1.0 - busy_view / (trace["window_s"] / len(trace["views"])))
