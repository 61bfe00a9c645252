"""The device's idle share of the training window: 100 minus the device's
busy time a step, from the trace of the epochs after the window (the union
of its events' intervals over the traced steps), over the window's own
untraced step time (its last two epochs). The profiler stretches the host
between launches, so the traced wall time would read the profiler's idle
share, not the window's."""


def read(ctx, trace):
    if trace.get("kind") != "train":
        return None
    busy_step = trace["profile"]["busy_s"] / trace["traced_steps"]
    return 100.0 * (1.0 - busy_step / trace["untraced_step_s"])
