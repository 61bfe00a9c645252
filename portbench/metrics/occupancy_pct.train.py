"""Share of the training window's wall time spent in the trainer's
occupancy refreshes (``Trainer._maybe_update_occupancy`` when it updates:
a span from the benchmark's wrapper, opened and closed after a device sync)."""


def read(ctx, trace):
    if trace.get("kind") != "train":
        return None
    return 100.0 * trace["occupancy_s"] / trace["window_s"]
