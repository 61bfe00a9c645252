"""Share of the serving window's wall time in the colour stage: CUDA events
around ``render/renderer.py``'s ``color_fn`` (SH, the object encoding, the
colour MLP), on its stream."""


def read(ctx, trace):
    if trace.get("kind") != "render":
        return None
    return 100.0 * trace["stage_s"]["color_fn"] / trace["window_s"]
