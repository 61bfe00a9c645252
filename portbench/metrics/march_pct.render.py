"""Share of the serving window's wall time in the march: CUDA events around
``render/renderer.py``'s ``march_rays`` (the ladder), on its stream."""


def read(ctx, trace):
    if trace.get("kind") != "render":
        return None
    return 100.0 * trace["stage_s"]["march_rays"] / trace["window_s"]
