"""The serving encode's share of its roofline: the least time of the
traced views' encodes (``work.encode_bytes`` of [max_ray_batch x slab]
points a launch, over the HBM peak) over the device time of the
``encode_kernel`` events. Not reported where the trace holds fewer events
than the wrapper counted launches (a trace that lost events)."""

from portbench import tracing, work


def read(ctx, trace):
    if trace.get("kind") != "render":
        return None
    seconds, events = tracing.device_time(trace["profile"], "encode_kernel")
    launches = trace["launches"].get("hashgrid_encode_forward", 0)
    if launches == 0 or events < launches or seconds <= 0:
        return None
    n = trace["max_ray_batch"] * trace["check"]["slab"]
    return work.roofline_pct(launches * work.encode_bytes(n, ctx.config), 0.0, seconds)
