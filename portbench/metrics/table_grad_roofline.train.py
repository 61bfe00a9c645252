"""The table gradient's share of its roofline in the traced training
epochs: the least time of its scatters (``work.table_grad_bytes`` of
[num_rays x slab] points a step, each step at the slab it ran with, over
the HBM peak) over the device time of the ``table_grad_kernel`` events.
Not reported where the trace holds fewer events than the wrapper counted
launches (kernels replayed from a CUDA graph that the trace lost)."""

from portbench import tracing, work


def read(ctx, trace):
    if trace.get("kind") != "train":
        return None
    seconds, events = tracing.device_time(trace["profile"], "table_grad_kernel")
    launches = trace["launches"].get("hashgrid_table_grad", 0)
    steps = sum(n for n, _ in trace["slabs"])
    if launches == 0 or launches != steps or events < launches or seconds <= 0:
        return None
    n_bytes = sum(n * work.table_grad_bytes(trace["rays_per_step"] * slab, ctx.config) for n, slab in trace["slabs"])
    return work.roofline_pct(n_bytes, 0.0, seconds)
