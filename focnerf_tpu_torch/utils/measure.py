"""Measurement helpers shared by chip_smoke.py and tools/profile_serving.py.

  - ``device_events``: the device-side events of a torch.profiler trace;
  - ``busy_ms``: the time the device was busy in such a trace (the union of
    its events' intervals: overlapping events count once);
  - ``device_ms``: a function's device time per call, and its CUDA-event span;
  - ``counted_device_ms``: the same device time, with the events the trace
    recorded against the events it should hold;
  - ``kernel_ms``: one kernel's device time per call of a function that
    also launches others;
  - ``dependent_load_ns``: the card's latency per dependent load from an
    L2-resident buffer (a pointer chase);
  - ``l2_read_bytes_per_s``: the card's L2 read rate (a buffer that stays
    in L2, read again and again);
  - ``seeded_model``: the full-width serving model from a seed, with a
    density grid equal to the field's sigma at every cell centre.
"""

from __future__ import annotations

import torch


def _device(prof):
    """Every device-side event (kernel, copy, fill) of a torch.profiler
    trace. Host-side operator events are left out, and so are the
    device-side spans of annotations (``record_function`` ranges such as
    ``Optimizer.step#Adam.step``), which cover kernels already listed."""
    return [e for e in prof.events()
            if str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False)]


def device_events(prof):
    """(name, ms) of every device-side event: each event's own time, for
    sums by name. Events on different streams may overlap, so their sum can
    exceed the time the device was busy (``busy_ms``)."""
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in _device(prof)]


def union_ms(spans) -> float:
    """Total length, in ms, of the union of (start_us, end_us) intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total / 1e3


def busy_ms(prof) -> float:
    """Time the device was busy in a torch.profiler trace: the union of its
    device events' intervals, so overlapping events count once."""
    return union_ms((e.time_range.start, e.time_range.end) for e in _device(prof))


def device_ms(fn, iters: int = 50):
    """(device ms, enqueue-to-finish ms) per call of ``fn``.

    Device time is the sum of the device events' own times in a
    torch.profiler trace, so the host's Python overhead between back-to-back
    calls does not count; it raises when the profiler sees no device time.
    The second number is the CUDA-event span over the calls, host gaps
    included.
    """
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    span_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = sum(ms for _, ms in device_events(prof))
    if ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return ms / iters, span_ms


def counted_device_ms(fn, iters: int = 50):
    """(device ms per call, events recorded, events expected) of ``fn``:
    ``device_ms``'s sum over ``iters`` calls, and one profiled call's device
    events times ``iters`` as the count that trace must hold. A trace that
    holds fewer lost events, and its time does not stand for the calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_call = len(_device(prof))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = _device(prof)
    ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    return ms, len(events), per_call * iters


def kernel_ms(fn, name: str, iters: int = 100, flush: bool = False):
    """(device ms per call, events) of the kernels whose name holds ``name``
    in a torch.profiler trace of ``iters`` calls of ``fn`` (after 5 warm-up
    calls): that kernel's own time, without the other kernels ``fn``
    launches. ``flush``: a 256 MB buffer is zeroed before every call, so
    the call finds none of its operands in L2. ``events`` is how many such
    kernels the trace recorded; a trace that lost events reads low."""
    from torch.profiler import ProfilerActivity, profile

    scrub = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda") if flush else None
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush:
                scrub.zero_()
            fn()
        torch.cuda.synchronize()
    events = [e for e in _device(prof) if name in e.name]
    if not events:
        raise RuntimeError(f"torch.profiler recorded no kernel named {name!r}")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters, len(events)


def dependent_load_ns(nbytes: int, device, steps: int = 200000, repeats: int = 3) -> float:
    """ns per load of a chain of dependent loads through a buffer of
    ``nbytes`` on the card: one thread follows a random cycle of int32
    indices (``csrc/march_skip.cu``'s ``focnerf_load_chase``, loads cached in
    L2 only), after a pass that leaves the buffer in L2. The fastest of
    ``repeats`` runs of ``steps`` loads, timed with CUDA events."""
    import ctypes

    from focnerf_tpu_torch.ops._build import load_library

    words = max(nbytes // 4, 2)
    perm = torch.randperm(words, generator=torch.Generator().manual_seed(0))
    nxt = torch.empty(words, dtype=torch.int64)
    nxt[perm] = torch.roll(perm, -1)  # one cycle through every word
    nxt = nxt.to(torch.int32).to(device)
    out = torch.empty(1, dtype=torch.int32, device=device)
    fn = load_library("march_skip").focnerf_load_chase
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream(device).cuda_stream

    def chase(k: int):
        err = fn(nxt.data_ptr(), k, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"load-chase kernel launch failed: cudaError {err}")

    int(nxt.sum())  # the buffer into L2
    chase(min(words, steps))
    best = float("inf")
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chase(steps)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) * 1e6 / steps)
    return best


def l2_read_bytes_per_s(nbytes: int, device, reps: int = 50, repeats: int = 3) -> float:
    """The card's L2 read rate, bytes/s: a zeroed buffer of ``nbytes``
    (small enough to stay in L2) read ``reps`` times by
    ``csrc/hashgrid_fwd.cu``'s ``focnerf_l2_read`` (float4 loads cached in
    L2 only, four blocks of 512 threads an SM), after a pass that leaves it
    in L2. The fastest of ``repeats`` runs, timed with CUDA events."""
    import ctypes

    from focnerf_tpu_torch.ops._build import load_library

    buf = torch.zeros(nbytes // 16 * 4, dtype=torch.float32, device=device)
    blocks = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.zeros(blocks, dtype=torch.float32, device=device)
    fn = load_library("hashgrid_fwd").focnerf_l2_read
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream(device).cuda_stream

    def read(k: int):
        err = fn(buf.data_ptr(), buf.numel() // 4, k, blocks, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"L2 read kernel launch failed: cudaError {err}")

    read(1)  # the buffer into L2
    best = float("inf")
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        read(reps)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return buf.numel() * 4 * reps / best


def seeded_model(opt, device, seed: int = 0):
    """(params, cfg, occupancy) of ``opt``'s model: seeded params, and a
    density grid holding the field's sigma at every cell centre."""
    from focnerf_tpu_torch.models.nerf import density_fn, init_nerf_params
    from focnerf_tpu_torch.ops.occupancy import OccupancyState, cascade_count

    cfg = opt.nerf_config()
    params = init_nerf_params(torch.Generator().manual_seed(seed), cfg, device)
    gs, cas = 128, cascade_count(cfg.bound)
    c = (torch.arange(gs, device=device, dtype=torch.float32) + 0.5) / gs * 2.0 - 1.0
    cells = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    grid = torch.empty((cas, gs**3), device=device)
    with torch.no_grad():
        for k in range(cas):
            xyz = cells * min(2.0**k, cfg.bound)
            for i in range(0, xyz.shape[0], 1 << 20):
                grid[k, i : i + (1 << 20)] = density_fn(params, cfg, xyz[i : i + (1 << 20)])[0]
    occ = OccupancyState(
        grid, grid.clamp(min=0).mean(), torch.tensor(1, dtype=torch.int32, device=device)
    )
    return params, cfg, occ
