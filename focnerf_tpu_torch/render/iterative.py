"""Iterative full-image renderer with alive-ray compaction (eval only).

Twin of focnerf_tpu/render/iterative.py, the reference's inference worklist
(raymarching.cu:701-914 driven by the shrinking ``rays_alive`` loop,
nerf/renderer.py:318-344): each round takes up to ``bucket`` rays that are
still alive, marches a sub-slab of ``sub_slab`` samples from where each
stopped (``march_rays_skip`` over the skip field, no jitter), evaluates the
field there, and composites the sub-slab at the ray's carried optical depth
(``composite_rays_resume``: the forward kernel with a carried prefix on
the card). A ray whose sub-slab did not fill has left the volume, and a ray
whose transmittance fell below ``T_thresh`` is opaque: both leave the
worklist. The resume point is the dt recurrence's next lattice point after
the last recorded sample, so the samples are those of one long march.

Two ways to run the rounds, as in the JAX package:

  - the host ladder (``--eval_renderer iter``): the bucket of each round is
    the smallest of ``_bucket_ladder``'s sizes that holds the alive rays,
    read as one ``n_alive`` scalar per round;
  - the drain (``iter_dev``, ``device_loop=True``): ``ceil(n / sweep)``
    sweep rounds at ``min(n, bucket_cap)`` rays, then rounds of
    ``min(n, bucket_base)`` rays until ``max_rounds`` or no ray is alive.

Neither is free of host syncs here. The drain reads ``any(alive)`` once a
round (JAX's ``lax.while_loop`` condition), and every round's skip walk
(ops/marching.py) reads whether a ray is still marching every few
iterations, until that walk becomes a kernel. What the drain keeps from
JAX is its fixed bucket sizes.

Rows of a bucket past the alive rays take the index ``n``
(``torch.nonzero_static``'s fill, JAX's ``jnp.nonzero(size=, fill_value=)``):
they march nothing, and their writes land in one row past the last ray of
each carried tensor, which takes the place of JAX's ``mode="drop"``
scatters. The carried tensors are updated in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from focnerf_tpu_torch.core.geometry import near_far_from_aabb
from focnerf_tpu_torch.models.nerf import NeRFConfig, color_fn, density_fn
from focnerf_tpu_torch.ops.composite import composite_rays_resume
from focnerf_tpu_torch.ops.marching import march_rays_skip
from focnerf_tpu_torch.render.renderer import _aabb, _objfeat_enc


def _bucket_ladder(n: int, base: int = 4096, factor: int = 4, cap: int = 65536):
    """Bucket sizes {base, base*factor, ...} capped at min(n, cap).

    The cap bounds peak memory: a bucket of B rays evaluates B * sub_slab
    samples through the exact encode. Rays beyond the cap wait: the
    worklist drains in waves.
    """
    hi = min(n, cap)
    sizes = []
    b = min(base, hi)
    while b < hi:
        sizes.append(b)
        b *= factor
    sizes.append(hi)
    return sizes


def _round(params, cfg: NeRFConfig, bucket: int, rays_o, rays_d, fars, carried, occ_skip,
           objfeat_enc, aabb, *, sub_slab: int, dt_gamma: float, max_steps: int,
           grid_size: int, T_thresh: float):
    """One compaction round of ``bucket`` rays, updating ``carried`` =
    (t_cur, acc_od, acc_rgb, acc_dep, acc_ws, alive), each of n + 1 rows,
    in place (focnerf_tpu/render/iterative.py:64-129)."""
    t_cur, acc_od, acc_rgb, acc_dep, acc_ws, alive = carried
    n = rays_o.shape[0]
    idx = torch.nonzero_static(alive[:n], size=bucket, fill_value=n)[:, 0]  # [B]
    in_work = idx < n
    safe = torch.clamp(idx, max=n - 1)
    o, d = rays_o[safe], rays_d[safe]
    far_i = torch.where(in_work, fars[safe], 0.0)

    m = march_rays_skip(o, d, t_cur[safe], far_i, occ_skip, bound=cfg.bound, dt_gamma=dt_gamma,
                        max_steps=max_steps, slab=sub_slab, grid_size=grid_size)
    xyz = o[:, None, :] + d[:, None, :] * m.ts[..., None]
    xyz = torch.maximum(torch.minimum(xyz, aabb[3:]), aabb[:3])
    sigmas, geo_feat = density_fn(params, cfg, xyz)  # [B, K]
    sigmas = torch.where(m.valid, sigmas, torch.zeros_like(sigmas))
    rgbs = color_fn(params, cfg, d[:, None, :].expand(xyz.shape), geo_feat, objfeat_enc)

    # this round's samples enter at the ray's carried optical depth
    rgb_r, ws_r, dep_r, od_end = composite_rays_resume(
        sigmas.contiguous(), rgbs.contiguous(), m.dts.contiguous(), m.ts.contiguous(),
        acc_od[safe], cfg.density_scale, T_thresh,
    )
    # resume position: the recurrence's next lattice point after the last
    # recorded sample (raymarching.cu:371-377 `do t += dt`)
    last = torch.clamp(m.count - 1, min=0)[:, None]
    t_next = torch.where(m.count > 0, (m.ts.gather(1, last) + m.dts.gather(1, last))[:, 0], far_i)
    # a full sub-slab means the marcher stopped at capacity, not at the far
    # plane: the ray stays in the worklist unless it saturated
    still = in_work & (m.count >= sub_slab) & (torch.exp(-od_end) >= T_thresh)

    acc_rgb.index_add_(0, idx, rgb_r)
    acc_dep.index_add_(0, idx, dep_r)
    acc_ws.index_add_(0, idx, ws_r)
    acc_od.index_copy_(0, idx, od_end)
    t_cur.index_copy_(0, idx, t_next)
    alive.index_copy_(0, idx, still)


@torch.no_grad()
def render_rays_iterative(
    params,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    occ_skip: torch.Tensor,
    *,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    sub_slab: int = 16,
    bg_color=1.0,
    aabb: Optional[torch.Tensor] = None,
    min_near: float = 0.2,
    T_thresh: float = 1e-4,
    obj_feat=None,
    grid_size: int = 128,
    max_rounds: int = 256,
    bucket_base: int = 4096,
    bucket_cap: int = 65536,
    device_loop: bool = False,
):
    """Render a flat ray batch through the compacted worklist loop.

    Returns dict(image [N, 3], depth [N] normalized, weights_sum [N]).
    ``render_rays_iterative.rounds`` counts the rounds of every call.
    """
    aabb = _aabb(cfg, aabb, rays_o.device)
    n = rays_o.shape[0]
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    objfeat_enc = _objfeat_enc(params, cfg, obj_feat)

    extra = lambda t: torch.cat([t, t.new_zeros((1,) + t.shape[1:])])  # noqa: E731  row n
    carried = (extra(nears), extra(torch.zeros_like(nears)), extra(torch.zeros_like(rays_o)),
               extra(torch.zeros_like(nears)), extra(torch.zeros_like(nears)), extra(nears < fars))
    alive = carried[-1][:n]
    kw = dict(sub_slab=sub_slab, dt_gamma=dt_gamma, max_steps=max_steps, grid_size=grid_size,
              T_thresh=T_thresh)

    def step(bucket):
        _round(params, cfg, bucket, rays_o, rays_d, fars, carried, occ_skip, objfeat_enc, aabb, **kw)
        render_rays_iterative.rounds += 1

    if device_loop:
        sweep = min(n, bucket_cap)
        for _ in range(-(-n // sweep)):  # sweep waves touch every ray
            step(sweep)
        for _ in range(max_rounds):
            if not bool(alive.any()):
                break
            step(min(n, bucket_base))
    else:
        buckets = _bucket_ladder(n, base=min(bucket_base, n), cap=bucket_cap)
        for _ in range(max_rounds):
            n_alive = int(alive.sum())  # one scalar d2h per round
            if n_alive == 0:
                break
            step(next(b for b in buckets if b >= min(n_alive, buckets[-1])))

    _, _, acc_rgb, acc_dep, acc_ws, _ = (t[:n] for t in carried)
    image = acc_rgb
    if bg_color is not None:
        image = image + (1.0 - acc_ws)[:, None] * bg_color
    depth = torch.clamp(acc_dep - nears, min=0.0) / torch.clamp(fars - nears, min=1e-10)
    return {"image": image, "depth": depth, "weights_sum": acc_ws}


render_rays_iterative.rounds = 0


def render_image_iterative(params, cfg: NeRFConfig, pose, intrinsics, H: int, W: int, *,
                           occ_skip: torch.Tensor, bg_color=1.0, obj_feat=None, **kw):
    """Full-image iterative render -> (image [H, W, 3], depth [H, W]) on the
    params' device.

    There is no ray chunking: the bucket ladder is the chunking, and one
    worklist over the whole image lets background rays vacate their slots
    for foreground rounds.
    """
    from focnerf_tpu_torch.core.rays import get_rays

    rays = get_rays(pose, intrinsics, H, W, device=params["grid"].device)
    out = render_rays_iterative(params, cfg, rays["rays_o"], rays["rays_d"], occ_skip,
                                bg_color=bg_color, obj_feat=obj_feat, **kw)
    return out["image"].reshape(H, W, 3), out["depth"].reshape(H, W)
