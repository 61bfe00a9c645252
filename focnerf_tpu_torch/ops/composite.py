"""Transmittance compositing: plain PyTorch and the fused CUDA kernels.

Twin of focnerf_tpu/ops/composite.py (``composite_weights``,
``composite_rays``) and of focnerf_tpu/ops/composite_pallas.py
(``composite_rays_fused``, whose custom VJP differentiates the jnp
reference). Transmittance is ``exp(-exclusive prefix sum of optical
depth)``, the exclusive prefix built by SHIFTING an inclusive cumsum, never
as ``acc - s``: a sigma spike to inf then keeps the spiked sample's finite
entering T and zeroes everything behind it. Early termination is the mask
``T_in >= T_thresh``.

``composite_rays_fused`` is the render and train paths' compositor, and it
is differentiable in ``sigmas`` and ``rgbs`` (and in a background tensor
that requires grad). On CPU tensors it is the plain ``composite_rays``,
which autograd differentiates. On CUDA tensors it is a
``torch.autograd.Function`` whose forward launches
``focnerf_composite_forward`` and whose backward launches
``focnerf_composite_backward`` (``csrc/composite.cu``), or raises. ``ts``
and ``deltas`` get no gradient: the marcher made them.

``composite_rays_resume`` is the iterative eval renderer's per-round
compositor (forward only): the row enters at the optical depth the ray
carries from its earlier rounds, and the depth it leaves with is returned
for the next round. On CUDA tensors it launches the same forward kernel.
"""

from __future__ import annotations

import ctypes

import torch


def composite_weights(sigmas, deltas, density_scale: float = 1.0, T_thresh: float = 0.0,
                      od0=None):
    """Per-sample weights [..., T] (alpha_i * T_i, zeroed after early exit).

    ``od0`` [...]: the optical depth carried in, added to every sample's
    exclusive prefix (focnerf_tpu/render/iterative.py's round math)."""
    s = deltas.float() * density_scale * sigmas.float()
    alphas = 1.0 - torch.exp(-s)
    acc_excl = torch.cat(
        [torch.zeros_like(s[..., :1]), torch.cumsum(s[..., :-1], dim=-1)], dim=-1
    )
    if od0 is not None:
        acc_excl = od0.float()[..., None] + acc_excl
    trans_in = torch.exp(-acc_excl)
    weights = alphas * trans_in
    if T_thresh > 0.0:
        weights = torch.where(trans_in >= T_thresh, weights, torch.zeros_like(weights))
    return weights


def composite_rays(
    sigmas,
    rgbs,
    deltas,
    ts=None,
    bg_color=None,
    density_scale: float = 1.0,
    T_thresh: float = 0.0,
):
    """Full ray compositing -> dict(image [..., 3], depth, weights_sum, weights).

    ``bg_color``: None | scalar | [3] | [..., 3]; blended as image + (1-ws)*bg.
    """
    weights = composite_weights(sigmas, deltas, density_scale, T_thresh)
    weights_sum = weights.sum(-1)
    image = (weights[..., None] * rgbs.float()).sum(-2)
    if ts is not None:
        depth = (weights * ts.float()).sum(-1)
    else:
        depth = torch.zeros_like(weights_sum)
    if bg_color is not None:
        image = image + (1.0 - weights_sum)[..., None] * bg_color
    return {"image": image, "depth": depth, "weights_sum": weights_sum, "weights": weights}


def _bg_operand(bg_color, n: int, device) -> tuple:
    """bg as (tensor or None, row stride): None, scalar/[3] -> stride 0, [n,3] -> 3."""
    if bg_color is None:
        return None, 0
    if isinstance(bg_color, (int, float)):
        return torch.full((3,), float(bg_color), dtype=torch.float32, device=device), 0
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=device).detach()
    if bg.dim() == 0:
        return bg.expand(3).contiguous(), 0
    if bg.shape == (3,):
        return bg.contiguous(), 0
    if bg.shape == (n, 3):
        return bg.contiguous(), 3
    raise ValueError(f"bg_color must be None, a scalar, [3] or [{n}, 3]; got {tuple(bg.shape)}")


def _check(named, n: int, T: int, device):
    shapes = {"sigmas": (n, T), "rgbs": (n, T, 3), "deltas": (n, T), "ts": (n, T)}
    for name, t in named.items():
        shape = shapes.get(name, (n, 3) if name in ("image", "g_image") else (n,))
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {shape}, got {tuple(t.shape)}")


def _function(name: str, n_ptrs: int):
    """The kernel library's C function ``name`` with its argtypes set: five
    input pointers, the background's row stride, ``n_ptrs`` more pointers,
    n, T and the group width, then density_scale, T_thresh and the stream."""
    from focnerf_tpu_torch.ops._build import load_library

    fn = getattr(load_library("composite"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [
            ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    return fn


def group_width(T: int) -> int:
    """Lanes per ray of both kernels: the power of two >= T, at most a warp
    (32). A group reads a chunk of that many samples at once."""
    G = 1
    while G < min(T, 32):
        G *= 2
    return G


def _launch(sigmas, rgbs, deltas, ts, bg, bg_stride, density_scale, T_thresh, od0=None):
    """Checks the operands, then launches the forward kernel with
    ``group_width(T)`` lanes per ray -> (image, weights_sum, depth, od): with
    ``od0`` (the optical depth carried in) ``od`` is the carry at which each
    ray stopped, else None."""
    n, T = sigmas.shape
    named = dict(sigmas=sigmas, rgbs=rgbs, deltas=deltas, ts=ts)
    if od0 is not None:
        named["od0"] = od0
    _check(named, n, T, sigmas.device)
    image = torch.empty((n, 3), dtype=torch.float32, device=sigmas.device)
    weights_sum = torch.empty((n,), dtype=torch.float32, device=sigmas.device)
    depth = torch.empty((n,), dtype=torch.float32, device=sigmas.device)
    od = torch.empty((n,), dtype=torch.float32, device=sigmas.device) if od0 is not None else None
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _function("focnerf_composite_forward", 5)(
        sigmas.data_ptr(), rgbs.data_ptr(), deltas.data_ptr(), ts.data_ptr(), ptr(bg), bg_stride,
        ptr(od0), image.data_ptr(), weights_sum.data_ptr(), depth.data_ptr(), ptr(od),
        n, T, group_width(T), float(density_scale), float(T_thresh),
        torch.cuda.current_stream(sigmas.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"composite forward kernel launch failed: cudaError {err}")
    return image, weights_sum, depth, od


def composite_rays_fused_backward(
    sigmas, rgbs, deltas, ts, bg_color, outputs, grads, density_scale: float = 1.0,
    T_thresh: float = 0.0,
):
    """(d_sigmas [N, T], d_rgbs [N, T, 3]) of the fused composite.

    ``outputs`` = (image, weights_sum, depth) of the forward on the same
    inputs, ``grads`` their cotangents (None for a zero cotangent). CPU
    tensors: autograd of the plain ``composite_rays``. CUDA tensors: the
    backward kernel, which counts one launch in
    ``composite_rays_fused_backward.launches``.
    """
    grads = [torch.zeros_like(o) if g is None else g.float().contiguous()
             for o, g in zip(outputs, grads)]
    if not sigmas.is_cuda:
        if sigmas.device.type != "cpu":
            raise ValueError(f"composite_rays_fused_backward: unsupported device {sigmas.device}")
        with torch.enable_grad():
            s, c = sigmas.detach().requires_grad_(), rgbs.detach().requires_grad_()
            out = composite_rays(s, c, deltas, ts, bg_color, density_scale, T_thresh)
            return torch.autograd.grad(
                (out["image"], out["weights_sum"], out["depth"]), (s, c), grads
            )
    return _backward_launch(sigmas, rgbs, deltas, ts, bg_color, outputs, grads, density_scale,
                            T_thresh)


def _backward_launch(sigmas, rgbs, deltas, ts, bg_color, outputs, grads, density_scale,
                     T_thresh):
    """Checks the operands, then launches the backward kernel with
    ``group_width(T)`` lanes per ray."""
    n, T = sigmas.shape
    bg, bg_stride = _bg_operand(bg_color, n, sigmas.device)
    image, weights_sum, depth = outputs
    g_image, g_weights_sum, g_depth = grads
    _check(dict(sigmas=sigmas, rgbs=rgbs, deltas=deltas, ts=ts, image=image,
                weights_sum=weights_sum, depth=depth, g_image=g_image,
                g_weights_sum=g_weights_sum, g_depth=g_depth), n, T, sigmas.device)
    d_sigmas = torch.empty((n, T), dtype=torch.float32, device=sigmas.device)
    d_rgbs = torch.empty((n, T, 3), dtype=torch.float32, device=sigmas.device)
    err = _function("focnerf_composite_backward", 8)(
        sigmas.data_ptr(), rgbs.data_ptr(), deltas.data_ptr(), ts.data_ptr(),
        bg.data_ptr() if bg is not None else None, bg_stride,
        image.data_ptr(), weights_sum.data_ptr(), depth.data_ptr(),
        g_image.data_ptr(), g_weights_sum.data_ptr(), g_depth.data_ptr(),
        d_sigmas.data_ptr(), d_rgbs.data_ptr(),
        n, T, group_width(T), float(density_scale), float(T_thresh),
        torch.cuda.current_stream(sigmas.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"composite backward kernel launch failed: cudaError {err}")
    composite_rays_fused_backward.launches += 1
    return d_sigmas, d_rgbs


class _CompositeFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, rgbs, deltas, ts, bg_color, density_scale, T_thresh):
        bg, bg_stride = _bg_operand(bg_color, sigmas.shape[0], sigmas.device)
        outputs = _launch(sigmas, rgbs, deltas, ts, bg, bg_stride, density_scale, T_thresh)[:3]
        composite_rays_fused.launches += 1
        ctx.save_for_backward(sigmas, rgbs, deltas, ts, *outputs)
        ctx.bg_color = bg_color
        ctx.bg_grad = torch.is_tensor(bg_color) and bg_color.requires_grad
        ctx.args = (density_scale, T_thresh)
        return outputs

    @staticmethod
    def backward(ctx, g_image, g_weights_sum, g_depth):
        sigmas, rgbs, deltas, ts, *outputs = ctx.saved_tensors
        d_sigmas, d_rgbs = composite_rays_fused_backward(
            sigmas, rgbs, deltas, ts, ctx.bg_color, outputs, (g_image, g_weights_sum, g_depth),
            *ctx.args,
        )
        d_bg = None
        if ctx.bg_grad and g_image is not None:
            # image += (1 - weights_sum) * bg, reduced to the background's shape
            d_bg = g_image * (1.0 - outputs[1])[:, None]
            d_bg = d_bg.sum(0) if ctx.bg_color.dim() == 1 else d_bg
            d_bg = d_bg.sum() if ctx.bg_color.dim() == 0 else d_bg
        return d_sigmas, d_rgbs, None, None, d_bg, None, None


def composite_rays_fused(
    sigmas, rgbs, deltas, ts, bg_color=None, density_scale: float = 1.0, T_thresh: float = 0.0
):
    """Fused composite -> (image [N, 3], weights_sum [N], depth [N]), fp32.

    sigmas, deltas, ts [N, T]; rgbs [N, T, 3]; ``bg_color`` None, a scalar,
    [3] or [N, 3], blended in as ``image += (1 - weights_sum) * bg``. CPU
    tensors take the plain version; CUDA tensors take the kernels (one launch
    counted in ``composite_rays_fused.launches`` per forward, one in
    ``composite_rays_fused_backward.launches`` per backward).
    """
    if sigmas.is_cuda:
        return _CompositeFused.apply(sigmas, rgbs, deltas, ts, bg_color, density_scale, T_thresh)
    if sigmas.device.type != "cpu":
        raise ValueError(f"composite_rays_fused: unsupported device {sigmas.device}")
    out = composite_rays(sigmas, rgbs, deltas, ts, bg_color, density_scale, T_thresh)
    return out["image"], out["weights_sum"], out["depth"]


def composite_resume_plain(sigmas, rgbs, deltas, ts, od0, density_scale: float = 1.0,
                           T_thresh: float = 0.0):
    """The plain version of ``composite_rays_resume``: the round's
    compositing of focnerf_tpu/render/iterative.py:91-106, with ``od`` =
    od0 plus the sum of s over the row."""
    w = composite_weights(sigmas, deltas, density_scale, T_thresh, od0=od0)
    s = deltas.float() * density_scale * sigmas.float()
    return ((w[..., None] * rgbs.float()).sum(-2), w.sum(-1), (w * ts.float()).sum(-1),
            od0.float() + s.sum(-1))


def composite_rays_resume(sigmas, rgbs, deltas, ts, od0, density_scale: float = 1.0,
                          T_thresh: float = 0.0):
    """One round of a ray's compositing, entering at its carried optical
    depth ``od0`` [N] -> (rgb [N, 3] without background, weights_sum [N],
    depth [N] from the raw ``ts``, od [N]), fp32, without gradients.

    ``od`` is the optical depth the ray leaves with. The plain version
    returns od0 plus the sum of s over the row. The kernel stops a ray at
    the first chunk it enters with T_in < T_thresh and returns the carry
    there: below the row's sum, but already past T_thresh, so the ray
    leaves the worklist either way. CPU tensors take the plain version;
    CUDA tensors the forward kernel, one launch counted in
    ``composite_rays_resume.launches``.
    """
    if sigmas.is_cuda:
        out = _launch(sigmas, rgbs, deltas, ts, None, 0, density_scale, T_thresh, od0=od0)
        composite_rays_resume.launches += 1
        return out
    if sigmas.device.type != "cpu":
        raise ValueError(f"composite_rays_resume: unsupported device {sigmas.device}")
    return composite_resume_plain(sigmas, rgbs, deltas, ts, od0, density_scale, T_thresh)


composite_rays_fused.launches = 0
composite_rays_fused_backward.launches = 0
composite_rays_resume.launches = 0
