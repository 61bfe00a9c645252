"""Training state: params, Adam with its LR schedule, and the EMA shadow.

Twin of focnerf_tpu/train/state.py in the reference's own form
(main_nerf.py:211,265): ``torch.optim.Adam(betas=(0.9, 0.99), eps=1e-15)``
with a ``LambdaLR`` of ``0.1 ** min(step / iters, 1)`` stepped every
iteration, which is optax's ``adam(schedule)`` step for step (the k-th
update uses the schedule at k - 1 on both sides). Beside it:

  - ``warmup`` > 0 multiplies the schedule by ``min((step + 1) / warmup, 1)``;
  - ``grad_clip`` > 0 scales every gradient by ``min(1, clip / max(global
    norm, 1e-12))`` before Adam;
  - ``lr_net``: parameter groups whose key ends in ``grid`` train at ``lr``,
    the networks at ``lr_net`` (the JAX package scales their post-Adam
    update by lr_net / lr, the same step);
  - the EMA ``ema = d * ema + (1 - d) * params`` with ``d = min(decay,
    (1 + n) / (10 + n))``, n the updates before this one.

Params are the field's dict (``grid`` tensor, MLPs as lists of [in, out]
tensors); the optimizer updates them in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

Params = Dict[str, Any]


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The tensors of a params dict in a fixed order (keys, then layers)."""
    out = []
    for key, value in params.items():
        out += list(value) if isinstance(value, (list, tuple)) else [value]
    return out


def detached(params: Params) -> Params:
    return {k: [w.detach() for w in v] if isinstance(v, (list, tuple)) else v.detach()
            for k, v in params.items()}


def clone_params(params: Params, requires_grad: bool = False) -> Params:
    def leaf(t):
        return t.detach().clone().requires_grad_(requires_grad)

    return {k: [leaf(w) for w in v] if isinstance(v, (list, tuple)) else leaf(v)
            for k, v in params.items()}


def lr_lambda(iters: int, warmup: int = 0):
    """The schedule factor of step k (updates before this one)."""

    def factor(step: int) -> float:
        s = 0.1 ** min(step / iters, 1.0)
        if warmup > 0:
            s *= min((step + 1.0) / warmup, 1.0)
        return s

    return factor


class TrainState:
    """One object's training state; ``apply_gradients`` is one optimizer step.

    ``step`` counts updates (the JAX TrainState's ``step``), ``ema_count``
    the EMA updates. Both are host integers: reading them costs no sync.
    """

    def __init__(
        self,
        params: Params,
        *,
        lr: float = 1e-2,
        iters: int = 30000,
        lr_net: Optional[float] = None,
        warmup: int = 0,
        grad_clip: float = 0.0,
        ema_decay: float = 0.95,
        ema_params: Optional[Params] = None,
        step: int = 0,
        ema_count: int = 0,
    ):
        self.params = clone_params(params, requires_grad=True)
        self.ema_params = clone_params(ema_params if ema_params is not None else params)
        self.step = step
        self.ema_count = ema_count
        self.grad_clip = grad_clip
        self.ema_decay = ema_decay
        groups = [
            {"params": param_leaves({k: v}), "lr": lr if k.endswith("grid") or lr_net is None else lr_net}
            for k, v in self.params.items()
        ]
        self.optimizer = torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.99), eps=1e-15)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, lr_lambda(iters, warmup))

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self):
        """Clip, Adam, schedule and EMA, from the gradients autograd left in
        ``params``; then clears them."""
        leaves = param_leaves(self.params)
        if self.grad_clip > 0.0:
            grads = [p.grad for p in leaves if p.grad is not None]
            gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            torch._foreach_mul_(grads, scale)
        self.optimizer.step()
        self.scheduler.step()
        self.zero_grad()
        d = min(self.ema_decay, (1.0 + self.ema_count) / (10.0 + self.ema_count))
        with torch.no_grad():
            for e, p in zip(param_leaves(self.ema_params), leaves):
                e.mul_(d).add_(p, alpha=1.0 - d)
        self.step += 1
        self.ema_count += 1

    def state_dict(self) -> dict:
        """The saved form (tensors shared with this state, not copied)."""
        return {
            "step": self.step,
            "params": detached(self.params),
            "ema_params": detached(self.ema_params),
            "ema_count": self.ema_count,
            "optimizer": self.optimizer.state_dict(),
        }

    def load_state_dict(self, sd: dict, weights_only: bool = False):
        """Adopt a saved state. ``weights_only`` takes the params and EMA
        params and keeps this state's fresh optimizer and counters (the
        ``latest_model`` resume mode). A checkpoint without optimizer state
        (written for serving) keeps the fresh Adam moments. The LR follows
        this state's schedule at the saved step."""
        with torch.no_grad():
            for p, q in zip(param_leaves(self.params), param_leaves(sd["params"])):
                p.copy_(q)
            for e, q in zip(param_leaves(self.ema_params), param_leaves(sd["ema_params"])):
                e.copy_(q)
        if weights_only:
            return
        self.step = int(sd["step"])
        self.ema_count = int(sd.get("ema_count", sd["step"]))
        if "optimizer" in sd:
            self.optimizer.load_state_dict(sd["optimizer"])
        # this run's schedule (its --iters may differ) at the saved step
        self.scheduler.last_epoch = self.step
        for group, base, factor in zip(
            self.optimizer.param_groups, self.scheduler.base_lrs, self.scheduler.lr_lambdas
        ):
            group["lr"] = base * factor(self.step)
