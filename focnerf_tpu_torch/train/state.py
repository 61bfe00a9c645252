"""Training state: params, Adam with its LR schedule, and the EMA shadow.

Twin of focnerf_tpu/train/state.py in the reference's own form
(main_nerf.py:211,265): Adam with betas (0.9, 0.99) and eps 1e-15 under
the schedule ``0.1 ** min(step / iters, 1)``, which is optax's
``adam(schedule)`` step for step (the k-th update uses the schedule at k -
1 on both sides). The update is the port's own, in place, with
``torch.optim.Adam``'s moments and checkpoint format (its ``state`` holds
``step``, ``exp_avg``, ``exp_avg_sq`` per leaf): every number that depends
on the step (the learning rate, Adam's bias corrections, the EMA decay) is
computed on the host by ``hyper`` and enters the update only as a factor,
so ``update`` takes them as Python floats (one step at a time) or as
device scalars staged for a CUDA graph (train/fused.py) and computes the
same values either way. Beside it:

  - ``warmup`` > 0 multiplies the schedule by ``min((step + 1) / warmup, 1)``;
  - ``grad_clip`` > 0 scales every gradient by ``min(1, clip / max(global
    norm, 1e-12))`` before Adam;
  - ``lr_net``: parameter groups whose key ends in ``grid`` train at ``lr``,
    the networks at ``lr_net`` (the JAX package scales their post-Adam
    update by lr_net / lr, the same step);
  - the EMA ``ema = d * ema + (1 - d) * params`` with ``d = min(decay,
    (1 + n) / (10 + n))``, n the updates before this one;
  - a leaf that got no gradient steps with a zero one (optax's tree has
    every leaf).

Params are the field's dict (``grid`` tensor, MLPs as lists of [in, out]
tensors); the optimizer updates them in place.
"""

from __future__ import annotations

import math
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


BETAS = (0.9, 0.99)
EPS = 1e-15


class TrainState:
    """One object's training state; ``apply_gradients`` is one optimizer step.

    ``step`` counts updates (the JAX TrainState's ``step``), ``ema_count``
    the EMA updates and ``adam_count`` Adam's (its bias corrections). All
    three are host integers: reading them costs no sync.
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
        self.adam_count = 0
        self.grad_clip = grad_clip
        self.ema_decay = ema_decay
        groups = [
            {"params": param_leaves({k: v}), "lr": lr if k.endswith("grid") or lr_net is None else lr_net}
            for k, v in self.params.items()
        ]
        # the moments' store and the checkpoint format; ``update`` steps them
        self.optimizer = torch.optim.Adam(groups, lr=lr, betas=BETAS, eps=EPS)
        self.base_lrs = [g["lr"] for g in self.optimizer.param_groups]
        self._factor = lr_lambda(iters, warmup)

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def _moments(self):
        """(exp_avg, exp_avg_sq) lists of every leaf, made (zeros) at first use."""
        ms, vs = [], []
        for p in param_leaves(self.params):
            st = self.optimizer.state[p]
            if not st:
                st["step"] = torch.tensor(float(self.adam_count))
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            ms.append(st["exp_avg"])
            vs.append(st["exp_avg_sq"])
        return ms, vs

    def hyper(self, ahead: int = 0) -> Dict[str, Any]:
        """The step-dependent factors of the update ``ahead`` updates from
        now, as Python floats: ``neg_step`` (per parameter group, -lr /
        bias correction 1), ``inv_bc2`` (1 / sqrt(bias correction 2)), the
        EMA's ``d`` and ``omd`` (1 - d)."""
        c = self.adam_count + ahead + 1
        bc1 = 1.0 - BETAS[0] ** c
        factor = self._factor(self.step + ahead)
        n = self.ema_count + ahead
        d = min(self.ema_decay, (1.0 + n) / (10.0 + n))
        return {
            "neg_step": [-(base * factor) / bc1 for base in self.base_lrs],
            "inv_bc2": 1.0 / math.sqrt(1.0 - BETAS[1] ** c),
            "d": d,
            "omd": 1.0 - d,
        }

    @torch.no_grad()
    def update(self, h: Dict[str, Any]):
        """Clip, Adam and EMA from the gradients autograd left in ``params``
        (then cleared), with the factors ``h`` (``hyper``'s, as floats or as
        0-d device tensors). Device work only: the host counters move in
        ``advance``."""
        leaves = param_leaves(self.params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        if self.grad_clip > 0.0:
            gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            torch._foreach_mul_(grads, scale)
        ms, vs = self._moments()
        torch._foreach_lerp_(ms, grads, 1.0 - BETAS[0])
        torch._foreach_mul_(vs, BETAS[1])
        torch._foreach_addcmul_(vs, grads, grads, value=1.0 - BETAS[1])
        denom = torch._foreach_sqrt(vs)
        torch._foreach_mul_(denom, h["inv_bc2"])
        torch._foreach_add_(denom, EPS)
        i = 0
        for group, neg_step in zip(self.optimizer.param_groups, h["neg_step"]):
            j = i + len(group["params"])
            upd = torch._foreach_mul(ms[i:j], neg_step)
            torch._foreach_div_(upd, denom[i:j])
            torch._foreach_add_(leaves[i:j], upd)
            i = j
        self.zero_grad()
        emas = param_leaves(self.ema_params)
        torch._foreach_mul_(emas, h["d"])
        torch._foreach_add_(emas, torch._foreach_mul(leaves, h["omd"]))

    def advance(self, n: int = 1):
        """Move the host counters past ``n`` updates."""
        self.step += n
        self.ema_count += n
        self.adam_count += n
        for st in self.optimizer.state.values():
            st["step"].fill_(float(self.adam_count))
        for group, base in zip(self.optimizer.param_groups, self.base_lrs):
            group["lr"] = base * self._factor(self.step)

    def apply_gradients(self):
        """One optimizer step: clip, Adam, schedule and EMA, from the
        gradients autograd left in ``params``; then clears them."""
        self.update(self.hyper())
        self.advance(1)

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
            steps = [int(st["step"]) for st in self.optimizer.state.values() if "step" in st]
            self.adam_count = max(steps, default=0)
        # this run's schedule (its --iters may differ) at the saved step
        for group, base in zip(self.optimizer.param_groups, self.base_lrs):
            group["lr"] = base * self._factor(self.step)
