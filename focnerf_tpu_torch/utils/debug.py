"""Numerical-health guards.

Twin of focnerf_tpu/utils/debug.py:

  - ``tree_health``: per floating leaf of a params tree or state dict (dicts,
    lists and tuples of tensors or arrays) its NaN and Inf counts and its
    largest magnitude, named as JAX's ``keystr`` names them (``['grid']``,
    ``['sigma_net'][0]``);
  - ``assert_finite``: raise ``FloatingPointError`` naming every leaf that
    holds a NaN or an Inf;
  - ``checkify_step``: the counterpart of JAX's checkify wrapper for the
    port's steps, which take a ``TrainState`` first and update it in place.
    The wrapped step raises on the first non-finite gradient (before Adam
    applies it), parameter or loss.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def tree_health(tree: Any) -> Dict[str, Dict[str, float]]:
    """Per floating leaf: {"nan", "inf", "absmax"} (host copies, one sync each)."""
    out = {}
    for name, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            if not leaf.is_floating_point():
                continue
            a = leaf.detach().float().cpu().numpy()  # numpy has no bf16
        else:
            a = np.asarray(leaf)
            if not np.issubdtype(a.dtype, np.floating):
                continue
        out[name] = {
            "nan": int(np.isnan(a).sum()),
            "inf": int(np.isinf(a).sum()),
            "absmax": float(np.abs(a).max()) if a.size else 0.0,
        }
    return out


def assert_finite(tree: Any, where: str = ""):
    bad = {k: v for k, v in tree_health(tree).items() if v["nan"] or v["inf"]}
    if bad:
        raise FloatingPointError(f"non-finite values {where}: {bad}")


def checkify_step(step_fn):
    """``step_fn(state, ...) -> metrics`` that raises ``FloatingPointError``
    on a non-finite gradient (checked before the optimizer applies it), and
    then on non-finite parameters or a non-finite ``metrics["loss"]``."""
    from focnerf_tpu_torch.train.state import param_leaves

    @functools.wraps(step_fn)
    def checked(state, *args, **kwargs):
        apply = state.apply_gradients

        def guarded_apply():
            assert_finite([p.grad for p in param_leaves(state.params)], "in the gradients")
            apply()

        state.apply_gradients = guarded_apply
        try:
            metrics = step_fn(state, *args, **kwargs)
        finally:
            del state.apply_gradients  # the class's method again
        assert_finite(state.params, "in the parameters after the step")
        assert_finite({"loss": metrics["loss"]}, "in the loss")
        return metrics

    return checked
