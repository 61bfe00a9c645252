"""Convert a focnerf_tpu (JAX/orbax) object checkpoint to a focnerf_tpu_torch one.

This is how a model trained by the JAX package is served by the port:

  python tools/jax_ckpt_to_torch.py ws_background/checkpoints ws_torch_background/checkpoints
  python -m focnerf_tpu_torch.apps.main_nerf <scene> --test -O --workspace ws_torch

It restores the orbax checkpoint with the JAX package (its
``model_config.json`` gives the architecture), hands the train state (params,
Adam moments, EMA params and counters) and the occupancy grid to
``focnerf_tpu_torch.interop`` as numpy arrays, and writes the port's
``ckpt_<step>.pt`` beside the same ``model_config.json``: the port serves it
with ``--test`` and resumes training from it with ``--ckpt latest``. Runs on
the CPU; needs both packages.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(src: str, dst: str, step=None) -> int:
    """Convert the checkpoint at ``step`` (default: latest) of the JAX
    checkpoint directory ``src`` into the port's directory ``dst``.
    Returns the step converted."""
    import jax
    import numpy as np

    from focnerf_tpu.train.checkpoints import CheckpointManager as JaxCheckpointManager
    from focnerf_tpu.train.checkpoints import load_model_config
    from focnerf_tpu.train.state import create_train_state, make_optimizer
    from focnerf_tpu_torch.interop import config_from_dict, occupancy_from_jax, train_state_from_jax
    from focnerf_tpu_torch.train.checkpoints import CheckpointManager, save_model_config

    jcfg = load_model_config(src)
    if jcfg is None:
        raise FileNotFoundError(f"no model_config.json under {src}")
    template = create_train_state(jax.random.key(0), jcfg, make_optimizer())
    mgr = JaxCheckpointManager(src)
    try:
        restored = mgr.restore(template, step=step)
    finally:
        mgr.close()
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {src}")
    state, occ, _ = restored

    with open(os.path.join(src, "model_config.json")) as f:
        cfg = config_from_dict(json.load(f))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    adam = state.opt_state[0]  # optax adam: (ScaleByAdamState, ScaleByScheduleState)
    tstate = train_state_from_jax(
        params=to_np(state.params), mu=to_np(adam.mu), nu=to_np(adam.nu), count=int(adam.count),
        ema_params=to_np(state.ema_params), ema_count=int(state.ema_count),
        step=int(state.step), cfg=cfg, device="cpu",
    )
    occupancy = None
    if occ is not None:
        occupancy = occupancy_from_jax(to_np(occ._asdict()), cfg.bound, "cpu")
    save_model_config(dst, cfg)
    CheckpointManager(dst).save(tstate.state_dict(), occupancy)
    return tstate.step


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="JAX checkpoint directory (workspace_<obj>/checkpoints)")
    p.add_argument("dst", help="port checkpoint directory to write")
    p.add_argument("--step", type=int, default=None, help="step to convert (default: latest)")
    args = p.parse_args(argv)
    step = convert(args.src, args.dst, args.step)
    print(f"converted step {step}: {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
