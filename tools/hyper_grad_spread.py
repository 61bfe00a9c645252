"""How far the hyper D-NeRF field's gradients move between two correct
fp32 evaluations, on the CPU: JAX against itself and the port against JAX.

The full-scale hyper field of ``main_dnerf -O --hyper`` (16 levels x 2, a
2^19 table per level over the 5-D lifted coordinates, bound 2), its table
drawn U(-0.1, 0.1) at every level (the setting in which the card and the
CPU read hyper_net's gradient 1.04e-2 and 1.12e-2 rel L2 apart), on
``--points`` points along rays through the box at one time. The loss is
sum(c1 * log1p(sigma)) + sum(c2 * rgb) with fixed random weights. Its
gradient is taken four ways, each in its own process: JAX eager fp32
(``jax.disable_jit``), JAX jitted fp32 (XLA fuses and contracts), JAX fp64
(``jax_enable_x64``: the reference the others approximate), and the port
in fp32 on the CPU. It prints, per parameter group, the rel L2 distance of
each fp32 gradient from JAX fp64 and from each other.

    JAX_PLATFORMS=cpu python tools/hyper_grad_spread.py [--points 32768] [--seed 0]

CPU only (minutes at the default size).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(n_points: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    n_rays, s = n_points // 64, 64
    eye = rng.normal(size=(n_rays, 3))
    eye = (3.0 * eye / np.linalg.norm(eye, axis=-1, keepdims=True)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)) * 0.3 - eye / 3.0
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = np.linspace(1.2, 4.8, s, dtype=np.float32)
    x = np.clip(eye[:, None] + d[:, None] * t[None, :, None], -2.0, 2.0).astype(np.float32)
    dirs = np.broadcast_to(d[:, None], x.shape).astype(np.float32).copy()
    c1 = rng.normal(size=x.shape[:-1]).astype(np.float32)
    c2 = rng.normal(size=x.shape).astype(np.float32)
    return x, dirs, c1, c2


def _jax_grads(params, x, d, c1, c2, t, mode: str):
    """JAX's gradient of the loss in ``mode``: eager, jit or fp64."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from focnerf_tpu.config import parse_options
    from focnerf_tpu.models import dnerf as jdn

    cfg = parse_options(["s", "-O", "--hyper"], dnerf=True).dnerf_config()
    dtype = jnp.float64 if mode == "fp64" else jnp.float32
    cfg = cfg.__class__(**{**vars(cfg), "compute_dtype": dtype})

    def loss(p):
        s, rgb, _ = jdn.dnerf_field(p, cfg, jnp.asarray(x, dtype), jnp.asarray(d, dtype), jnp.asarray(t, dtype))
        return jnp.sum(jnp.asarray(c1, dtype) * jnp.log1p(s)) + jnp.sum(jnp.asarray(c2, dtype) * rgb)

    p = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    if mode == "eager":
        with jax.disable_jit():
            g = jax.grad(loss)(p)
    else:
        g = jax.jit(jax.grad(loss))(p)
    return jax.tree.map(lambda a: np.asarray(a, np.float64), g)


def _run(mode: str, n_points: int, seed: int, out: str):
    """One evaluation in its own process (fp64 needs ``jax_enable_x64``
    before JAX starts); writes the gradients to ``out`` (npz)."""
    import numpy as np

    import jax

    if mode == "fp64":
        jax.config.update("jax_enable_x64", True)

    from focnerf_tpu.config import parse_options
    from focnerf_tpu.models import dnerf as jdn

    cfg = parse_options(["s", "-O", "--hyper"], dnerf=True).dnerf_config()
    params = jax.tree.map(np.asarray, jdn.init_dnerf_params(jax.random.key(seed), cfg))
    params["grid"] = np.random.default_rng(seed + 1).uniform(-0.1, 0.1, params["grid"].shape).astype(np.float32)
    x, d, c1, c2 = _inputs(n_points, seed)
    t = np.float32(0.4)
    flat = {}
    if mode == "port":
        import torch

        from focnerf_tpu_torch import interop
        from focnerf_tpu_torch.config import parse_options as tparse
        from focnerf_tpu_torch.models import dnerf as tdn
        from focnerf_tpu_torch.train.state import param_leaves

        tcfg = tparse(["s", "-O", "--hyper"]).dnerf_config()
        tcfg = tcfg.__class__(**{**vars(tcfg), "compute_dtype": torch.float32})
        tp = interop.dnerf_params_from_jax(params, tcfg, "cpu")
        for w in param_leaves(tp):
            w.requires_grad_(True)
        s, rgb, _ = tdn.dnerf_field(tp, tcfg, torch.from_numpy(x), torch.from_numpy(d), torch.tensor(t))
        loss = (torch.from_numpy(c1) * torch.log1p(s)).sum() + (torch.from_numpy(c2) * rgb).sum()
        loss.backward()
        for key, value in tp.items():
            for i, w in enumerate(value if isinstance(value, list) else [value]):
                flat[f"{key}/{i}"] = w.grad.double().numpy()
    else:
        g = _jax_grads(params, x, d, c1, c2, t, mode)
        for key, value in g.items():
            for i, w in enumerate(value if isinstance(value, list) else [value]):
                flat[f"{key}/{i}"] = np.asarray(w, np.float64)
    np.savez(out, **flat)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mode:
        _run(args.mode, args.points, args.seed, args.out)
        return 0
    import tempfile

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="hyper_grad_spread_")
    grads = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    for mode in ("fp64", "eager", "jit", "port"):
        out = os.path.join(tmp, f"{mode}.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--mode", mode, "--points", str(args.points),
                        "--seed", str(args.seed), "--out", out], check=True, env=env)
        grads[mode] = dict(np.load(out))
    keys = list(grads["fp64"])
    groups = sorted({k.split("/")[0] for k in keys})

    def rel(a, b, group):
        ks = [k for k in keys if k.split("/")[0] == group]
        num = np.sqrt(sum(float(((grads[a][k] - grads[b][k]) ** 2).sum()) for k in ks))
        den = np.sqrt(sum(float((grads[b][k] ** 2).sum()) for k in ks))
        return num / max(den, 1e-300)

    print(f"hyper field, full scale (16 levels x 2, 2^19 per level, 5-D, bound 2), table U(-0.1, 0.1), "
          f"{args.points} points, seed {args.seed}: rel L2 distance of the gradients per parameter group")
    pairs = (("eager", "fp64"), ("jit", "fp64"), ("port", "fp64"), ("jit", "eager"), ("port", "eager"),
             ("port", "jit"))
    print("group".ljust(12) + "".join(f"{a} vs {b}".rjust(18) for a, b in pairs))
    for group in groups:
        print(group.ljust(12) + "".join(f"{rel(a, b, group):18.3e}" for a, b in pairs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
