#!/usr/bin/env python3
"""Time the hash encode kernels (csrc/hashgrid_fwd.cu) of one checkout of
the port on the card, on operands saved once, so two checkouts compare on
the same inputs.

    python3 tools/time_encode_kernels.py --make_inputs FILE
    python3 tools/time_encode_kernels.py --inputs FILE [--root DIR] [--label NAME]

``--make_inputs`` makes the operand sets with this checkout and saves them
to FILE (about 450 MB): the -O training encode (524,288 points x 16
levels, K 1 on every level, residuals on), the exact serving encode at
the same points (128 columns, residuals off), one -O2 c2f stage (8 levels,
K 1, residuals on), D-NeRF's deform field (D = 3) and hyper field (D = 5)
at 524,288 points (the exact encode with residuals, as a training step
asks, and the position gradient with a N(0, 1) cotangent). Each set's
points are ``chip_smoke.encode_points``' (a twentieth outside the cube, a
quarter on or one ulp beside a cell face), its table U(-1, 1). It also
saves each set's bounds, computed from these operands: the bytes the
function must move (coordinates, draws and cotangent read, each table row
touched read once, the outputs written) over the HBM rate, and the L2
sectors its gathers must fetch (one 32-byte sector for every corner read on
a hashed level) over an L2 read rate measured on the card
(``utils/measure.l2_read_bytes_per_s``: a read kernel over a 40 MB buffer
that stays in L2).

``--inputs`` imports ``focnerf_tpu_torch`` from DIR (default: this
checkout), holds its kernels against the plain versions on every set (the
encode's rows bit for bit, weights within 1e-6 relative + 1e-7, out within
1e-6 of the table's largest value; the position gradient within 1e-5 rel
L2, two runs equal, 0 outside the cube) and prints each kernel's own
device time per call (torch.profiler, 100 calls, the kernel's events
alone: this checkout's ``utils/measure.kernel_ms``), warm and with L2
flushed (``flush=True``: a 256 MB buffer zeroed before every launch).

``--tiles encode:P:W:R,grad:P:W,...`` also times each kernel with tiles
of P points, W warps and (the encode's residuals) R levels a chunk, beside
the wrapper's own choice, where the checkout's ``ops/hashgrid.py`` lays
out tiles (``_layout``).

Run the parent and the change in one call, in turns (parent, change,
change, parent): times from different calls do not compare.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS, SAMPLES = 4096, 128  # 524,288 points: one -O training batch
# the kernels' names in a torch.profiler trace, for a checkout that does
# not name them (ops/hashgrid.py's ENCODE_KERNEL, INPUT_GRAD_KERNEL)
ENCODE_KERNEL, INPUT_GRAD_KERNEL = "encode_kernel", "input_grad_kernel"
L2_PROBE_BYTES = 40 * 2**20


def load_module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(path: str) -> None:
    import torch

    sys.path.insert(0, HERE)
    cs = load_module("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.ops import hashgrid as thg
    from focnerf_tpu_torch.utils import measure

    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(18)
    l2_rate = measure.l2_read_bytes_per_s(L2_PROBE_BYTES, dev)

    def table_for(spec):
        return torch.rand((spec.table_rows, spec.level_dim), generator=g, device=dev) * 2 - 1

    def draws(spec, n):
        return torch.rand((n, len(thg.stochastic_levels(spec)), spec.stochastic_k, spec.input_dim), generator=g,
                          device=dev)

    def bounds(spec, table, x, u, residuals, cot=None):
        """(byte-bound ms, L2-sector-bound ms, bytes, sectors) of the encode
        (``cot`` None) or the position gradient, the table rows touched
        counted from the plain encode's."""
        _, rows, _ = thg.encode_plain(table, x, spec, u, residuals=True)
        n, J = rows.shape
        touched = int(torch.unique(rows).numel())
        del rows
        L, C, D = spec.num_levels, spec.level_dim, spec.input_dim
        corners = spec.stochastic_k if u is not None else 1 << D
        if cot is None:
            nbytes = (n * D * 4 + (0 if u is None else u.numel() * 4) + touched * C * 4 + n * L * C * 4
                      + (n * J * 8 if residuals else 0))
        else:
            nbytes = n * D * 4 + cot.numel() * 4 + touched * C * 4 + n * D * 4
        return (nbytes / cs.HBM_BYTES_PER_S * 1e3, cs.sector_bound_ms(spec, n, corners, l2_rate), nbytes,
                n * sum(spec.hashed) * corners)

    sets = []
    cfg = parse_options(["scene", "-O"]).nerf_config()
    spec = cfg.grid_spec
    table = table_for(spec)
    x = cs.encode_points(spec, cs.ray_points01(cfg, SAMPLES, g, N_RAYS), g)
    u = draws(spec, x.shape[0])
    sets.append(("-O training encode", spec, dict(table=table, x=x, u=u), True, bounds(spec, table, x, u, True)))
    exact = dataclasses.replace(spec, stochastic_k=0, stochastic_min_size=0)
    sets.append(("serving exact encode", exact, dict(table=table, x=x), False, bounds(exact, table, x, None, False)))
    o2 = parse_options(["scene", "-O2"]).nerf_config()
    sub = dataclasses.replace(o2.grid_spec, grad_levels=(1, 3, 5, 7)).truncate(8)
    u2 = draws(sub, x.shape[0])
    t2 = table[: sub.table_rows].contiguous()
    sets.append(("-O2 c2f stage of 8 levels", sub, dict(table=t2, x=x, u=u2), True, bounds(sub, t2, x, u2, True)))
    for name, argv in (("D-NeRF deform field", ["scene", "-O"]), ("D-NeRF hyper field", ["scene", "-O", "--hyper"])):
        dcfg = parse_options(argv).dnerf_config()
        dspec = dcfg.field_spec
        xd = cs.ray_points01(dcfg, SAMPLES, g, N_RAYS)
        if dspec.input_dim > 3:  # the hyper field's lifted coordinates, a sigmoid's range
            lifted = torch.sigmoid(torch.randn((xd.shape[0], dspec.input_dim - 3), generator=g, device=dev))
            xd = torch.cat([xd, lifted], -1)
        xd = cs.encode_points(dspec, xd, g)
        cot = torch.randn((xd.shape[0], dspec.output_dim), generator=g, device=dev)
        ops = dict(table=table_for(dspec), x=xd)
        sets.append((name, dspec, ops, True, bounds(dspec, ops["table"], xd, None, True)))
        sets.append((name + ", position gradient", dspec, dict(ops, cot=cot), None,
                     bounds(dspec, ops["table"], xd, None, True, cot)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    saved = []
    for name, spec, ops, residuals, bound in sets:
        saved.append(dict(name=name, spec=dataclasses.asdict(spec), ops={k: v.cpu() for k, v in ops.items()},
                          residuals=residuals, bound=bound))
        print(f"[encode-inputs] {name}: {ops['x'].shape[0]} points, {spec.num_levels} levels, D={spec.input_dim}; "
              f"byte bound {bound[0]:.5f} ms ({bound[2]} B), L2-sector bound {bound[1]:.5f} ms ({bound[3]} sectors "
              f"of hashed corner reads)", flush=True)
    torch.save(dict(sets=saved, l2_bytes_per_s=l2_rate, card=smi), path)
    print(f"[encode-inputs] {len(saved)} sets saved to {path}; L2 read rate {l2_rate / 1e12:.3f} TB/s over a "
          f"{L2_PROBE_BYTES} B buffer ({smi})", flush=True)


def tile_choices(thg, tiles: str):
    """[(name, encode override, grad override)] for ``--tiles``: the
    wrapper's own choice first; each override replaces the wrapper's tile
    function (``spec_encode_tile`` or ``input_grad_tile``)."""
    choices = [("own tiles", None, None)]
    if not tiles or not hasattr(thg, "_layout"):
        return choices
    for entry in tiles.split(","):
        kind, *nums = entry.split(":")
        P, W, R = (int(v) for v in nums + ["0"] * (3 - len(nums)))
        if kind == "encode":
            def enc(spec, stochastic, residuals, regs, P=P, W=W, R=R):
                lt = thg.level_table(spec, stochastic)
                res_levels = min(R, spec.num_levels) if residuals else spec.num_levels
                D = spec.input_dim
                cols = max(lt.k if lt.stoch[lvl] >= 0 else 1 << D for lvl in range(spec.num_levels))
                return thg._layout(P, D, spec.num_levels, spec.level_dim, lt.n_stoch * lt.k * D,
                                   res_levels * cols if residuals else 0, res_levels, False, W)
            choices.append((f"encode tiles {P} points, {W} warps, {R} levels a chunk", enc, None))
        else:
            def grad(L, D, C, regs, P=P, W=W):
                return thg._layout(P, D, L, C, 0, 0, L, True, W)
            choices.append((f"gradient tiles {P} points, {W} warps", None, grad))
    return choices


def time_inputs(path: str, root: str, label: str, tiles: str = "") -> int:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from focnerf_tpu_torch.ops import _build
    from focnerf_tpu_torch.ops import hashgrid as thg

    # this checkout's timer, for every checkout timed
    measure = load_module("measure", os.path.join(HERE, "focnerf_tpu_torch/utils/measure.py"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    _build.build_all(("hashgrid_fwd",))
    print(f"[{label}] {smi.splitlines()[0]}; encode kernels from {_build.CSRC_DIR}", flush=True)
    saved = torch.load(path)
    field_names = {f.name for f in dataclasses.fields(thg.HashGridSpec)}
    choices = tile_choices(thg, tiles)
    if len(choices) > 1:
        thg._own_spec_encode_tile, own_grad = thg.spec_encode_tile, thg.input_grad_tile
    failed = 0
    for item in saved["sets"]:
        for name, enc, grad in choices:
            is_grad = "cot" in item["ops"]
            if (enc is not None and is_grad) or (grad is not None and not is_grad):
                continue
            if enc is not None:
                thg.spec_encode_tile = enc
            if grad is not None:
                thg.input_grad_tile = grad
            try:
                failed += time_set(item, thg, measure, field_names, f"{label}, {name}")
            except (RuntimeError, ValueError) as e:  # a launch refused: say so, time the other sets
                print(f"[{label}, {name}] {item['name']}: FAILED: {e}", flush=True)
                failed += 1
            finally:
                if len(choices) > 1:
                    thg.spec_encode_tile, thg.input_grad_tile = thg._own_spec_encode_tile, own_grad
    return 1 if failed else 0


def time_set(item, thg, measure, field_names, label) -> int:
    """Checks and times one saved set; 1 if the kernel disagrees."""
    import torch

    spec = thg.HashGridSpec(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in item["spec"].items() if k in field_names})
    ops = {k: v.cuda() for k, v in item["ops"].items()}
    table, x, u, cot = ops["table"], ops["x"], ops.get("u"), ops.get("cot")
    if cot is None:
        residuals = item["residuals"]
        got = thg.hashgrid_encode_forward(table, x, spec, u, residuals=True)
        want = thg.encode_plain(table, x, spec, u, residuals=True)
        oob = ((x < 0) | (x > 1)).any(-1)
        ok = (torch.equal(got[1], want[1])
              and bool(((got[2] - want[2]).abs() <= 1e-7 + 1e-6 * want[2].abs()).all())
              and float((got[0] - want[0]).abs().max()) <= 1e-6 * float(table.abs().max())
              and bool((got[0][oob] == 0).all()))
        del got, want

        def fn():
            thg.hashgrid_encode_forward(table, x, spec, u, residuals=residuals)

        kernel, what = getattr(thg, "ENCODE_KERNEL", ENCODE_KERNEL), f"encode, residuals {'on' if residuals else 'off'}"
    else:
        got = thg.hashgrid_input_grad(table, x, cot, spec)
        again = thg.hashgrid_input_grad(table, x, cot, spec)
        want = thg.input_grad_plain(table, x, cot, spec)
        oob = ((x < 0) | (x > 1)).any(-1)
        ok = (float((got - want).norm() / want.norm()) <= 1e-5 and torch.equal(got, again)
              and bool((got[oob] == 0).all()))
        del got, again, want

        def fn():
            thg.hashgrid_input_grad(table, x, cot, spec)

        kernel, what = getattr(thg, "INPUT_GRAD_KERNEL", INPUT_GRAD_KERNEL), "position gradient"
    torch.cuda.synchronize()
    warm, warm_events = measure.kernel_ms(fn, kernel)
    cold, cold_events = measure.kernel_ms(fn, kernel, flush=True)
    byte_ms, sector_ms, _, _ = item["bound"]
    bound = max(byte_ms, sector_ms)
    print(f"[{label}] {item['name']} [{x.shape[0]} points, {spec.num_levels} levels, D={spec.input_dim}] {what}: "
          f"warm {warm:.5f} ms ({warm_events} of 100 launches traced), L2 flushed {cold:.5f} ms ({cold_events} of "
          f"100); bound {bound:.5f} ms (bytes {byte_ms:.5f}, L2 sectors {sector_ms:.5f}), warm {warm / bound:.2f}x "
          f"it; {'agrees with the plain version' if ok else 'DIFFERS FROM THE PLAIN VERSION'}", flush=True)
    del ops, table, x, u, cot
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--make_inputs", default="", help="make the operand sets and save them to this file")
    ap.add_argument("--inputs", default="", help="time the kernels on the sets saved in this file")
    ap.add_argument("--root", default=HERE, help="checkout whose focnerf_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name printed on every line")
    ap.add_argument("--tiles", default="", help="encode:P:W:R,grad:P:W,... tiles to time besides the own")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_encode_kernels: CUDA is not available", file=sys.stderr)
        return 2
    if args.make_inputs:
        make_inputs(args.make_inputs)
        return 0
    if not args.inputs:
        ap.error("give --make_inputs or --inputs")
    return time_inputs(args.inputs, args.root, args.label or os.path.abspath(args.root), args.tiles)


if __name__ == "__main__":
    sys.exit(main())
