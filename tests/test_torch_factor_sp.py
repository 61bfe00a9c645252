"""Collapse-sharded SP of the factorized voxel families (``parallel/vm_sp.py``,
``parallel/kplanes_sp.py``) on 4 gloo ranks on the CPU, held to JAX's on
meshes of the same sizes cut from conftest's 8 host devices (the scenes of
test_vm_sp.py and test_kplanes_sp.py, R = 16, ri = 32, block 2):

  - each rank's local slab of the collapse, per warp axis and rank (in this
    process, no ranks), against JAX's;
  - one SP step at W = 2 (the 2 x 2 mesh's "slice" rows) and W = 4, VM at SH
    0 and 2 and K-planes at SH 0: the mse, the summed factor gradient (Adam's
    first moment), the update, and every rank's factors bit for bit;
  - ``fit_vm_sp``, ``fit_kplanes_sp`` and ``fit_kplanes_sp_c2f`` (16 -> 32)
    at 2 ranks over mixed (axis, flip) variants, from JAX's initial fields;
  - ``main_voxel --voxel_sp --voxel_kplanes 2`` on the 4 ranks, and the
    refusal of a ``--bake_res`` that does not divide over them.

The ranks are 4 worker processes started once for the file (the ``Ranks``
launcher of test_torch_parallel.py), running this file with ``--worker``;
JAX runs in the pytest process meanwhile.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_parallel import Ranks  # noqa: E402

WORLD = 4
R = 16
VM_RANK, KP_RANK, KP_TIME = 4, 3, 5
STEP_CASES = [("vm", 0), ("vm", 2), ("kplanes", 0)]
FIT = dict(resolution=R, iters=8, lr=5e-2, block=2, group_chunk=1)
C2F = dict(resolution=2 * R, stages=2, iters=8, lr=5e-2, block=2, group_chunk=1, rank=KP_RANK, time_res=KP_TIME)
CLI_ITERS = 24


# --------------------------------------------------------------- the inputs
def _vm_setup():
    from test_voxel_sp import _setup

    key0, poses, gts, masks, intr, _ = _setup(R=R)
    return key0, np.asarray(poses, np.float32), np.asarray(gts), np.asarray(masks)


def _kp_setup():
    from test_kplanes_sp import _setup

    key0, poses, times, gts, masks, intr, _ = _setup(R=R)
    return key0, np.asarray(poses, np.float32), np.asarray(times), np.asarray(gts), np.asarray(masks)


def _jfield(family, sh=0, key=1, res=R):
    """JAX's initial field of ``family`` (a VMField or KPlanesField)."""
    from focnerf_tpu.train.voxel_kplanes import init_kplanes_field
    from focnerf_tpu.train.voxel_vm import init_vm_field

    if family == "vm":
        return init_vm_field(res, rank=VM_RANK, sh_degree=sh, rng=jax.random.key(key))
    return init_kplanes_field(res, rank=KP_RANK, time_res=KP_TIME, sh_degree=sh, rng=jax.random.key(key))


def _leaves(field):
    return [np.asarray(a, np.float32) for a in field]


def _vm_fit_scene():
    from test_torch_voxel_sp import _fit_scene

    return _fit_scene()


def _kp_fit_scene():
    """test_kplanes_sp's fit scene: 10 views of the moving sphere from
    unrestricted poses, times spread over [0, 1]."""
    from test_kplanes_sp import _moving_gt

    from focnerf_tpu.core.camera import rand_poses
    from focnerf_tpu.render.baked import render_baked

    H = 32
    intr = (1.2 * H, 1.2 * H, H / 2.0, H / 2.0)
    poses = np.asarray(rand_poses(np.random.default_rng(5), 10, radius=2.5), np.float32)
    times = np.linspace(0.0, 1.0, len(poses)).astype(np.float32)
    imgs = np.stack([np.asarray(render_baked(_moving_gt(t=float(t)), p, intr, H, H)[0])
                     for p, t in zip(poses, times)])
    return poses, imgs.astype(np.float32), times, np.asarray(intr, np.float32)


def _step_field(family, sh):
    return _jfield(family, sh, key=1 if family == "vm" else 0)


def _make_inputs(path):
    out = {}
    key, poses, gts, masks = _vm_setup()
    out.update({"vm/key": np.asarray([key[0], int(key[1])]), "vm/pose": poses[0], "vm/gt": gts[0],
                "vm/mask": masks[0]})
    key, poses, times, gts, masks = _kp_setup()
    out.update({"kplanes/key": np.asarray([key[0], int(key[1])]), "kplanes/pose": poses[0],
                "kplanes/t": times[0], "kplanes/gt": gts[0], "kplanes/mask": masks[0]})
    for family, sh in STEP_CASES:
        for i, a in enumerate(_leaves(_step_field(family, sh))):
            out[f"field/{family}{sh}.{i}"] = a
    fposes, fimgs, fintr = _vm_fit_scene()
    out.update({"vmfit/poses": fposes, "vmfit/imgs": fimgs, "vmfit/intr": fintr})
    kposes, kimgs, ktimes, kintr = _kp_fit_scene()
    out.update({"kpfit/poses": kposes, "kpfit/imgs": kimgs, "kpfit/times": ktimes, "kpfit/intr": kintr})
    for name, field in (("vmfit0", _jfield("vm", key=2)), ("kpfit0", _jfield("kplanes", key=3)),
                        ("kpc2f0", _jfield("kplanes", key=0))):
        for i, a in enumerate(_leaves(field)):
            out[f"field/{name}.{i}"] = a
    np.savez(path, **out)


def _port_field(inp, name, cls):
    n = sum(k.startswith(f"field/{name}.") for k in inp.files)
    return cls(*(torch.from_numpy(inp[f"field/{name}.{i}"]) for i in range(n)))


# ------------------------------------------------------- the ranks' cases
def _step_case(mesh, inp, family, sh):
    from focnerf_tpu_torch.parallel.kplanes_sp import make_kplanes_sp_step
    from focnerf_tpu_torch.parallel.vm_sp import make_vm_sp_step
    from focnerf_tpu_torch.train.voxel_kplanes import KPlanesField
    from focnerf_tpu_torch.train.voxel_vm import VMField

    axis, flip = (int(a) for a in inp[f"{family}/key"])
    kw = dict(resolution=R, warp_axis=axis, flip=bool(flip), sh_degree=sh, block=2)
    pose, gt, mask = (torch.from_numpy(inp[f"{family}/{k}"]) for k in ("pose", "gt", "mask"))
    if family == "vm":
        init, step = make_vm_sp_step(mesh, **kw)
        state = init(_port_field(inp, f"vm{sh}", VMField))
        mse = step(state, pose, gt, mask)
    else:
        init, step = make_kplanes_sp_step(mesh, **kw)
        state = init(_port_field(inp, f"kplanes{sh}", KPlanesField))
        mse = step(state, pose, float(inp["kplanes/t"]), gt, mask)
    out = {"mse": mse.numpy()}
    for i, p in enumerate(state.leaves):
        out[f"p.{i}"] = p.detach().numpy()
        out[f"g.{i}"] = state.optimizer.state[p]["exp_avg"].numpy() / 0.1  # first moment from 0
    return out


def _case_steps(mesh1d, mesh2d, inp, work):
    out = {}
    for family, sh in STEP_CASES:
        for name, mesh in (("w2", mesh2d["slice"]), ("w4", mesh1d)):
            for k, v in _step_case(mesh, inp, family, sh).items():
                out[f"{family}{sh}_{name}/{k}"] = v
    return out


def _case_fit_vm(mesh1d, mesh2d, inp, work):
    from focnerf_tpu_torch.parallel.vm_sp import fit_vm_sp
    from focnerf_tpu_torch.train.voxel_vm import VMField

    _, info = fit_vm_sp(inp["vmfit/poses"], torch.from_numpy(inp["vmfit/imgs"]), tuple(inp["vmfit/intr"]),
                        mesh=mesh2d["slice"], init_field=_port_field(inp, "vmfit0", VMField), **FIT)
    return {**{f"p.{i}": p.numpy() for i, p in enumerate(info["field"])}, "psnr": np.asarray(info["psnr"]),
            "n_devices": np.asarray(info["n_devices"])}


def _case_fit_kplanes(mesh1d, mesh2d, inp, work):
    from focnerf_tpu_torch.parallel.kplanes_sp import fit_kplanes_sp
    from focnerf_tpu_torch.train.voxel_kplanes import KPlanesField

    field, info = fit_kplanes_sp(inp["kpfit/poses"], torch.from_numpy(inp["kpfit/imgs"]), inp["kpfit/times"],
                                 tuple(inp["kpfit/intr"]), mesh=mesh2d["slice"],
                                 init_field=_port_field(inp, "kpfit0", KPlanesField), **FIT)
    return {**{f"p.{i}": p.numpy() for i, p in enumerate(field)}, "psnr": np.asarray(info["psnr"]),
            "step_mse": info["step_mse"]}


def _case_fit_kplanes_c2f(mesh1d, mesh2d, inp, work):
    from focnerf_tpu_torch.parallel.kplanes_sp import fit_kplanes_sp_c2f
    from focnerf_tpu_torch.train import voxel_kplanes as tkp

    real = tkp.init_kplanes_field
    tkp.init_kplanes_field = lambda *a, **k: _port_field(inp, "kpc2f0", tkp.KPlanesField)  # JAX's stage-0 field
    try:
        field, info = fit_kplanes_sp_c2f(inp["kpfit/poses"], torch.from_numpy(inp["kpfit/imgs"]),
                                         inp["kpfit/times"], tuple(inp["kpfit/intr"]), mesh=mesh2d["slice"],
                                         device="cpu", **C2F)
    finally:
        tkp.init_kplanes_field = real
    return {**{f"p.{i}": p.numpy() for i, p in enumerate(field)},
            "stage_psnrs": np.asarray(info["stage_psnrs"])}


def _case_main(mesh1d, mesh2d, inp, work):
    from focnerf_tpu_torch.apps import main_voxel

    argv = [os.path.join(work, "scene"), "--scale", "1.0", "--bound", "1.0", "--voxel_sp", "--voxel_kplanes", "2",
            "--voxel_time_slots", "4"]
    field, info = main_voxel.main(argv + ["--workspace", os.path.join(work, "kp_ws"), "--bake_res", "16",
                                          "--iters", str(CLI_ITERS)], device="cpu")
    try:
        main_voxel.main(argv + ["--workspace", os.path.join(work, "kp_bad"), "--bake_res", "18"], device="cpu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {**{f"p.{i}": p.numpy() for i, p in enumerate(field)}, "step_mse": info["step_mse"],
            "n_devices": np.asarray(info["n_devices"]), "refused": np.asarray(refused)}


CASES = {"steps": _case_steps, "fit_vm": _case_fit_vm, "fit_kplanes": _case_fit_kplanes,
         "fit_kplanes_c2f": _case_fit_kplanes_c2f, "main": _case_main}


def _worker(rank: int, world: int, work: str):
    from focnerf_tpu_torch.parallel.distributed import initialize, shutdown
    from focnerf_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    initialize(rank, world, init_method=f"file://{work}/store", timeout_s=300, device="cpu")
    mesh1d = make_mesh(axis_names=("slice",), device="cpu")
    mesh2d = make_mesh((2, 2), ("data", "slice"), device="cpu")
    inp = np.load(os.path.join(work, "inputs.npz"))
    for name, case in CASES.items():
        np.savez(os.path.join(work, f"{name}.{rank}.npz"), **case(mesh1d, mesh2d, inp, work))
    shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from focnerf_tpu_torch.data import procedural

    work = str(tmp_path_factory.mktemp("factor_sp_ranks"))
    _make_inputs(os.path.join(work, "inputs.npz"))
    procedural.make_hard_dynamic_scene(os.path.join(work, "scene"), n_times=3, views_per_time=2, n_val_times=2,
                                       H=24, W=24, gt_res=32, device="cpu")
    r = Ranks(work, WORLD, script=os.path.abspath(__file__))
    yield r
    r.wait()


def _jmesh(n):
    from focnerf_tpu.parallel.mesh import make_mesh

    return make_mesh(n)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _total_step(leaves, leaves0):
    return np.concatenate([(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
                           for a, b in zip(leaves, leaves0)])


# --------------------------------------------------------------- the tests
@pytest.mark.parametrize("warp_axis", [0, 1, 2])
@pytest.mark.parametrize("family", ["vm", "kplanes"])
def test_local_slab_matches_jax(family, warp_axis):
    """Every rank's slab of the collapse (4 ranks) against JAX's: VM within
    1e-5, K-planes within rtol 1e-5 / atol 1e-6 (JAX's own tiling
    tolerances); the port's slabs tile the port's full collapse."""
    from focnerf_tpu.parallel import kplanes_sp as jkpsp
    from focnerf_tpu.parallel import vm_sp as jvmsp
    from focnerf_tpu_torch import interop
    from focnerf_tpu_torch.parallel.kplanes_sp import _collapse_local_slab
    from focnerf_tpu_torch.parallel.vm_sp import _collapse_vm_local_slab
    from focnerf_tpu_torch.train.voxel_kplanes import collapse_kplanes
    from focnerf_tpu_torch.train.voxel_vm import collapse_vm

    D, t = 4, 0.37
    R_loc = R // D
    if family == "vm":
        jf = _jfield("vm", key=2)
        tf = interop.vm_field_from_jax(jf)
        want = [jvmsp._collapse_vm_local_slab(jf, warp_axis, jnp.int32(d), R_loc) for d in range(D)]
        got = [_collapse_vm_local_slab(tf, warp_axis, d, R_loc) for d in range(D)]
        full, tol = collapse_vm(tf), dict(rtol=0, atol=1e-5)
    else:
        jf = _jfield("kplanes", key=1)
        tf = interop.kplanes_field_from_jax(jf)
        want = [jkpsp._collapse_local_slab(jf, t, warp_axis, d, R_loc) for d in range(D)]
        got = [_collapse_local_slab(tf, t, warp_axis, d, R_loc) for d in range(D)]
        full, tol = collapse_kplanes(tf, t), dict(rtol=1e-5, atol=1e-6)
    for d in range(D):
        assert got[d].shape[warp_axis] == R_loc
        np.testing.assert_allclose(got[d].numpy(), np.asarray(want[d]), **tol)
    np.testing.assert_allclose(torch.cat(got, warp_axis).numpy(), full.numpy(), **tol)


@pytest.mark.parametrize("family,sh", STEP_CASES)
@pytest.mark.parametrize("world", [2, 4])
def test_sp_step_matches_jax(ranks, world, family, sh):
    """One collapse-sharded step against JAX's make_*_sp_step on a mesh of
    the same size. The mse within 2e-5 relative; each factor's gradient
    (Adam's first moment: the ranks' shares summed, the regularizer once)
    within 1e-5 of its largest entry; the factors within 2e-5 (VM) / 3e-5
    (K-planes) wherever the gradient clears 1e-4 of its largest entry (JAX's
    SP-against-unsharded bars; below that Adam's first step turns rounding
    into step size); every rank's factors bit for bit equal."""
    from focnerf_tpu.parallel.kplanes_sp import make_kplanes_sp_step
    from focnerf_tpu.parallel.vm_sp import make_vm_sp_step

    field0 = _step_field(family, sh)
    if family == "vm":
        key, poses, gts, masks = _vm_setup()
        opt, step = make_vm_sp_step(_jmesh(world), resolution=R, warp_axis=key[0], flip=key[1], sh_degree=sh,
                                    block=2)
        new, st, mse = step(field0, opt.init(field0), jnp.asarray(poses[0]), jnp.asarray(gts[0]),
                            jnp.asarray(masks[0]))
        p_tol = 2e-5
    else:
        key, poses, times, gts, masks = _kp_setup()
        opt, step = make_kplanes_sp_step(_jmesh(world), resolution=R, warp_axis=key[0], flip=key[1], sh_degree=sh,
                                         block=2)
        new, st, mse = step(field0, opt.init(field0), jnp.asarray(poses[0]), jnp.float32(times[0]),
                            jnp.asarray(gts[0]), jnp.asarray(masks[0]))
        p_tol = 3e-5
    grads = [np.asarray(m) / 0.1 for m in st[0].mu]
    got = ranks.result("steps")
    pre = f"{family}{sh}_w{world}/"
    for r in got:
        np.testing.assert_allclose(float(r[pre + "mse"]), float(mse), rtol=2e-5)
    for i, (g, p, p0) in enumerate(zip(grads, _leaves(new), _leaves(field0))):
        live = np.abs(g) > 1e-4 * np.abs(g).max()
        assert live.mean() > 0.5, i
        assert np.abs(p - p0).max() > 1e-3, i
        np.testing.assert_allclose(got[0][pre + f"g.{i}"], g, rtol=0, atol=1e-5 * np.abs(g).max(), err_msg=str(i))
        np.testing.assert_allclose(got[0][pre + f"p.{i}"][live], p[live], rtol=0, atol=p_tol, err_msg=str(i))
        for r in got[1:]:
            assert np.array_equal(r[pre + f"p.{i}"], got[0][pre + f"p.{i}"]), i


def test_fit_vm_sp_matches_jax(ranks):
    """fit_vm_sp at 2 ranks, 8 steps round-robin over the scene's variant
    groups, from JAX's initial factors, against JAX's on a 2-device mesh:
    the factors' total step within 1e-3 relative L2, the last step's PSNR
    within 1e-3 dB."""
    from focnerf_tpu.parallel.vm_sp import fit_vm_sp
    from focnerf_tpu.train.voxel import _pose_variant

    poses, imgs, intr = _vm_fit_scene()
    assert len({_pose_variant(p, 1.0)[0] for p in poses}) > 1  # more than one warp axis
    field0 = _jfield("vm", key=2)
    _, info = fit_vm_sp(poses, imgs, tuple(intr), mesh=_jmesh(2), init_field=field0, **FIT)
    want = _total_step(_leaves(info["field"]), _leaves(field0))
    for r in ranks.result("fit_vm"):
        assert int(r["n_devices"]) == 2
        got = _total_step([r[f"p.{i}"] for i in range(3)], _leaves(field0))
        assert _rel_l2(got, want) <= 1e-3
        assert abs(float(r["psnr"]) - info["psnr"]) <= 1e-3


def test_fit_kplanes_sp_matches_jax(ranks):
    """fit_kplanes_sp at 2 ranks, 8 steps over the moving-sphere scene's
    variants (each at its view's time), from JAX's initial planes, against
    JAX's on a 2-device mesh: the total step within 1e-3 relative L2, the
    PSNR within 1e-3 dB, the step mse finite."""
    from focnerf_tpu.parallel.kplanes_sp import fit_kplanes_sp

    from focnerf_tpu.train.voxel import _pose_variant

    poses, imgs, times, intr = _kp_fit_scene()
    assert len({_pose_variant(p, 1.0)[0] for p in poses}) > 1  # more than one warp axis
    field0 = _jfield("kplanes", key=3)
    field, info = fit_kplanes_sp(poses, imgs, times, tuple(intr), mesh=_jmesh(2), init_field=field0, **FIT)
    want = _total_step(_leaves(field), _leaves(field0))
    for r in ranks.result("fit_kplanes"):
        got = _total_step([r[f"p.{i}"] for i in range(4)], _leaves(field0))
        assert _rel_l2(got, want) <= 1e-3
        assert abs(float(r["psnr"]) - info["psnr"]) <= 1e-3
        assert r["step_mse"].shape == (FIT["iters"],) and np.isfinite(r["step_mse"]).all()


def test_fit_kplanes_sp_c2f_matches_jax(ranks):
    """fit_kplanes_sp_c2f at 2 ranks on the ladder 16 -> 32 (4 steps a
    stage), from JAX's stage-0 planes, against JAX's on a 2-device mesh: the
    stage PSNRs within 1e-3 dB and the final planes within 1e-3 relative L2
    of how far JAX's moved from the upsampled stage-0 planes; a ladder
    resolution that does not divide the mesh is refused."""
    from focnerf_tpu.parallel.kplanes_sp import fit_kplanes_sp_c2f
    from focnerf_tpu.train.voxel_kplanes import upsample_kplanes

    poses, imgs, times, intr = _kp_fit_scene()
    field, info = fit_kplanes_sp_c2f(poses, imgs, times, tuple(intr), mesh=_jmesh(2), **C2F)
    want = _leaves(field)
    base = _leaves(upsample_kplanes(_jfield("kplanes", key=0), 2 * R))
    for r in ranks.result("fit_kplanes_c2f"):
        got = [r[f"p.{i}"] for i in range(4)]
        assert got[0].shape == (3, 2 * R, 2 * R, KP_RANK, 4)
        assert np.linalg.norm(_total_step(got, want)) <= 1e-3 * np.linalg.norm(_total_step(want, base))
        np.testing.assert_allclose(r["stage_psnrs"], info["stage_psnrs"], atol=1e-3)


def test_main_voxel_kplanes_sp_on_four_ranks(ranks):
    """main_voxel --voxel_sp --voxel_kplanes 2 on 4 ranks: every rank returns
    the same field, rank 0 alone writes (JAX's load_kplanes_field reads the
    npz) and prints ``[kplanes] SP over 4 devices``; a --bake_res that does
    not divide over the 4 ranks is refused on every rank before any data
    loads."""
    from focnerf_tpu.train.voxel_kplanes import load_kplanes_field

    got = ranks.result("main")
    for r in got[1:]:
        for i in range(4):
            assert np.array_equal(r[f"p.{i}"], got[0][f"p.{i}"])
    assert int(got[0]["n_devices"]) == 4
    assert got[0]["step_mse"].shape == (CLI_ITERS,) and np.isfinite(got[0]["step_mse"]).all()
    ws = os.path.join(ranks.work, "kp_ws")
    jf, bound, sh = load_kplanes_field(os.path.join(ws, "kplanes_16_sh0.npz"))
    assert jf.space.shape == (3, 16, 16, 2, 4) and jf.time.shape == (3, 16, 4, 2, 4) and (bound, sh) == (1.0, 0)
    np.testing.assert_allclose(np.asarray(jf.space), got[0]["p.0"], rtol=1e-3, atol=1e-3)  # fp16 file
    for name in ("mesh_t0.00.obj", "mesh_t1.00.obj", "log.txt"):
        assert os.path.exists(os.path.join(ws, name)), name
    with open(os.path.join(ws, "log.txt")) as f:
        assert len(f.read().splitlines()) == 1  # one writer
    logs = ranks.wait()
    assert logs[0][1].count("[kplanes] SP over 4 devices") == 1
    assert all("[kplanes]" not in out for _, out in logs[1:])
    for r in got:
        assert "--bake_res 18 must divide evenly over the 4 ranks" in str(r["refused"])
    assert not os.path.exists(os.path.join(ranks.work, "kp_bad"))


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
