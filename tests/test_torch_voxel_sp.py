"""Slice-parallel dense voxel training (``parallel/voxel_sp.py``) on 4 gloo
ranks on the CPU, held to JAX's ``parallel/voxel_sp.py`` on meshes of the
same sizes cut from conftest's 8 host devices (test_voxel_sp.py's scene,
R = 16, ri = 32, block 2):

  - one SP step at W = 2 (the 2 x 2 mesh's "slice" rows) and at W = 4, SH
    degrees 0 and 2: the loss within 2e-5 relative, the field within 2e-5
    (JAX's own SP-against-unsharded tolerances);
  - one DP x SP step on the 2 x 2 ("data", "slice") mesh, field within 3e-5;
  - ``fit_voxels_sp`` at 2 ranks over mixed (axis, flip) variants (the field
    and its Adam moments re-cut when the warp axis changes), its c2f ladder
    16 -> 32, and ``fit_voxels_dp_sp`` on the 2 x 2 mesh, each from JAX's
    initial field;
  - ``main_voxel --voxel_sp --voxel_dp 2`` on the 2 x 2 mesh.

The ranks are 4 worker processes started once for the file (the
``Ranks`` launcher of test_torch_parallel.py), running this file with
``--worker``; JAX runs in the pytest process meanwhile.
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
FIT = dict(resolution=R, iters=8, lr=0.1, tv_weight=1e-5, block=2, group_chunk=1)
C2F = dict(resolution=2 * R, stages=2, iters=8, lr=0.1, tv_weight=1e-5, block=2, group_chunk=1)
N_FIT_VIEWS = 12


def _setup():
    from test_voxel_sp import _setup as jsetup

    key0, poses, gts, masks, intr, H = jsetup(R=R)
    return key0, np.asarray(poses, np.float32), np.asarray(gts), np.asarray(masks), intr


def _raw0(sh):
    from focnerf_tpu.train.voxel import init_voxel_field

    raw = init_voxel_field(R, sh_degree=sh, rng=jax.random.key(0))
    if sh:  # non-trivial SH coefficients, as test_voxel_sp's SH case
        raw = raw + 0.05 * jax.random.normal(jax.random.key(1), raw.shape)
    return np.asarray(raw, np.float32)


def _fit_scene():
    """test_voxel_sp's mixed-variant scene: 12 views from unrestricted poses."""
    from test_voxel_sp import _gt_volume

    from focnerf_tpu.core.camera import rand_poses
    from focnerf_tpu.render.baked import render_baked

    H = 32
    intr = (1.2 * H, 1.2 * H, H / 2.0, H / 2.0)
    poses = np.asarray(rand_poses(np.random.default_rng(0), N_FIT_VIEWS, radius=2.5), np.float32)
    imgs = np.stack([np.asarray(render_baked(_gt_volume(), p, intr, H, H)[0]) for p in poses])
    return poses, imgs.astype(np.float32), np.asarray(intr, np.float32)


def _make_inputs(path):
    key0, poses, gts, masks, intr = _setup()
    fposes, fimgs, fintr = _fit_scene()
    np.savez(path, key=np.asarray([key0[0], int(key0[1])]), poses=poses, gts=gts, masks=masks,
             intr=np.asarray(intr, np.float32), raw0=_raw0(0), raw2=_raw0(2), fit_poses=fposes, fit_imgs=fimgs,
             fit_intr=fintr)


# ------------------------------------------------------- the ranks' cases
def _sp_step_case(mesh, inp, sh):
    from focnerf_tpu_torch.parallel.voxel_sp import _gather_field, make_voxel_sp_step

    axis, flip = int(inp["key"][0]), bool(inp["key"][1])
    init, step, shard = make_voxel_sp_step(mesh, tuple(inp["intr"]), resolution=R, warp_axis=axis, flip=flip,
                                           sh_degree=sh, tv_weight=1e-4, block=2)
    state = init(shard(torch.from_numpy(inp[f"raw{sh}"])))
    mse = step(state, torch.from_numpy(inp["poses"][0]), torch.from_numpy(inp["gts"][0]),
               torch.from_numpy(inp["masks"][0]))
    p = state.leaves[0]
    return {"mse": mse.numpy(), "raw": _gather_field(p, axis, mesh.get_group()).numpy(),
            "grad": _gather_field(state.optimizer.state[p]["exp_avg"] / 0.1, axis, mesh.get_group()).numpy()}


def _case_sp(mesh1d, mesh2d, inp):
    out = {}
    for sh in (0, 2):
        for name, mesh in (("w2", mesh2d["slice"]), ("w4", mesh1d)):
            for k, v in _sp_step_case(mesh, inp, sh).items():
                out[f"{name}_sh{sh}/{k}"] = v
    return out


def _case_dp_sp(mesh1d, mesh2d, inp):
    from focnerf_tpu_torch.parallel.voxel_sp import _gather_field, make_voxel_dp_sp_step

    axis, flip = int(inp["key"][0]), bool(inp["key"][1])
    init, step, shard = make_voxel_dp_sp_step(mesh2d, resolution=R, warp_axis=axis, flip=flip, tv_weight=1e-4,
                                              block=2)
    state = init(shard(torch.from_numpy(inp["raw0"])))
    mse = step(state, inp["poses"][:2], torch.from_numpy(inp["gts"][:2]), torch.from_numpy(inp["masks"][:2]))
    return {"mse": mse.numpy(), "raw": _gather_field(state.leaves[0], axis, mesh2d.get_group("slice")).numpy()}


def _case_fit(mesh1d, mesh2d, inp):
    from focnerf_tpu_torch.parallel.voxel_sp import fit_voxels_sp

    _, info = fit_voxels_sp(inp["fit_poses"], torch.from_numpy(inp["fit_imgs"]), tuple(inp["fit_intr"]),
                            mesh=mesh2d["slice"], init_raw=torch.from_numpy(inp["raw0"]), **FIT)
    return {"raw": info["raw"].numpy(), "psnr": np.asarray(info["psnr"]), "n_devices": np.asarray(info["n_devices"])}


def _case_fit_c2f(mesh1d, mesh2d, inp):
    from focnerf_tpu_torch.parallel.voxel_sp import fit_voxels_sp_c2f
    from focnerf_tpu_torch.train import voxel as tvox

    tvox.init_voxel_field = lambda *a, **k: torch.from_numpy(inp["raw0"])  # JAX's stage-0 field (seed 0)
    _, info = fit_voxels_sp_c2f(inp["fit_poses"], torch.from_numpy(inp["fit_imgs"]), tuple(inp["fit_intr"]),
                                mesh=mesh2d["slice"], device="cpu", **C2F)
    return {"raw": info["raw"].numpy(), "stage_psnrs": np.asarray(info["stage_psnrs"])}


def _case_fit_dp_sp(mesh1d, mesh2d, inp):
    from focnerf_tpu_torch.parallel.voxel_sp import fit_voxels_dp_sp

    _, info = fit_voxels_dp_sp(inp["fit_poses"], torch.from_numpy(inp["fit_imgs"]), tuple(inp["fit_intr"]),
                               mesh=mesh2d, init_raw=torch.from_numpy(inp["raw0"]), **FIT)
    return {"raw": info["raw"].numpy(), "psnr": np.asarray(info["psnr"])}


def _case_main_dp_sp(mesh1d, mesh2d, inp, work):
    from focnerf_tpu_torch.apps import main_voxel

    vol, info = main_voxel.main([os.path.join(work, "scene"), "--workspace", os.path.join(work, "dpsp_ws"),
                                 "--iters", "4", "--bake_res", "16", "--scale", "1.0", "--bound", "1.0",
                                 "--voxel_sp", "--voxel_dp", "2"], device="cpu")
    return {"rgba": vol.rgba.numpy(), "mesh": np.asarray([info["mesh"]["data"], info["mesh"]["slice"]]),
            "step_mse": info["step_mse"]}


CASES = {"sp": _case_sp, "dp_sp": _case_dp_sp, "fit": _case_fit, "fit_c2f": _case_fit_c2f,
         "fit_dp_sp": _case_fit_dp_sp, "main_dp_sp": _case_main_dp_sp}


def _worker(rank: int, world: int, work: str):
    from focnerf_tpu_torch.parallel.distributed import initialize, shutdown
    from focnerf_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    initialize(rank, world, init_method=f"file://{work}/store", timeout_s=300, device="cpu")
    mesh1d = make_mesh(axis_names=("slice",), device="cpu")
    mesh2d = make_mesh((2, 2), ("data", "slice"), device="cpu")
    inp = np.load(os.path.join(work, "inputs.npz"))
    for name, case in CASES.items():
        args = (mesh1d, mesh2d, inp) + ((work,) if name == "main_dp_sp" else ())
        np.savez(os.path.join(work, f"{name}.{rank}.npz"), **case(*args))
    shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from helpers import make_synthetic_scene

    work = str(tmp_path_factory.mktemp("voxel_sp_ranks"))
    _make_inputs(os.path.join(work, "inputs.npz"))
    make_synthetic_scene(os.path.join(work, "scene"), n_train=4, n_val=1, H=16, W=16)
    r = Ranks(work, WORLD, script=os.path.abspath(__file__))
    yield r
    r.wait()


def _jmesh(n):
    from focnerf_tpu.parallel.mesh import make_mesh

    return make_mesh(n)


@pytest.mark.parametrize("sh", [0, 2])
@pytest.mark.parametrize("world", [2, 4])
def test_sp_step_matches_jax(ranks, world, sh):
    """One slice-parallel step against JAX's make_voxel_sp_step on a mesh of
    the same size: the partial combine, the strip loss through the gather's
    backward and the halo'd TV reproduce JAX's sharded step. The loss within
    2e-5 relative; the gradient (Adam's first moment) within 1e-5 of its
    largest entry (test_torch_train's fp32 gradient tolerance); the field
    within 2e-5 wherever the gradient clears 1e-4 of the largest. Below
    that, Adam's first step (eps 1e-8) turns rounding into step size: at
    SH 2 one entry's gradient is -8.1e-10 (1.3e-5 of the largest), and
    there JAX's jitted step moves 2.16e-5 from JAX's own eager step, while
    the port is 1.85e-6 from the eager one."""
    from focnerf_tpu.parallel.voxel_sp import make_voxel_sp_step

    key0, poses, gts, masks, intr = _setup()
    raw0 = jnp.asarray(_raw0(sh))
    opt, step, shard_fn = make_voxel_sp_step(_jmesh(world), intr, resolution=R, warp_axis=key0[0], flip=key0[1],
                                             sh_degree=sh, tv_weight=1e-4, block=2)
    raw_sp = shard_fn(raw0)
    raw_sp, st, mse = step(raw_sp, shard_fn(opt.init(raw_sp)), jnp.asarray(poses[0]), jnp.asarray(gts[0]),
                           jnp.asarray(masks[0]))
    g = np.asarray(st[0].mu) / 0.1
    live = np.abs(g) > 1e-4 * np.abs(g).max()
    assert live.mean() > 0.5
    got = ranks.result("sp")
    for r in got:
        np.testing.assert_allclose(float(r[f"w{world}_sh{sh}/mse"]), float(mse), rtol=2e-5)
        np.testing.assert_allclose(r[f"w{world}_sh{sh}/grad"], g, rtol=0, atol=1e-5 * np.abs(g).max())
        np.testing.assert_allclose(r[f"w{world}_sh{sh}/raw"][live], np.asarray(raw_sp)[live], atol=2e-5)
    assert np.abs(np.asarray(raw_sp) - np.asarray(raw0)).max() > 1e-3


def test_dp_sp_step_matches_jax(ranks):
    """One hybrid step on the 2 x 2 (data, slice) mesh against JAX's
    make_voxel_dp_sp_step on its 2 x 2 mesh: two views, one a data row."""
    from jax.sharding import Mesh

    from focnerf_tpu.parallel.voxel_sp import make_voxel_dp_sp_step

    key0, poses, gts, masks, _ = _setup()
    raw0 = jnp.asarray(_raw0(0))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "slice"))
    opt, step, shard_fn = make_voxel_dp_sp_step(mesh, resolution=R, warp_axis=key0[0], flip=key0[1],
                                                tv_weight=1e-4, block=2)
    raw_h = shard_fn(raw0)
    raw_h, _, mse = step(raw_h, shard_fn(opt.init(raw_h)), jnp.asarray(poses[:2]), jnp.asarray(gts[:2]),
                         jnp.asarray(masks[:2]))
    for r in ranks.result("dp_sp"):
        np.testing.assert_allclose(float(r["mse"]), float(mse), rtol=2e-5)
        np.testing.assert_allclose(r["raw"], np.asarray(raw_h), atol=3e-5)


def test_fit_voxels_sp_matches_jax(ranks):
    """fit_voxels_sp at 2 ranks, 8 steps round-robin over the scene's
    variant groups (the warp axis changes, so the field and its Adam
    moments are re-cut), from JAX's initial field, against JAX's on a
    2-device mesh: the field's total step within 1e-3 relative L2 and the
    last step's PSNR within 1e-3 dB."""
    from focnerf_tpu.parallel.voxel_sp import fit_voxels_sp
    from focnerf_tpu.train.voxel import _pose_variant

    poses, imgs, intr = _fit_scene()
    keys = [_pose_variant(p, 1.0) for p in poses]
    assert len({k[0] for k in keys}) > 1  # more than one warp axis
    raw0 = _raw0(0)
    _, info = fit_voxels_sp(poses, imgs, tuple(intr), mesh=_jmesh(2), init_raw=jnp.asarray(raw0), **FIT)
    want = np.asarray(info["raw"]) - raw0
    for r in ranks.result("fit"):
        assert int(r["n_devices"]) == 2
        got = r["raw"] - raw0
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
        assert abs(float(r["psnr"]) - info["psnr"]) <= 1e-3


def test_fit_voxels_sp_c2f_matches_jax(ranks):
    """fit_voxels_sp_c2f at 2 ranks on the ladder 16 -> 32 (4 steps a stage,
    round-robin over the variants), from JAX's stage-0 field, against JAX's
    on a 2-device mesh: the stage PSNRs within 1e-3 dB, and the final field
    within 1e-3 relative L2 of how far JAX's moved from the upsampled init."""
    from focnerf_tpu.parallel.voxel_sp import fit_voxels_sp_c2f
    from focnerf_tpu.train.voxel import upsample_field

    poses, imgs, intr = _fit_scene()
    _, info = fit_voxels_sp_c2f(poses, imgs, tuple(intr), mesh=_jmesh(2), **C2F)
    want = np.asarray(info["raw"])
    base = np.asarray(upsample_field(jnp.asarray(_raw0(0)), 2 * R))
    for r in ranks.result("fit_c2f"):
        assert r["raw"].shape == (2 * R,) * 3 + (4,)
        assert np.linalg.norm(r["raw"] - want) <= 1e-3 * np.linalg.norm(want - base)
        np.testing.assert_allclose(r["stage_psnrs"], info["stage_psnrs"], atol=1e-3)


def test_fit_voxels_dp_sp_matches_jax(ranks):
    """fit_voxels_dp_sp on the 2 x 2 mesh, 8 view updates (2 a step) over the
    mixed variants, from JAX's initial field, against JAX's on its 2 x 2
    mesh (the same view draws): the field's step within 1e-3 relative L2."""
    from jax.sharding import Mesh

    from focnerf_tpu.parallel.voxel_sp import fit_voxels_dp_sp

    poses, imgs, intr = _fit_scene()
    raw0 = _raw0(0)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "slice"))
    _, info = fit_voxels_dp_sp(poses, imgs, tuple(intr), mesh=mesh, init_raw=jnp.asarray(raw0), **FIT)
    want = np.asarray(info["raw"]) - raw0
    for r in ranks.result("fit_dp_sp"):
        assert np.linalg.norm(r["raw"] - raw0 - want) <= 1e-3 * np.linalg.norm(want)
        assert abs(float(r["psnr"]) - info["psnr"]) <= 1e-3


def test_main_voxel_dp_sp_on_a_2x2_mesh(ranks):
    """main_voxel --voxel_sp --voxel_dp 2 on 4 ranks: a 2 x 2 (data x slice)
    mesh, the same volume on every rank, rank 0 alone writes and prints
    ``[dpspvoxel]``; iters count view updates (2 views a step)."""
    got = ranks.result("main_dp_sp")
    assert list(got[0]["mesh"]) == [2, 2]
    for r in got[1:]:
        assert np.array_equal(r["rgba"], got[0]["rgba"])
    assert len(got[0]["step_mse"]) >= 2 and np.isfinite(got[0]["step_mse"]).all()
    assert os.path.exists(os.path.join(ranks.work, "dpsp_ws", "baked_16_sh0.npz"))
    logs = ranks.wait()
    assert "[dpspvoxel] trained on a 2x2 (data x slice) mesh" in logs[0][1]
    assert all("[dpspvoxel]" not in out for _, out in logs[1:])


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
