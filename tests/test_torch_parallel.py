"""The port's multi-device paths at world size 2 on the CPU (gloo), held to the
JAX package's on a 2-device mesh cut from conftest's 8 host devices:

  - the data-parallel hash-grid steps (``parallel/sharding.py``), uniform
    with a ray mask and a mask penalty large enough that a per-rank norm
    would move the loss, and occupancy: the loss, the averaged gradient
    and the update; the ranks' params bit for bit after 3 steps;
  - ``compose_rays_sharded`` with K = 4 objects over the 2 ranks;
  - the four voxel families' pose-parallel steps (``make_*_dp_step``);
  - ``main_voxel --voxel_sp`` on 2 ranks (rank 0 alone writes),
    ``--voxel_dp`` without ``--voxel_sp`` (ignored, as JAX ignores it) and
    with ``--voxel_sp --voxel_kplanes`` (refused, as JAX refuses it);
  - a rank whose peer never arrives raises within its timeout.

The ranks are two worker processes, started once for the file by a
module-scoped fixture (``file://`` rendezvous in the fixture's directory,
so parallel test workers never race for a port). They run this file as a
script (``--worker``), read the inputs the fixture wrote, run every case,
and write one npz per case and rank; JAX runs in the pytest process
meanwhile. Shapes are small: 4 levels, a 2^11 table, 16-wide nets, R = 16.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.models import nerf as tnerf  # noqa: E402
from focnerf_tpu_torch.train.state import TrainState, param_leaves  # noqa: E402

WORLD = 2
HASH = dict(num_levels=4, log2_hashmap_size=11, hidden_dim=16, hidden_dim_color=16, bound=1.0,
            stochastic_corners=1, stochastic_min_size=1)
N_RAYS, SLAB, T = 64, 32, 32
LR, ITERS = 1e-2, 100
MASK_PENALTY = 2e-3  # the norm term is ~1/3 of the loss (test_dp_uniform_with_mask)
R_VOX = 16
TINY = dict(num_levels=2, base_resolution=4, log2_hashmap_size=8, use_objfeat=False)
K_OBJ = 4


# --------------------------------------------------------------- the inputs
def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, (list, tuple)):
            for i, a in enumerate(v):
                out[f"{prefix}{k}.{i}"] = np.asarray(a)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


def _unflat(prefix, arrays):
    tree = {}
    for name in arrays.files if hasattr(arrays, "files") else arrays:
        if not name.startswith(prefix):
            continue
        key = name[len(prefix):]
        if "." in key:
            k, i = key.split(".")
            tree.setdefault(k, {})[int(i)] = arrays[name]
        else:
            tree[key] = arrays[name]
    return {k: [v[i] for i in sorted(v)] if isinstance(v, dict) else v for k, v in tree.items()}


def _hash_draws(key, cfg_spec_stoch, uniform: bool):
    """The draws JAX's (sharded) step makes from ``key``, global batch."""
    k_bg, k_perturb = jax.random.split(key)
    d = {"bg": np.asarray(jax.random.uniform(k_bg, (N_RAYS, 3)))}
    if uniform:
        rng, k_pert = jax.random.split(k_perturb)
        d["z_noise"] = np.asarray(jax.random.uniform(k_pert, (N_RAYS, T)))
        d["u"] = np.asarray(jax.random.uniform(jax.random.fold_in(rng, 7), (N_RAYS * T, cfg_spec_stoch, 1, 3)))
    else:
        d["noise"] = np.asarray(jax.random.uniform(k_perturb, (N_RAYS,)))
        d["u"] = np.asarray(jax.random.uniform(jax.random.fold_in(k_perturb, 7),
                                               (N_RAYS * SLAB, cfg_spec_stoch, 1, 3)))
    return d


def _n_stoch():
    from focnerf_tpu_torch.ops.hashgrid import stochastic_levels

    return len(stochastic_levels(tnerf.NeRFConfig(**HASH).grid_spec))


def _voxel_setup():
    """test_voxel_sp's scene: 6 views of one (axis, flip) variant, their
    JAX-warped targets [6, 32, 32, 3] and masks, the intrinsics."""
    from test_voxel_sp import _setup

    key0, poses, gts, masks, intr, H = _setup(R=R_VOX)
    return key0, np.asarray(poses, np.float32), np.asarray(gts), np.asarray(masks), intr, H


def _fields():
    """Each voxel family's initial parameters (JAX's initializers), numpy."""
    from focnerf_tpu.train import voxel as jv
    from focnerf_tpu.train import voxel_dynamic as jdyn
    from focnerf_tpu.train import voxel_kplanes as jkp
    from focnerf_tpu.train import voxel_vm as jvm

    fields = {
        "dense": [jv.init_voxel_field(R_VOX, rng=jax.random.key(0))],
        "vm": list(jvm.init_vm_field(R_VOX, rank=2, rng=jax.random.key(1), init_scale=0.3)),
        "dyn": list(jdyn.init_dyn_voxel_field(R_VOX, rank=2, time_slots=4, rng=jax.random.key(2))),
        "kplanes": list(jkp.init_kplanes_field(R_VOX, rank=2, time_res=4, rng=jax.random.key(3), init_scale=0.3,
                                               w0=0.5)),
    }
    return {f"{fam}.{i}": np.asarray(a, np.float32) for fam, leaves in fields.items()
            for i, a in enumerate(leaves)}


def _make_inputs(path):
    from test_torch_model import make_jax_params
    from test_torch_train import _batch

    from focnerf_tpu.models import nerf as jnerf

    out = {}
    params = make_jax_params(jnerf.NeRFConfig(**HASH), grid_scale=0.5)
    params["sigma_net"][-1][:, 0] *= 4.0  # a visible object
    _flat("hash/", params, out)
    batch = _batch(N_RAYS)
    for k, v in batch.items():
        out[f"batch/{k}"] = np.asarray(v)
    n_stoch = _n_stoch()
    for s in range(3):
        for k, v in _hash_draws(jax.random.key(10 + s), n_stoch, uniform=False).items():
            out[f"occ{s}/{k}"] = v
    for k, v in _hash_draws(jax.random.key(20), n_stoch, uniform=True).items():
        out[f"uni/{k}"] = v
    out["bits"] = _occ_bits()
    for i in range(K_OBJ):
        _flat(f"obj{i}/", _object_params(i), out)
    o, d = _compose_rays()
    out["compose/o"], out["compose/d"] = o, d
    key0, poses, gts, masks, intr, H = _voxel_setup()
    out.update({"vox/poses": poses, "vox/gts": gts, "vox/masks": masks, "vox/intr": np.asarray(intr, np.float32),
                "vox/key": np.asarray([key0[0], int(key0[1]), H]), "vox/times": _times()})
    out.update({f"field/{k}": v for k, v in _fields().items()})
    np.savez(path, **out)


def _occ_bits():
    from test_torch_render import sphere_density_grid

    return sphere_density_grid(1.0) > 10.0


def _object_params(i):
    from focnerf_tpu.models import nerf as jnerf

    p = jax.tree.map(np.array, jnerf.init_nerf_params(jax.random.key(i), jnerf.NeRFConfig(**TINY,
                                                                                         compute_dtype=jnp.float32)))
    p["grid"] = p["grid"] * (1e4 + i * 1e3)  # densities that differ decisively between objects
    return p


def _compose_rays():
    rng = np.random.default_rng(4)
    o = np.zeros((16, 3), np.float32)
    o[:, 2] = -2.0
    o[:, :2] = rng.uniform(-0.3, 0.3, (16, 2))
    d = np.zeros((16, 3), np.float32)
    d[:, 2] = 1.0
    return o, d


def _times():
    return np.linspace(0.0, 1.0, 4).astype(np.float32)


# ------------------------------------------------------- the ranks' cases
def _case_dp_occupancy(mesh, inp):
    from focnerf_tpu_torch.parallel.sharding import make_sharded_train_step_occupancy

    cfg = tnerf.NeRFConfig(**HASH, compute_dtype=torch.float32)
    ts = TrainState(interop.params_from_jax(_unflat("hash/", inp), cfg, "cpu"), lr=LR, iters=ITERS)
    batch = {k[6:]: torch.from_numpy(inp[k]) for k in inp.files if k.startswith("batch/")}
    step = make_sharded_train_step_occupancy(cfg, mesh, dt_gamma=0.0, max_steps=1024, slab=SLAB)
    bits = torch.from_numpy(inp["bits"])
    out = {}
    for s in range(3):
        draws = {k[5:]: torch.from_numpy(inp[k]) for k in inp.files if k.startswith(f"occ{s}/")}
        m = step(ts, batch, bits, draws)
        if s == 0:
            out.update(loss=m["loss"].numpy(), per_ray_error=m["per_ray_error"].numpy(),
                       mean_samples=m["mean_samples"].numpy())
            for i, p in enumerate(param_leaves(ts.params)):
                out[f"p1.{i}"] = p.detach().numpy().copy()
                out[f"g1.{i}"] = ts.optimizer.state[p]["exp_avg"].numpy() / 0.1  # first moment from 0
    for i, p in enumerate(param_leaves(ts.params)):
        out[f"p3.{i}"] = p.detach().numpy()
    return out


def _case_dp_uniform(mesh, inp):
    from focnerf_tpu_torch.parallel.sharding import make_sharded_train_step

    cfg = tnerf.NeRFConfig(**HASH, compute_dtype=torch.float32)
    ts = TrainState(interop.params_from_jax(_unflat("hash/", inp), cfg, "cpu"), lr=LR, iters=ITERS)
    batch = {k[6:]: torch.from_numpy(inp[k]) for k in inp.files if k.startswith("batch/")}
    draws = {k[4:]: torch.from_numpy(inp[k]) for k in inp.files if k.startswith("uni/")}
    m = make_sharded_train_step(cfg, mesh, num_steps=T, mask_penalty=MASK_PENALTY)(ts, batch, draws)
    out = {"loss": m["loss"].numpy(), "per_ray_error": m["per_ray_error"].numpy()}
    for i, p in enumerate(param_leaves(ts.params)):
        out[f"g1.{i}"] = ts.optimizer.state[p]["exp_avg"].numpy() / 0.1
    return out


def _case_compose(mesh, inp):
    from focnerf_tpu_torch.parallel.sharding import compose_rays_sharded, shard_objects

    cfg = tnerf.NeRFConfig(**TINY, compute_dtype=torch.float32)
    objs = [interop.params_from_jax(_unflat(f"obj{i}/", inp), cfg, "cpu") for i in range(K_OBJ)]
    out = compose_rays_sharded(shard_objects(objs, mesh), cfg, torch.from_numpy(inp["compose/o"]),
                               torch.from_numpy(inp["compose/d"]), mesh, num_steps=16, bg_color=1.0)
    return {k: v.numpy() for k, v in out.items()}


def _voxel_dp_step(family, mesh, inp):
    """(init, step, initial params, time-conditioned) of one family's port step."""
    from focnerf_tpu_torch.train import voxel, voxel_dynamic, voxel_kplanes, voxel_vm

    axis, flip, H = (int(a) for a in inp["vox/key"])
    kw = dict(H=H, W=H, resolution=R_VOX, warp_axis=axis, flip=bool(flip), lr=5e-2)
    fam = {"dense": (voxel.make_voxel_dp_step, None),
           "vm": (voxel_vm.make_vm_dp_step, voxel_vm.VMField),
           "dyn": (voxel_dynamic.make_dyn_dp_step, voxel_dynamic.DynVoxelField),
           "kplanes": (voxel_kplanes.make_kplanes_dp_step, voxel_kplanes.KPlanesField)}
    make, cls = fam[family]
    leaves = [torch.from_numpy(inp[k]) for k in sorted((k for k in inp.files if k.startswith(f"field/{family}.")),
                                                       key=lambda k: int(k.rsplit(".", 1)[1]))]
    params = leaves[0] if cls is None else cls(*leaves)
    init, step = make(mesh, tuple(inp["vox/intr"]), **kw)
    return init, step, params, family in ("dyn", "kplanes")


def _case_voxel_dp(mesh, inp):
    out = {}
    poses = inp["vox/poses"][:4]
    gts, masks = torch.from_numpy(inp["vox/gts"][:4]), torch.from_numpy(inp["vox/masks"][:4])
    for family in ("dense", "vm", "dyn", "kplanes"):
        init, step, params, timed = _voxel_dp_step(family, mesh, inp)
        state = init(params)
        args = (poses, inp["vox/times"], gts, masks) if timed else (poses, gts, masks)
        out[f"{family}/mse"] = step(state, *args).numpy()
        for i, p in enumerate(state.leaves):
            out[f"{family}/p.{i}"] = p.detach().numpy()
    return out


def _case_main_voxel_sp(mesh, inp, work):
    from focnerf_tpu_torch.apps import main_voxel

    vol, info = main_voxel.main([os.path.join(work, "scene"), "--workspace", os.path.join(work, "sp_ws"),
                                 "--iters", "3", "--bake_res", "16", "--scale", "1.0", "--bound", "1.0",
                                 "--voxel_sp"], device="cpu")
    return {"rgba": vol.rgba.numpy(), "n_devices": np.asarray(info["n_devices"]), "step_mse": info["step_mse"]}


def _case_mesh(mesh, inp):
    from focnerf_tpu_torch.parallel.mesh import replicate, shard_batch

    rank = mesh.get_local_rank("data")
    tree = {"w": torch.full((3,), float(rank)), "nets": [torch.arange(4.0) + rank]}
    got = replicate(tree, mesh)
    batch = shard_batch({"rays": torch.arange(8.0).reshape(4, 2), "feat": torch.arange(3.0),
                         "scalar": torch.tensor(5.0)}, mesh)
    return {"w": got["w"].numpy(), "net": got["nets"][0].numpy(), "rays": batch["rays"].numpy(),
            "feat": batch["feat"].numpy(), "scalar": batch["scalar"].numpy()}


CASES = {
    "mesh": _case_mesh,
    "dp_occupancy": _case_dp_occupancy,
    "dp_uniform": _case_dp_uniform,
    "compose": _case_compose,
    "voxel_dp": _case_voxel_dp,
    "main_voxel_sp": _case_main_voxel_sp,
}


def _worker(rank: int, world: int, work: str):
    from focnerf_tpu_torch.parallel.distributed import initialize, shutdown
    from focnerf_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    initialize(rank, world, init_method=f"file://{work}/store", timeout_s=300, device="cpu")
    mesh = make_mesh(device="cpu")
    inp = np.load(os.path.join(work, "inputs.npz"))
    for name, case in CASES.items():
        args = (mesh, inp, work) if name == "main_voxel_sp" else (mesh, inp)
        np.savez(os.path.join(work, f"{name}.{rank}.npz"), **case(*args))
    shutdown()


class Ranks:
    """The worker processes of one world, each running ``script --worker rank
    world work``; ``result(case)`` waits for them."""

    def __init__(self, work: str, world: int, script: str = __file__, timeout: float = 600):
        self.work, self.world, self.deadline = work, world, time.time() + timeout
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(script), "--worker", str(r), str(world),
                                        work], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                      for r in range(world)]
        self.logs = None

    def wait(self):
        if self.logs is None:
            self.logs = []
            for p in self.procs:
                try:
                    out, _ = p.communicate(timeout=max(self.deadline - time.time(), 1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                self.logs.append((p.returncode, out))
        return self.logs

    def result(self, case: str):
        logs = self.wait()
        assert all(rc == 0 for rc, _ in logs), "\n".join(out[-4000:] for _, out in logs)
        return [np.load(os.path.join(self.work, f"{case}.{r}.npz")) for r in range(self.world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from helpers import make_synthetic_scene

    work = str(tmp_path_factory.mktemp("parallel_ranks"))
    _make_inputs(os.path.join(work, "inputs.npz"))
    make_synthetic_scene(os.path.join(work, "scene"), n_train=4, n_val=1, H=16, W=16)
    r = Ranks(work, WORLD)
    yield r
    r.wait()


def _jax_mesh():
    from focnerf_tpu.parallel.mesh import make_mesh

    return make_mesh(WORLD)


def _jax_hash_state():
    from focnerf_tpu.models import nerf as jnerf
    from focnerf_tpu.train import state as jstate
    from test_torch_model import make_jax_params

    jcfg = jnerf.NeRFConfig(**HASH, compute_dtype=jnp.float32)
    params = make_jax_params(jcfg, grid_scale=0.5)
    params["sigma_net"][-1][:, 0] *= 4.0
    opt = jstate.make_optimizer(lr=LR, iters=ITERS)
    return jcfg, opt, jstate.create_train_state(jax.random.key(0), jcfg, opt, params=jax.tree.map(jnp.asarray,
                                                                                                  params))


def _jleaves(tree):
    from test_torch_train import _leaves

    return _leaves(tree)


def _jbatch():
    from test_torch_train import _batch

    return {k: jnp.asarray(v) for k, v in _batch(N_RAYS).items()}


# --------------------------------------------------------------- the tests
def test_dp_occupancy_step_matches_jax(ranks):
    """make_sharded_train_step_occupancy at W = 2 against JAX's on a 2-device
    mesh, same global batch, bitfield and draws: loss and per-ray error, the
    averaged gradient (Adam's first moment) and the update, at
    test_torch_train's fp32 STEP_TOL."""
    from test_torch_train import STEP_TOL

    from focnerf_tpu.parallel.sharding import make_sharded_train_step_occupancy as jmake

    jcfg, opt, s = _jax_hash_state()
    step = jmake(jcfg, opt, _jax_mesh(), dt_gamma=0.0, max_steps=1024, slab=SLAB)
    s1, m1 = step(s, _jbatch(), jnp.asarray(_occ_bits()), jax.random.key(10))
    got = ranks.result("dp_occupancy")
    loss_rel, g_tol, p_tol = STEP_TOL["float32"]
    for r in got:
        np.testing.assert_allclose(float(r["loss"]), float(m1["loss"]), rtol=loss_rel)
        np.testing.assert_allclose(r["per_ray_error"], np.asarray(m1["per_ray_error"]), rtol=1e-5, atol=1e-7)
    assert float(got[0]["mean_samples"]) > 4  # rays cross the object
    jgrads = [m / 0.1 for m in _jleaves(s1.opt_state[0].mu)]
    jparams = _jleaves(s1.params)
    for i, (g, p) in enumerate(zip(jgrads, jparams)):
        np.testing.assert_allclose(got[0][f"g1.{i}"], g, rtol=0, atol=g_tol * np.abs(g).max())
        # a first Adam step is +-lr wherever the gradient is not at the
        # rounding level: compare where it clears 1e-3 of the largest
        live = np.abs(g) > 1e-3 * np.abs(g).max()
        assert live.mean() > 0.01
        np.testing.assert_allclose(got[0][f"p1.{i}"][live], p[live], rtol=0, atol=p_tol * LR)


def test_replicate_and_shard_batch(ranks):
    """``replicate`` gives every rank rank 0's tensors; ``shard_batch`` keeps
    rank r's contiguous rows where the leading axis divides over the ranks
    and leaves the rest whole (JAX's rule)."""
    for r, got in enumerate(ranks.result("mesh")):
        np.testing.assert_array_equal(got["w"], np.zeros(3))
        np.testing.assert_array_equal(got["net"], np.arange(4.0))
        np.testing.assert_array_equal(got["rays"], np.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["feat"], np.arange(3.0))
        assert float(got["scalar"]) == 5.0


def test_dp_ranks_stay_bitwise_equal(ranks):
    """After 3 data-parallel steps every rank holds the same params, bit for bit."""
    got = ranks.result("dp_occupancy")
    names = [k for k in got[0].files if k.startswith("p3.")]
    assert names
    for k in names:
        assert np.array_equal(got[0][k], got[1][k]), k
    assert not np.array_equal(got[0]["p3.0"], got[0]["p1.0"])


def test_dp_uniform_with_mask_matches_jax(ranks):
    """make_sharded_train_step with a ray mask and a mask penalty whose norm
    is ~1/3 of the loss: the norm spans both ranks' rows (sum of squares
    summed before the root), so the loss and the averaged gradient match
    JAX's global step; a per-rank norm moves the loss by ~10%."""
    from test_torch_train import STEP_TOL

    from focnerf_tpu.parallel.sharding import make_sharded_train_step as jmake

    jcfg, opt, s = _jax_hash_state()
    jb = _jbatch()
    assert 0 < float(jnp.mean(jb["ray_mask"])) < 1
    s1, m1 = jmake(jcfg, opt, _jax_mesh(), num_steps=T, mask_penalty=MASK_PENALTY)(s, jb, jax.random.key(20))
    _, _, s0 = _jax_hash_state()
    s_np, m_np = jmake(jcfg, opt, _jax_mesh(), num_steps=T, mask_penalty=0.0)(s0, jb, jax.random.key(20))
    assert float(m1["loss"]) - float(m_np["loss"]) > 0.25 * float(m1["loss"])  # the norm term matters
    got = ranks.result("dp_uniform")
    loss_rel, g_tol, _ = STEP_TOL["float32"]
    for r in got:
        np.testing.assert_allclose(float(r["loss"]), float(m1["loss"]), rtol=loss_rel)
        np.testing.assert_allclose(r["per_ray_error"], np.asarray(m1["per_ray_error"]), rtol=1e-5, atol=1e-7)
    for i, m in enumerate(_jleaves(s1.opt_state[0].mu)):
        g = m / 0.1
        np.testing.assert_allclose(got[0][f"g1.{i}"], g, rtol=0, atol=g_tol * np.abs(g).max())


def test_compose_rays_sharded_matches_jax(ranks):
    """K = 4 objects over 2 ranks against JAX's compose_rays_sharded on a
    2-device mesh (test_parallel.py's tolerances)."""
    from focnerf_tpu.models import nerf as jnerf
    from focnerf_tpu.parallel.sharding import compose_rays_sharded, shard_objects
    from focnerf_tpu.render.compose import stack_object_params

    mesh = _jax_mesh()
    jcfg = jnerf.NeRFConfig(**TINY, compute_dtype=jnp.float32)
    stacked = stack_object_params([jax.tree.map(jnp.asarray, _object_params(i)) for i in range(K_OBJ)])
    o, d = _compose_rays()
    want = compose_rays_sharded(shard_objects(stacked, mesh), jcfg, jnp.asarray(o), jnp.asarray(d), mesh,
                                num_steps=16, bg_color=1.0)
    assert 0.05 < float(jnp.mean(want["alpha"])) < 0.999  # the objects are seen, not opaque everywhere
    for r in ranks.result("compose"):
        for k in ("image", "depth", "alpha"):
            np.testing.assert_allclose(r[k], np.asarray(want[k]), rtol=1e-4, atol=1e-5)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("family", ["dense", "vm", "dyn", "kplanes"])
def test_voxel_dp_step_matches_jax(ranks, family):
    """Each family's pose-parallel step at W = 2 (4 views, 2 a rank) against
    JAX's make_*_dp_step on a 2-device mesh: the mean mse within 1e-5, each
    leaf's step within 1e-3 relative L2 (test_torch_voxel's measure: Adam
    turns an fp32 difference in a tiny gradient into up to a full step)."""
    from focnerf_tpu.train import voxel as jv
    from focnerf_tpu.train import voxel_dynamic as jdyn
    from focnerf_tpu.train import voxel_kplanes as jkp
    from focnerf_tpu.train import voxel_vm as jvm

    key0, poses, gts, masks, intr, H = _voxel_setup()
    fields = _fields()
    leaves = [jnp.asarray(fields[f"{family}.{i}"]) for i in range(sum(k.startswith(f"{family}.") for k in fields))]
    make, params = {
        "dense": (jv.make_voxel_dp_step, leaves[0]),
        "vm": (jvm.make_vm_dp_step, jvm.VMField(*leaves) if family == "vm" else None),
        "dyn": (jdyn.make_dyn_dp_step, jdyn.DynVoxelField(*leaves) if family == "dyn" else None),
        "kplanes": (jkp.make_kplanes_dp_step, jkp.KPlanesField(*leaves) if family == "kplanes" else None),
    }[family]
    opt, step = make(_jax_mesh(), intr, H=H, W=H, resolution=R_VOX, warp_axis=key0[0], flip=key0[1], lr=5e-2)
    args = (jnp.asarray(poses[:4]),)
    if family in ("dyn", "kplanes"):
        args += (jnp.asarray(_times()),)
    new, _, mse = step(params, opt.init(params), *args, jnp.asarray(gts[:4]), jnp.asarray(masks[:4]))
    got = ranks.result("voxel_dp")
    new = [new] if family == "dense" else list(new)
    for r in got:
        np.testing.assert_allclose(float(r[f"{family}/mse"]), float(mse), rtol=1e-5)
    assert np.abs(np.asarray(new[0]) - np.asarray(leaves[0])).max() > 0
    for i, (w, p0) in enumerate(zip(new, leaves)):
        moved = np.asarray(w) - np.asarray(p0)  # zero for a leaf without gradient (dyn's wslots)
        step_i = got[0][f"{family}/p.{i}"] - np.asarray(p0)
        assert _rel_l2(step_i, moved) <= 1e-3 if moved.any() else not step_i.any(), i
        assert np.array_equal(got[0][f"{family}/p.{i}"], got[1][f"{family}/p.{i}"])


def test_main_voxel_sp_on_two_ranks(ranks):
    """main_voxel --voxel_sp under a 2-rank group: both ranks return the same
    gathered volume, only rank 0 wrote the workspace's files and printed
    ``[spvoxel]``, and the fit ran its 3 steps on finite losses."""
    got = ranks.result("main_voxel_sp")
    assert np.array_equal(got[0]["rgba"], got[1]["rgba"]) and got[0]["rgba"].shape == (16, 16, 16, 4)
    assert int(got[0]["n_devices"]) == 2 and got[0]["step_mse"].shape == (3,)
    assert np.isfinite(got[0]["step_mse"]).all()
    ws = os.path.join(ranks.work, "sp_ws")
    for name in ("baked_16_sh0.npz", "mesh.obj", "log.txt"):
        assert os.path.exists(os.path.join(ws, name)), name
    logs = ranks.wait()
    assert "[spvoxel] trained sharded over 2 devices" in logs[0][1]
    assert "[spvoxel]" not in logs[1][1] and "[voxel] saved" not in logs[1][1]
    with open(os.path.join(ws, "log.txt")) as f:
        assert len(f.read().splitlines()) == 1  # one writer


def test_voxel_dp_without_sp_is_ignored_as_in_jax(tmp_path, capsys):
    """--voxel_dp N without --voxel_sp trains on one device (JAX reads it only
    under --voxel_sp) and says so in one line: the same volume as without."""
    from helpers import make_synthetic_scene

    from focnerf_tpu_torch.apps import main_voxel

    scene = make_synthetic_scene(str(tmp_path / "scene"), n_train=4, n_val=1, H=16, W=16)
    argv = [scene, "--iters", "2", "--bake_res", "16", "--scale", "1.0", "--bound", "1.0"]
    plain, _ = main_voxel.main(argv + ["--workspace", str(tmp_path / "a")], device="cpu")
    capsys.readouterr()
    dp, _ = main_voxel.main(argv + ["--workspace", str(tmp_path / "b"), "--voxel_dp", "2"], device="cpu")
    out = capsys.readouterr().out
    assert out.count("--voxel_dp 2 is ignored without --voxel_sp") == 1
    assert torch.equal(plain.rgba, dp.rgba)
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_voxel_sp_kplanes_is_refused_in_one_line(tmp_path):
    """--voxel_sp --voxel_kplanes trains (tests/test_torch_factor_sp.py), but
    with --voxel_dp, the dense family's hybrid mesh, it is refused in one
    line before anything loads, as JAX refuses it."""
    from focnerf_tpu_torch.apps import main_voxel

    with pytest.raises(ValueError, match="drop --voxel_dp") as e:
        main_voxel.main(["scene", "--workspace", str(tmp_path / "w"), "--voxel_sp", "--voxel_kplanes", "2",
                         "--voxel_dp", "2"], device="cpu")
    assert "\n" not in str(e.value) and "--voxel_sp --voxel_kplanes" in str(e.value)
    assert not (tmp_path / "w").exists()


_ORPHAN = r"""
import sys, time
sys.path.insert(0, %r)
from focnerf_tpu_torch.parallel.distributed import initialize
t0 = time.time()
try:
    initialize(1, 2, init_method=%r, timeout_s=3, device="cpu")
    print("NO-ERROR")
except Exception as e:
    print("RAISED", type(e).__name__, round(time.time() - t0, 1))
"""


def test_missing_peer_raises_within_the_timeout(tmp_path):
    """Rank 1 of 2 whose rank 0 never starts: initialize raises (a timeout
    of 3 s) instead of hanging, well inside 30 s."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _ORPHAN % (root, f"file://{tmp_path}/store")
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    dt = time.time() - t0
    assert "RAISED" in out.stdout and "NO-ERROR" not in out.stdout, out.stdout + out.stderr
    assert dt < 30, dt


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
