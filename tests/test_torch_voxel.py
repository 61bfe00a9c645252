"""The dense voxel family (train/voxel.py) on the CPU, held against the JAX
package's functions on the same inputs: the activation, the regularizer,
the pose variants, the c2f plan, the upsample, the inverse activation, one
loss-and-gradient evaluation per supervise mode and SH degree, five Adam
steps of the training loop, ``remat`` and the c2f ladder end to end.

The scene: 24x24 views of an analytic two-blob volume from six poses (every
axis and flip) and two more, rendered once by the port's shear-warp.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_baked import blob_volume, look_at, six_poses  # noqa: E402

from focnerf_tpu.render import baked as jb  # noqa: E402
from focnerf_tpu.train import voxel as jv  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.render import baked as tb  # noqa: E402
from focnerf_tpu_torch.train import voxel as tv  # noqa: E402

R = 16
HW = 24
INTR = (30.0, 30.0, 12.0, 12.0)
# the loss: fp32, sums over slices in another order
LOSS_RTOL = 1e-5
# the gradient, relative L2 over all its entries
GRAD_RTOL = 1e-4


def scene_poses():
    return np.stack(six_poses() + [look_at((1.9, 1.2, 1.3)), look_at((-1.4, -2.0, 0.9))])


def scene(seed: int = 0, sh_deg: int = 0):
    """(poses [8, 4, 4], images [8, HW, HW, 3]) numpy: a 32^3 blob volume
    rendered by the port on white."""
    vol = tb.BakedVolume(rgba=torch.from_numpy(blob_volume(32, sh_deg, seed=seed)), bound=1.0, sh_deg=sh_deg)
    poses = scene_poses()
    imgs = np.stack([tb.render_baked(vol, p, INTR, HW, HW, bg_color=1.0)[0].numpy() for p in poses])
    return poses, imgs.astype(np.float32)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def shared_raw(R=R, sh_deg=0, seed=1):
    """A raw field with structure (not the flat init), numpy."""
    rng = np.random.default_rng(seed)
    P = 3 * max(sh_deg, 1) ** 2 if sh_deg else 3
    raw = rng.normal(0.0, 0.5, (R, R, R, P + 1)).astype(np.float32)
    raw[..., -1] += 1.0
    return raw


@pytest.mark.parametrize("sh_deg", [0, 2])
def test_field_to_volume_and_tv_match_jax(sh_deg):
    raw = shared_raw(8, sh_deg)
    want = jv.field_to_volume(jnp.asarray(raw), 1.5, sh_deg)
    got = tv.field_to_volume(torch.from_numpy(raw), 1.5, sh_deg)
    assert got.bound == want.bound and got.sh_deg == want.sh_deg
    np.testing.assert_allclose(got.rgba.numpy(), np.asarray(want.rgba), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tv.tv_loss(torch.from_numpy(raw))), float(jv.tv_loss(jnp.asarray(raw))),
                               rtol=1e-5)  # fp32 means, summed in another order


def test_pose_variants_match_jax():
    """All six (axis, flip) variants, and the fallback when the eye sits in
    the slab of the most-aligned axis."""
    poses = list(scene_poses()) + [look_at((0.5, 2.5, 0.3), target=(3.0, 1.8, 0.3))]
    got = [tv._pose_variant(p, 1.0) for p in poses]
    assert got == [jv._pose_variant(p, 1.0) for p in poses]
    assert set(got[:6]) == {(a, f) for a in range(3) for f in (False, True)}
    assert got[-1] == (1, False)


@pytest.mark.parametrize("res,stages,iters", [(128, 3, 500), (32, 2, 7), (16, 3, 2), (64, 4, 1), (48, 2, 10)])
def test_c2f_stage_plan_matches_jax(res, stages, iters):
    assert tv._c2f_stage_plan(res, stages, iters) == jv._c2f_stage_plan(res, stages, iters)


@pytest.mark.parametrize("src,dst", [(4, 8), (5, 8), (4, 9), (3, 7), (8, 16)])
def test_upsample_field_matches_jax(src, dst):
    """Half-pixel centres with the edge taps renormalized, odd and even."""
    raw = shared_raw(src, seed=src)
    got = tv.upsample_field(torch.from_numpy(raw), dst)
    want = jv.upsample_field(jnp.asarray(raw), dst)
    assert got.shape == want.shape == (dst, dst, dst, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("sh_deg", [0, 2])
def test_volume_to_raw_matches_jax_at_the_clamps(sh_deg):
    rng = np.random.default_rng(3)
    P = 3 * max(sh_deg, 1) ** 2 if sh_deg else 3
    rgba = rng.uniform(0, 1, (4, 4, 4, P + 1)).astype(np.float32)
    edge = np.array([0.0, 1.0, 1e-7, 1 - 1e-7, 0.5, 1e-6, 0.999999, 0.25], np.float32)
    rgba[0, 0, :, :-1] = edge[:4, None] if sh_deg == 0 else rgba[0, 0, :, :-1]
    rgba[..., -1] = rng.choice(np.array([0.0, 1e-7, 1e-6, 1e-3, 0.5, 5.0, 60.0, 200.0], np.float32),
                               (4, 4, 4))
    want = jv._volume_to_raw(jb.BakedVolume(rgba=jnp.asarray(rgba), bound=1.0, sh_deg=sh_deg), sh_deg)
    got = tv._volume_to_raw(tb.BakedVolume(rgba=torch.from_numpy(rgba), bound=1.0, sh_deg=sh_deg), sh_deg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.isfinite(got.numpy()).all()
    # a round trip through the activation gives the volume back (away from the clamps)
    back = tv.field_to_volume(got, 1.0, sh_deg).rgba.numpy()
    ok = (rgba[..., -1] > 1e-3)
    np.testing.assert_allclose(back[..., -1][ok], rgba[..., -1][ok], rtol=1e-4)


def jax_loss(axis, flip, *, raw_fn, reg_fn, ri, sh_deg, supervise, H=HW, W=HW, remat=True):
    """The loss that JAX's _fit_field_loop builds for one variant (train/voxel.py)."""
    intr = jnp.asarray(INTR, jnp.float32)

    def loss_fn(params, pose, t, target, mask):
        vol = jv.field_to_volume(raw_fn(params, t), 1.0, sh_deg)
        if supervise == "intermediate":
            C, T, _, _ = jb._composite_core(vol.rgba, 1.0, pose, axis=axis, flip=flip, ri=ri, density_scale=1.0,
                                            sh_deg=sh_deg, remat=remat)
            img_i = C + T[..., None] * 1.0
            m = mask[..., None]
            mse = jnp.sum(m * (img_i - target) ** 2) / (3.0 * jnp.maximum(jnp.sum(mask), 1.0))
        else:
            img, _, _ = jb._render_core(vol.rgba, 1.0, pose, intr, axis=axis, flip=flip, H=H, W=W, ri=ri,
                                        bg_color=1.0, density_scale=1.0, sh_deg=sh_deg, remat=remat)
            mse = jnp.mean((img - target) ** 2)
        return mse + reg_fn(params), mse

    return loss_fn


def targets(supervise, pose, img, axis, flip, ri):
    """(JAX target, mask), (the port's): the pre-warped GT or the image."""
    if supervise == "screen":
        return (jnp.asarray(img), jnp.ones((1, 1))), (torch.from_numpy(img), torch.ones((1, 1)))
    want = jb.warp_gt_to_intermediate(jnp.asarray(img), pose, jnp.asarray(INTR), 1.0, axis=axis, flip=flip, ri=ri)
    got = tb.warp_gt_to_intermediate(torch.from_numpy(img), pose, INTR, 1.0, axis=axis, flip=flip, ri=ri)
    return want, got


def value_and_grads(jax_fn, port_fn, jparams, tparams, pose, t, jt, tt):
    """((loss, mse, grad leaves) of JAX, and of the port)."""
    (jl, jm), jg = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(jparams, jnp.asarray(pose), jnp.float32(t), *jt)
    leaves = [p.clone().requires_grad_(True) for p in tv._leaves(tparams)]
    tl, tm = port_fn(tv._rebuild(tparams, leaves), torch.from_numpy(pose), t, *tt)
    tl.backward()
    return (float(jl), float(jm), [np.asarray(g) for g in jax.tree.leaves(jg)]), \
        (float(tl.detach()), float(tm.detach()), [p.grad.numpy() for p in leaves])


def assert_value_and_grads_close(want, got):
    jl, jm, jg = want
    tl, tm, tg = got
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    assert abs(tm - jm) <= LOSS_RTOL * abs(jm), (tm, jm)
    assert len(jg) == len(tg)
    for g, w in zip(tg, jg):
        assert g.shape == w.shape
        assert np.linalg.norm(w) > 0
        assert rel_l2(g, w) <= GRAD_RTOL, rel_l2(g, w)


@pytest.mark.parametrize("supervise", ["intermediate", "screen"])
@pytest.mark.parametrize("sh_deg", [0, 2])
def test_loss_and_gradient_match_jax(supervise, sh_deg):
    """One loss-and-gradient evaluation at R = 16, ri = 32 from shared
    parameters, on two variants."""
    poses, imgs = scene()
    raw = shared_raw(R, sh_deg)
    ri = 2 * R
    reg_j = lambda p: 1e-4 * jv.tv_loss(p)  # noqa: E731
    reg_t = lambda p: 1e-4 * tv.tv_loss(p)  # noqa: E731
    for v in (0, 5):
        axis, flip = tv._pose_variant(poses[v], 1.0)
        jt, tt = targets(supervise, poses[v], imgs[v], axis, flip, ri)
        jax_fn = jax_loss(axis, flip, raw_fn=lambda p, t: p, reg_fn=reg_j, ri=ri, sh_deg=sh_deg,
                          supervise=supervise)
        port_fn = tv._make_loss(axis, flip, raw_fn=lambda p, t: p, reg_fn=reg_t, bound=1.0, sh_degree=sh_deg,
                                ri=ri, bg_color=1.0, density_scale=1.0, remat=True, supervise=supervise,
                                intr=torch.tensor(INTR), H=HW, W=HW)
        want, got = value_and_grads(jax_fn, port_fn, jnp.asarray(raw), torch.from_numpy(raw), poses[v], 0.0,
                                    jt, tt)
        assert_value_and_grads_close(want, got)


def test_remat_leaves_gradients_unchanged():
    poses, imgs = scene()
    raw = torch.from_numpy(shared_raw(32))
    axis, flip = tv._pose_variant(poses[2], 1.0)
    _, tt = targets("intermediate", poses[2], imgs[2], axis, flip, 64)
    grads = []
    for remat in (False, True):
        fn = tv._make_loss(axis, flip, raw_fn=lambda p, t: p, reg_fn=lambda p: 0.0, bound=1.0, sh_degree=0, ri=64,
                           bg_color=1.0, density_scale=1.0, remat=remat, supervise="intermediate")
        p = raw.clone().requires_grad_(True)
        loss, _ = fn(p, torch.from_numpy(poses[2]), 0.0, *tt)
        loss.backward()
        grads.append((float(loss), p.grad.numpy()))
    assert grads[0][0] == grads[1][0]
    assert rel_l2(grads[1][1], grads[0][1]) <= 1e-6


def test_fit_loop_five_adam_steps_match_jax():
    """_fit_field_loop for 5 steps from one set of initial parameters: the
    parameters after the last step, against JAX's (its step is jitted)."""
    poses, imgs = scene()
    raw = shared_raw(R)
    kw = dict(resolution=R, bound=1.0, iters=5, lr=5e-2, seed=3)
    jraw, jinfo = jv._fit_field_loop(poses, imgs, INTR, params=jnp.asarray(raw), raw_fn=lambda p, t: p,
                                     reg_fn=lambda p: 1e-4 * jv.tv_loss(p), **kw)
    traw, tinfo = tv._fit_field_loop(poses, imgs, INTR, params=interop.voxel_field_from_jax(raw),
                                     raw_fn=lambda p, t: p, reg_fn=lambda p: 1e-4 * tv.tv_loss(p), **kw)
    moved = np.asarray(jraw) - raw
    assert np.abs(moved).max() > 0.1  # five steps of lr 5e-2 moved the field
    # Adam's m / sqrt(v) turns an fp32 difference in a tiny gradient into up
    # to lr * (difference / eps) of step: the step's relative L2 is the test
    assert rel_l2(traw.numpy() - raw, moved) <= 1e-3
    assert abs(tinfo["psnr"] - jinfo["psnr"]) <= 1e-3
    assert tinfo["step_mse"].shape == (5,)


def test_c2f_ladder_16_to_32_matches_jax(monkeypatch):
    """fit_voxels_c2f at 16 -> 32 from one initial field (each package's
    init_voxel_field made to return it): stage PSNRs and the final field."""
    poses, imgs = scene()
    raw = shared_raw(16, seed=5)
    monkeypatch.setattr(jv, "init_voxel_field", lambda *a, **k: jnp.asarray(raw))
    monkeypatch.setattr(tv, "init_voxel_field", lambda *a, **k: torch.from_numpy(raw))
    kw = dict(resolution=32, stages=2, iters=4, seed=0, bound=1.0)
    jvol, jinfo = jv.fit_voxels_c2f(poses, imgs, INTR, **kw)
    tvol, tinfo = tv.fit_voxels_c2f(poses, imgs, INTR, **kw)
    assert tvol.rgba.shape == jvol.rgba.shape == (32, 32, 32, 4)
    np.testing.assert_allclose(tinfo["stage_psnrs"], jinfo["stage_psnrs"], atol=1e-3)
    assert rel_l2(tinfo["raw"].numpy(), np.asarray(jinfo["raw"])) <= 1e-4


def check_family(jraw_fn, jreg_fn, traw_fn, treg_fn, jparams, times, lr, R=R):
    """A factorized family against JAX from shared parameters ``jparams``
    (a JAX NamedTuple; the port's made by interop): one loss-and-gradient
    evaluation per time-conditioned view, then 5 Adam steps of
    _fit_field_loop (relative L2 of each leaf's step <= 1e-3)."""
    poses, imgs = scene()
    to_port = {"VMField": interop.vm_field_from_jax, "DynVoxelField": interop.dyn_field_from_jax,
               "KPlanesField": interop.kplanes_field_from_jax}[type(jparams).__name__]
    tparams = to_port(jparams)
    ri = 2 * R
    for v in (1, 6):
        axis, flip = tv._pose_variant(poses[v], 1.0)
        jt, tt = targets("intermediate", poses[v], imgs[v], axis, flip, ri)
        jax_fn = jax_loss(axis, flip, raw_fn=jraw_fn, reg_fn=jreg_fn, ri=ri, sh_deg=0, supervise="intermediate")
        port_fn = tv._make_loss(axis, flip, raw_fn=traw_fn, reg_fn=treg_fn, bound=1.0, sh_degree=0, ri=ri,
                                bg_color=1.0, density_scale=1.0, remat=True, supervise="intermediate")
        want, got = value_and_grads(jax_fn, port_fn, jparams, tparams, poses[v], float(times[v]), jt, tt)
        assert_value_and_grads_close(want, got)

    kw = dict(resolution=R, bound=1.0, iters=5, lr=lr, seed=2, times=times)
    jout, jinfo = jv._fit_field_loop(poses, imgs, INTR, params=jparams, raw_fn=jraw_fn, reg_fn=jreg_fn, **kw)
    tout, tinfo = tv._fit_field_loop(poses, imgs, INTR, params=tparams, raw_fn=traw_fn, reg_fn=treg_fn, **kw)
    assert type(tout).__name__ == type(jparams).__name__
    for name, g, w, p0 in zip(jparams._fields, tout, jout, jparams):
        moved = np.asarray(w) - np.asarray(p0)
        assert np.abs(moved).max() > 0, name
        assert rel_l2(g.numpy() - np.asarray(p0), moved) <= 1e-3, name
    assert abs(tinfo["psnr"] - jinfo["psnr"]) <= 1e-3
    return tout
