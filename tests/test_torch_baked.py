"""The baked path (render/baked.py) on the CPU: volumes and their storage,
the edits, the shear-warp renderer and its fold, the bake and the GT warp,
each held against the JAX package's function on the same inputs.

JAX's renderer is jitted, and XLA contracts multiply-adds into FMAs inside
the compiled fold: on these volumes that moves JAX's own image and depth up
to ~1.6e-5 from its eager values. The port computes each operation as JAX's
eager code does, so the tight checks run JAX under ``jax.disable_jit()``;
one check holds the port to the compiled JAX too, at a looser tolerance.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_compose import object_params  # noqa: E402
from test_torch_render import sphere_density_grid  # noqa: E402

from focnerf_tpu.models import nerf as jnerf  # noqa: E402
from focnerf_tpu.render import baked as jb  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.models import nerf as tnerf  # noqa: E402
from focnerf_tpu_torch.ops.composite import composite_rays_fused  # noqa: E402
from focnerf_tpu_torch.render import baked as tb  # noqa: E402

R = 32
HW = 24
INTR = (30.0, 30.0, 12.0, 12.0)
# fp32, the same operations as eager JAX, sums over slices in another order
ATOL = 1e-5
# the compiled JAX fold (FMA contraction, measured up to 1.6e-5 here)
ATOL_JIT = 1e-4


def blob_volume(R=R, sh_deg=0, seed=0, bound=1.0):
    """Two hard-edged blobs of sigma 40 and 25 in a random payload (rgb, or
    3 * sh_deg^2 SH coefficients), numpy [R, R, R, P + 1]."""
    rng = np.random.default_rng(seed)
    c = ((np.arange(R) + 0.5) / R * 2 - 1) * bound
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    sigma = (np.where((X - 0.2) ** 2 + Y**2 + Z**2 < 0.3**2, 40.0, 0.0)
             + np.where((X + 0.3) ** 2 + (Y - 0.2) ** 2 + (Z + 0.1) ** 2 < 0.25**2, 25.0, 0.0))
    payload = rng.uniform(0, 1, size=(R, R, R, 3 * max(sh_deg, 1) ** 2))
    if sh_deg:
        payload = payload - 0.5
    return np.concatenate([payload, sigma[..., None]], -1).astype(np.float32)


def look_at(eye, up=(0.0, 1.0, 0.0), target=(0.0, 0.0, 0.0)):
    """c2w [4, 4] float32 of a camera at ``eye`` looking at ``target`` (+z
    forward, +y down, as core.camera.rand_poses)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, down, fwd], -1)
    pose[:3, 3] = eye
    return pose


def six_poses():
    """One view per principal axis and sign (every axis and both flips)."""
    poses = []
    for ax in range(3):
        for sign in (1.0, -1.0):
            eye = np.array([0.3, -0.2, 0.1])
            eye[ax] = 2.5 * sign
            poses.append(look_at(eye, up=(1.0, 0.0, 0.0) if ax == 1 else (0.0, 1.0, 0.0)))
    return poses


def volumes(sh_deg, kind):
    """(JAX volume, the port's) of one kind: dense, quantized (the dense
    view of the uint8 volume) or resident (uint8 in the fold)."""
    jv = jb.BakedVolume(rgba=jnp.asarray(blob_volume(sh_deg=sh_deg)), bound=1.0, sh_deg=sh_deg)
    if kind == "quantized":
        jv = jb.dequantize_volume(jb.quantize_volume(jv))
    elif kind == "resident":
        jv = jb.quantize_volume(jv)
    return jv, interop.baked_volume_from_jax(jv)


def close(got, want, atol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    err = float(np.abs(got - np.asarray(want)).max())
    assert err <= atol, f"{what}: max_abs_err {err:.3g} > {atol}"


@pytest.mark.parametrize("kind", ["dense", "quantized", "resident"])
@pytest.mark.parametrize("sh_deg", [0, 2])
def test_render_baked_matches_jax(sh_deg, kind):
    jv, tv = volumes(sh_deg, kind)
    assert isinstance(tv, tb.QuantizedVolume) == (kind == "resident")
    cases = set()
    for pose in six_poses():
        cases.add(tb.view_axis(pose, 1.0))
        with jax.disable_jit():
            want = jb.render_baked(jv, pose, INTR, HW, HW, bg_color=0.3, density_scale=1.5)
        got = tb.render_baked(tv, pose, INTR, HW, HW, bg_color=0.3, density_scale=1.5)
        for name, g, w in zip(("image", "depth", "alpha"), got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
            close(g, w, ATOL, f"{name} at axis/flip {tb.view_axis(pose, 1.0)}")
        alpha = np.asarray(want[2])
        assert 0.05 < alpha.mean() < 0.95  # the blobs are in view
    assert cases == {(a, f) for a in range(3) for f in (False, True)}


def test_render_baked_matches_compiled_jax():
    jv, tv = volumes(0, "dense")
    for pose in six_poses():
        want = jb.render_baked(jv, pose, INTR, HW, HW)
        got = tb.render_baked(tv, pose, INTR, HW, HW)
        for name, g, w in zip(("image", "depth", "alpha"), got, want):
            close(g, w, ATOL_JIT, name)


def test_view_axis_fallback_and_interior_eye():
    # looking mostly along x from far out in y: x's slab holds the eye, so
    # the axis the eye is outside of is taken
    pose = look_at((0.5, 2.5, 0.3), target=(3.0, 1.8, 0.3))
    assert tb.view_axis(pose, 1.0) == (1, False)
    jv, tv = volumes(0, "dense")
    with jax.disable_jit():
        want = jb.render_baked(jv, pose, INTR, HW, HW)
    for g, w in zip(tb.render_baked(tv, pose, INTR, HW, HW), want):
        close(g, w, ATOL, "fallback axis")
    inside = look_at((0.5, 0.2, 0.9), target=(0.0, 0.0, 2.0))
    for mod, vol in ((jb, jv), (tb, tv)):
        with pytest.raises(ValueError, match="inside the volume cube"):
            mod.render_baked(vol, inside, INTR, HW, HW)


def _fold_inputs(mod, rgba, pose, ri, K, to):
    """The inputs render's core gives ``_fold_blocks``, made by ``mod``."""
    axis, flip = 2, False
    others = [0, 1]
    e = to(pose[:3, 3])
    e_z, e_y, e_x = e[axis], e[others[0]], e[others[1]]
    gy, gx, *_ = mod._grid_geometry(e_z, e_y, e_x, 1.0, ri)
    ddy = gy[:, None] - e_y
    ddx = gx[None, :] - e_x
    dt = (2.0 / R) * (ddy**2 + ddx**2 + e_z**2) ** 0.5 / abs(e_z)
    V = np.flip(np.transpose(rgba, (2, 0, 1, 3)), 0).reshape(R // K, K, R, R, -1)
    z = np.flip((np.arange(R, dtype=np.float32) + 0.5) / R * 2 - 1).reshape(R // K, K)
    return to(np.ascontiguousarray(V)), to(np.ascontiguousarray(z)), e_z, e_y, e_x, gy, gx, dt


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("return_od,with_depth", [(False, True), (True, False)])
def test_fold_blocks_matches_jax(with_carry, return_od, with_depth):
    rgba = blob_volume(sh_deg=0, seed=3)
    pose = look_at((0.2, -0.3, 2.6))
    ri, K = 2 * R, 16  # two blocks
    rng = np.random.default_rng(4)
    carry = (rng.uniform(0, 2, (ri, ri)).astype(np.float32),
             rng.uniform(0, 1, (ri, ri, 3)).astype(np.float32),
             rng.uniform(0, 3, (ri, ri)).astype(np.float32))
    outs = {}
    for name, mod, to in (("jax", jb, jnp.asarray), ("torch", tb, lambda a: torch.as_tensor(np.asarray(a)))):
        V, z, e_z, e_y, e_x, gy, gx, dt = _fold_inputs(mod, rgba, pose, ri, K, to)
        kw = dict(density_scale=1.0, with_depth=with_depth, return_od=return_od,
                  carry=tuple(to(c) for c in (carry if with_depth else carry[:2])) if with_carry else None)
        if mod is jb:
            kw["remat"] = False
        with jax.disable_jit():
            outs[name] = mod._fold_blocks(V, z, e_z, e_y, e_x, gy, gx, dt, 1.0, R, ri, **kw)
    for i, (g, w) in enumerate(zip(outs["torch"], outs["jax"])):
        if w is None:
            assert g is None
            continue
        close(g, w, ATOL if i != 0 or not return_od else 1e-4, f"output {i}")  # od up to ~10
    assert float(np.asarray(outs["jax"][0]).min()) < (0.5 if not return_od else 1e9)


@pytest.mark.parametrize("sh_deg", [0, 2])
def test_composite_core_and_sh_contraction_match_jax(sh_deg):
    """The private core (intermediate plane: C, T, D and the grid geometry)
    and ``sh_contract_plane`` on its own, for every axis and flip."""
    jv, tv = volumes(sh_deg, "dense")
    for pose in six_poses():
        axis, flip = tb.view_axis(pose, 1.0)
        kw = dict(axis=axis, flip=flip, ri=2 * R, density_scale=1.0, sh_deg=sh_deg)
        with jax.disable_jit():
            want = jb._composite_core(jv.rgba, 1.0, jnp.asarray(pose), **kw)
        got = tb._composite_core(tv.rgba, 1.0, torch.from_numpy(pose), **kw)
        for name, g, w in zip(("C", "T", "D"), got[:3], want[:3]):
            close(g, w, ATOL, f"{name} at axis/flip {(axis, flip)}")
        for g, w in zip(got[3], want[3]):
            close(g, w, 1e-6, "grid geometry")
    if sh_deg:
        rng = np.random.default_rng(16)
        C = rng.normal(size=(2 * R, 2 * R, 3 * sh_deg**2)).astype(np.float32)
        gy, gx = (np.linspace(-1.3, 1.2, 2 * R, dtype=np.float32) for _ in range(2))
        eye = (np.float32(-2.6), np.float32(0.3), np.float32(-0.2))  # e_z already negated
        kw = dict(axis=1, flip=True, ri=2 * R, sh_deg=sh_deg)
        want = jb.sh_contract_plane(jnp.asarray(C), *map(jnp.asarray, eye), jnp.asarray(gy), jnp.asarray(gx), **kw)
        got = tb.sh_contract_plane(torch.from_numpy(C), *map(torch.tensor, eye), torch.from_numpy(gy),
                                   torch.from_numpy(gx), **kw)
        close(got, want, 1e-6, "sh_contract_plane")
        assert 0.0 < float(got.mean()) < 1.0


def test_composite_core_fp32_on_request():
    """The private compute dtype: bf16 rounding of the volume, the hat
    matrices and the first product moves the result, fp32 does not."""
    _, tv = volumes(0, "dense")
    pose = torch.from_numpy(six_poses()[0])
    kw = dict(axis=0, flip=False, ri=2 * R, density_scale=1.0)
    ref = tb._composite_core(tv.rgba, 1.0, pose, **kw)
    same = tb._composite_core(tv.rgba, 1.0, pose, compute_dtype=torch.float32, **kw)
    bf16 = tb._composite_core(tv.rgba, 1.0, pose, compute_dtype=torch.bfloat16, **kw)
    assert torch.equal(ref[0], same[0]) and torch.equal(ref[1], same[1])
    err = float((bf16[0] - ref[0]).abs().max())
    assert 1e-5 < err < 5e-2, err


# ------------------------------------------------------------------ storage
@pytest.mark.parametrize("sh_deg", [0, 2])
def test_quantize_dequantize_match_jax(sh_deg):
    rgba = blob_volume(sh_deg=sh_deg, seed=5)
    jq = jb.quantize_volume(jb.BakedVolume(rgba=jnp.asarray(rgba), bound=1.0, sh_deg=sh_deg))
    tq = tb.quantize_volume(tb.BakedVolume(rgba=torch.from_numpy(rgba), bound=1.0, sh_deg=sh_deg))
    assert tq.q.dtype == torch.uint8 and tq.sh_deg == sh_deg
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(tq.los.numpy(), np.asarray(jq.los))
    assert tb.quantize_volume(tq) is tq
    np.testing.assert_array_equal(tb.dequantize_volume(tq).rgba.numpy(),
                                  np.asarray(jb.dequantize_volume(jq).rgba))


@pytest.mark.parametrize("quantize", [False, True])
def test_save_load_across_packages(tmp_path, quantize):
    """A volume saved by either package loads in the other with the same
    values, dense and resident; both write the same npz arrays."""
    rgba = blob_volume(sh_deg=2, seed=6)
    jv = jb.BakedVolume(rgba=jnp.asarray(rgba), bound=1.5, sh_deg=2)
    tv = tb.BakedVolume(rgba=torch.from_numpy(rgba), bound=1.5, sh_deg=2)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jb.save_volume(jpath, jv, quantize=quantize)
    tb.save_volume(tpath, tv, quantize=quantize)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].tobytes() == zt[k].tobytes(), k
    for path in (jpath, tpath):
        for resident in (False, True):
            want = jb.load_volume(path, resident=resident)
            got = tb.load_volume(path, resident=resident, device="cpu")
            assert type(got).__name__ == type(want).__name__ and got.bound == 1.5 and got.sh_deg == 2
            for field in ("q", "scales", "los") if resident else ("rgba",):
                g, w = getattr(got, field), np.asarray(getattr(want, field))
                assert g.numpy().dtype == w.dtype, field
                np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
    # a resident volume saved dense is dequantized first
    tb.save_volume(tpath, tb.quantize_volume(tv))
    np.testing.assert_array_equal(tb.load_volume(tpath, device="cpu").rgba.numpy(),
                                  np.asarray(jb.load_volume(tpath).rgba))


# -------------------------------------------------------------------- edits
def _pair(rgba, bound=1.0, sh_deg=0):
    return (jb.BakedVolume(rgba=jnp.asarray(rgba), bound=bound, sh_deg=sh_deg),
            tb.BakedVolume(rgba=torch.from_numpy(rgba.copy()), bound=bound, sh_deg=sh_deg))


@pytest.mark.parametrize("offset", [
    (0.5 / 16, -0.5 / 16, 1.5 / 16),  # half voxels round to even: 0, 0, 2
    (-2.5 / 16, 3.0 / 16, 0.0),
    (0.7, -0.41, 2.6),  # past the grid along z: empty
])
def test_shift_volume_matches_jax(offset):
    jv, tv = _pair(blob_volume(seed=7))
    got = tb.shift_volume(tv, offset).rgba.numpy()
    np.testing.assert_array_equal(got, np.asarray(jb.shift_volume(jv, offset).rgba))
    if abs(offset[2]) > 2:
        assert not got.any()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_rotate_volume_matches_jax(axis):
    rgba = blob_volume(seed=8)
    rgba[0, :, :, -1] = 30.0  # mass on the faces: corners leave the cube
    rgba[:, -1, :, -1] = 20.0
    jv, tv = _pair(rgba)
    for deg in (90.0, 180.0, -90.0, 450.0):  # lossless: to the bit
        got = tb.rotate_volume(tv, axis, deg).rgba
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(jb.rotate_volume(jv, axis, deg).rgba))
    for deg, center in ((30.0, (0.0, 0.0, 0.0)), (90.0, (0.1, -0.2, 0.15)), (-137.0, (0.0, 0.3, 0.0))):
        with jax.disable_jit():
            want = np.asarray(jb.rotate_volume(jv, axis, deg, center=center).rgba)
        got = tb.rotate_volume(tv, axis, deg, center=center).rgba.numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)  # sums of the 4 taps
        assert (want[..., -1] > 0).mean() > 0.01


def test_rotate_volume_is_right_handed():
    """+90 about z takes +x to +y (the cyclic pair)."""
    rgba = np.zeros((R, R, R, 4), np.float32)
    rgba[R - 2, R // 2, R // 2, -1] = 1.0  # a voxel near +x
    out = tb.rotate_volume(_pair(rgba)[1], 2, 90.0).rgba.numpy()
    assert np.argwhere(out[..., -1] > 0).tolist() == [[R // 2 - 1, R - 2, R // 2]]


def test_merge_volumes_matches_jax_first_wins_ties():
    a, b, c = (blob_volume(seed=s) for s in (9, 10, 11))
    b[..., -1] = np.where(np.arange(R)[:, None, None] % 2 == 0, a[..., -1], b[..., -1])  # ties
    c[..., -1] = 5.0
    pairs = [_pair(v) for v in (a, b, c)]
    got = tb.merge_volumes([p[1] for p in pairs]).rgba.numpy()
    want = np.asarray(jb.merge_volumes([p[0] for p in pairs]).rgba)
    np.testing.assert_array_equal(got, want)
    tie = (a[..., -1] == b[..., -1]) & (a[..., -1] > 5.0)
    assert tie.any() and np.array_equal(got[tie], a[tie])  # the first object wins a tie
    with pytest.raises(ValueError):
        tb.merge_volumes([pairs[0][1], tb.BakedVolume(rgba=torch.zeros(16, 16, 16, 4), bound=1.0)])


def test_warp_gt_to_intermediate_matches_jax():
    gt = np.random.default_rng(12).uniform(size=(HW, HW + 8, 3)).astype(np.float32)
    intr = (30.0, 30.0, (HW + 8) / 2, HW / 2)
    for pose in six_poses():
        axis, flip = tb.view_axis(pose, 1.0)
        with jax.disable_jit():
            wj, mj = jb.warp_gt_to_intermediate(jnp.asarray(gt), pose, intr, 1.0, axis=axis, flip=flip, ri=2 * R)
        wt, mt = tb.warp_gt_to_intermediate(torch.from_numpy(gt), pose, intr, 1.0, axis=axis, flip=flip, ri=2 * R)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        # the camera projection's 3-term sums in another order move a sample
        # point by ~1e-6 px, and the GT changes by up to ~1 per px
        close(wt, wj, ATOL, "warped GT")
        assert 0.2 < float(mt.mean()) <= 1.0


# --------------------------------------------------------------------- bake
SMALL = dict(num_levels=4, log2_hashmap_size=12, hidden_dim=16, hidden_dim_color=16)


@pytest.mark.parametrize("dtype,use_objfeat,sh_degree,bound", [
    ("float32", True, 0, 1.0),
    ("float32", False, 2, 1.0),
    ("float32", True, 0, 2.0),  # two cascades, with occ_bits
    ("bfloat16", True, 2, 1.0),
])
def test_bake_field_matches_jax(dtype, use_objfeat, sh_degree, bound):
    jcfg = jnerf.NeRFConfig(**SMALL, bound=bound, use_objfeat=use_objfeat, compute_dtype=getattr(jnp, dtype))
    tcfg = tnerf.NeRFConfig(**SMALL, bound=bound, use_objfeat=use_objfeat, compute_dtype=getattr(torch, dtype))
    # faint fine levels: the compiled JAX encode's FMAs stay below the fp32 tolerance
    jp = object_params(jcfg, seed=13)
    feat = np.random.default_rng(14).normal(size=144).astype(np.float32) if use_objfeat else None
    occ = None
    if bound > 1.0:
        occ = sphere_density_grid(bound, radius=0.9, gs=32) > 10.0  # [2, 32^3]
        assert occ.shape == (2, 32**3) and occ[0].mean() != occ[1].mean()
    res = 16
    want = jb.bake_field(jax.tree.map(jnp.asarray, jp), jcfg, resolution=res, grid_size=32, chunk=1000,
                         obj_feat=None if feat is None else jnp.asarray(feat), sh_degree=sh_degree,
                         occ_bits=None if occ is None else jnp.asarray(occ))
    got = tb.bake_field(interop.params_from_jax(jp, tcfg, "cpu"), tcfg, resolution=res, grid_size=32,
                        chunk=1000, obj_feat=feat, sh_degree=sh_degree,
                        occ_bits=None if occ is None else torch.from_numpy(occ))
    assert got.rgba.shape == (res, res, res, 3 * max(sh_degree, 1) ** 2 + 1) == want.rgba.shape
    assert got.bound == bound and got.sh_deg == sh_degree
    w = np.asarray(want.rgba)
    g = got.rgba.numpy()
    sig_w, sig_g = w[..., -1], g[..., -1]
    # fp32: the same products in another order, exp in sigma amplifies to ~1e-5
    # relative. bf16: both sides round the same operands; a 1-ulp fp32
    # difference can move a hidden unit to the neighbouring bf16 value.
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(sig_g, sig_w, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(g[..., :-1], w[..., :-1], rtol=rtol, atol=rtol * 10 if sh_degree else rtol)
    if occ is not None:  # occupancy zeroed the outer shell, in both cascades' terms
        assert (sig_w == 0).mean() > 0.3 and np.array_equal(sig_g == 0, sig_w == 0)


def test_bake_then_render_runs_no_kernel():
    """On the CPU the whole baked path is plain PyTorch."""
    jcfg = jnerf.NeRFConfig(**SMALL, bound=1.0, use_objfeat=False, compute_dtype=jnp.float32)
    tcfg = tnerf.NeRFConfig(**SMALL, bound=1.0, use_objfeat=False, compute_dtype=torch.float32)
    params = interop.params_from_jax(object_params(jcfg, seed=15), tcfg, "cpu")
    composite_rays_fused.launches = 0
    vol = tb.bake_field(params, tcfg, resolution=16)
    img, depth, alpha = tb.render_baked(vol, six_poses()[0], INTR, HW, HW)
    assert composite_rays_fused.launches == 0
    assert torch.isfinite(img).all() and float(alpha.max()) > 0.1
