"""The bake gate (render/bake_gate.py) on the CPU: both reports held
against the JAX package's on the same object, volume, poses and views."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_baked import SMALL, blob_volume, look_at  # noqa: E402
from test_torch_compose import object_params  # noqa: E402
from test_torch_render import sphere_density_grid  # noqa: E402

from focnerf_tpu.models import nerf as jnerf  # noqa: E402
from focnerf_tpu.render import bake_gate as jgate  # noqa: E402
from focnerf_tpu.render import baked as jb  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.models import nerf as tnerf  # noqa: E402
from focnerf_tpu_torch.render import bake_gate as tgate  # noqa: E402
from focnerf_tpu_torch.render import baked as tb  # noqa: E402

H = W = 40
INTR = np.array([48.0, 48.0, 20.0, 20.0], np.float32)
# the first pose's eye is inside the volume cube: both reports skip it
POSES = np.stack([look_at((0.2, 0.1, 0.5), target=(0.0, 0.0, 3.0))]
                 + [look_at(e) for e in ((0.3, -0.2, 2.5), (2.4, 0.4, -0.3), (-0.2, -2.6, 0.5))])


def _same_report(got, want, psnr_keys):
    """Every key and count equal; PSNRs (rounded to 1e-3 dB) within 0.01 dB:
    fp32 renders that agree to ~1e-5 move a ~20-40 dB PSNR by < 1e-3 dB."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "per_view":
            assert [r["view"] for r in got[k]] == [r["view"] for r in v]
            for rg, rw in zip(got[k], v):
                key = next(x for x in rw if x != "view")
                assert abs(rg[key] - rw[key]) <= 0.01, (rg, rw)
        elif k in psnr_keys:
            assert abs(got[k] - v) <= 0.01, (k, got[k], v)
        else:
            assert got[k] == v, k


def test_bake_quality_report_matches_jax(tmp_path):
    jcfg = jnerf.NeRFConfig(**SMALL, bound=1.0, compute_dtype=jnp.float32)
    tcfg = tnerf.NeRFConfig(**SMALL, bound=1.0, compute_dtype=torch.float32)
    jp = object_params(jcfg, seed=21)
    feat = np.random.default_rng(22).normal(size=144).astype(np.float32)
    occ = sphere_density_grid(1.0, radius=0.8) > 10.0
    jparams, tparams = jax.tree.map(jnp.asarray, jp), interop.params_from_jax(jp, tcfg, "cpu")
    jvol = jb.bake_field(jparams, jcfg, resolution=16, obj_feat=jnp.asarray(feat), occ_bits=jnp.asarray(occ))
    tvol = interop.baked_volume_from_jax(jvol)  # the same volume on both sides
    kw = dict(num_steps=64, n_views=4, probe_max_res=32)
    want = jgate.bake_quality_report(jparams, jcfg, jvol, POSES, INTR, H, W, obj_feat=jnp.asarray(feat),
                                     occ_bits=jnp.asarray(occ), out_path=str(tmp_path / "j.json"), **kw)
    got = tgate.bake_quality_report(tparams, tcfg, tvol, POSES, INTR, H, W, obj_feat=torch.from_numpy(feat),
                                    occ_bits=torch.from_numpy(occ), out_path=str(tmp_path / "t" / "q.json"), **kw)
    assert got["views"] == 3 and got["probe_hw"] == [32, 32]  # the interior pose skipped; scaled to 32
    _same_report(got, want, {"psnr_baked_vs_exact_mean", "psnr_baked_vs_exact_min"})
    with open(tmp_path / "t" / "q.json") as f:
        assert json.load(f) == got
    assert 5.0 < got["psnr_baked_vs_exact_min"] < 60.0


@pytest.mark.parametrize("sh_deg", [0, 2])
def test_volume_quantization_report_matches_jax(tmp_path, sh_deg):
    jv = jb.BakedVolume(rgba=jnp.asarray(blob_volume(sh_deg=sh_deg, seed=23)), bound=1.0, sh_deg=sh_deg)
    jq = jb.quantize_volume(jv)
    tv, tq = interop.baked_volume_from_jax(jv), interop.baked_volume_from_jax(jq)
    kw = dict(n_views=4, probe_max_res=24, density_scale=1.5)
    want = jgate.volume_quantization_report(jv, jq, POSES, INTR, H, W, **kw)
    got = tgate.volume_quantization_report(tv, tq, POSES, INTR, H, W, out_path=str(tmp_path / "q.json"), **kw)
    assert got["views"] == 3 and got["probe_hw"] == [24, 24]
    _same_report(got, want, {"psnr_quantized_vs_float_mean", "psnr_quantized_vs_float_min"})
    assert got["psnr_quantized_vs_float_min"] > 25.0  # uint8 costs little
