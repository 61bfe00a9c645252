"""What the generators share: seeded weights and features, the configuration's
field in the program's terms, and the gaps that decide ``correct``.

Imports nothing of the program at module level.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List

import torch

from portbench.reference import nerf as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float8_e4m3fn": torch.float8_e4m3fn}


def mlp_dims(config: dict) -> Dict[str, List[int]]:
    """Layer widths of each MLP of the field, from the configuration."""
    L, C = config["num_levels"], config["level_dim"]
    sigma = [L * C] + [config["hidden_dim"]] * (config["num_layers"] - 1) + [1 + config["geo_feat_dim"]]
    color_in = config["sh_degree"] ** 2 + config["geo_feat_dim"] + config["yolo_encoding_dim"]
    color = [color_in] + [config["hidden_dim_color"]] * (config["num_layers_color"] - 1) + [3]
    yolo = [config["yolo_feats_dim"], config["yolo_hidden_dim"], config["yolo_encoding_dim"]]
    return {"sigma_net": sigma, "color_net": color, "yolo_net": yolo}


# torch-ngp's gridencoder initialises its table U(-1e-4, 1e-4), as the program does
TABLE_INIT = 1e-4


def seeded_weights(config: dict, seed: int, device, table_scale: float = TABLE_INIT) -> dict:
    """The field's weights from ``seed``, made on ``device`` in two calls:
    the hash table U(-table_scale, table_scale), the MLPs' [in, out] weights
    U(-1/sqrt(in), 1/sqrt(in)) (Kaiming-uniform, bias-free)."""
    g = torch.Generator(device=device).manual_seed(seed)
    grid = ref.layout_of(config)
    table = (torch.rand((grid.rows, config["level_dim"]), generator=g, device=device) * 2.0 - 1.0) * table_scale
    dims = mlp_dims(config)
    shapes = [(a, b) for ds in dims.values() for a, b in zip(ds[:-1], ds[1:])]
    flat = torch.rand(sum(a * b for a, b in shapes), generator=g, device=device) * 2.0 - 1.0
    params, i = {"grid": table}, 0
    for name, ds in dims.items():
        params[name] = []
        for a, b in zip(ds[:-1], ds[1:]):
            params[name].append((flat[i:i + a * b].reshape(a, b) / a**0.5).contiguous())
            i += a * b
    return params


def seeded_features(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """[n, dim] object features in [0, 1) from ``seed`` (a stand-in for the
    YOLO backbone's pooled activations)."""
    g = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    return torch.rand((n, dim), generator=g, device=device)


def program_config(config: dict, base):
    """The program's ``NeRFConfig`` ``base`` with every width of the
    configuration set from it."""
    return dataclasses.replace(
        base, bound=config["bound"], num_levels=config["num_levels"], level_dim=config["level_dim"],
        base_resolution=config["base_resolution"], log2_hashmap_size=config["log2_hashmap_size"],
        num_layers=config["num_layers"], hidden_dim=config["hidden_dim"], geo_feat_dim=config["geo_feat_dim"],
        num_layers_color=config["num_layers_color"], hidden_dim_color=config["hidden_dim_color"],
        sh_degree=config["sh_degree"], yolo_feats_dim=config["yolo_feats_dim"],
        yolo_encoding_dim=config["yolo_encoding_dim"], yolo_hidden_dim=config["yolo_hidden_dim"],
        compute_dtype=DTYPES[config["compute_dtype"]],
    )


def load_into(program_leaves: List[torch.Tensor], params: dict):
    """Copy the benchmark's weights into the program's leaves, in order, shape for shape."""
    mine = ref.leaves(params)
    if [tuple(p.shape) for p in program_leaves] != [tuple(q.shape) for q in mine]:
        raise ValueError(f"the program's weights {[tuple(p.shape) for p in program_leaves]} are not the "
                         f"configuration's {[tuple(q.shape) for q in mine]}")
    with torch.no_grad():
        for p, q in zip(program_leaves, mine):
            p.copy_(q)


def norm_gap(prog: List[float], want: List[float], keep=None) -> float:
    """The worst leaf's |norm - reference norm|, over the larger of that
    leaf's reference norm and the median leaf's; ``keep`` selects leaves."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = statistics.median(want[i] for i in idx)
    return max(abs(prog[i] - want[i]) / max(want[i], med, 1e-30) for i in idx)
