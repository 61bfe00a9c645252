"""Encoder dispatch (torch-ngp's ``get_encoder``).

Twin of focnerf_tpu/ops/encoding.py: names map onto the port's encoders
as (encode_fn(params, x) -> features, init_fn(generator, device) -> params,
output dim) triples. Stateless encoders (frequency, spherical harmonics,
none) take and init ``None``; the hash grid's params are its table and its
inputs lie in [0, 1].
"""

from __future__ import annotations

from focnerf_tpu_torch.ops.freq import freq_encode, freq_output_dim
from focnerf_tpu_torch.ops.hashgrid import HashGridSpec, hashgrid_encode, hashgrid_init
from focnerf_tpu_torch.ops.sh import sh_encode


def _no_params(generator=None, device=None):
    return None


def get_encoder(
    encoding: str = "hashgrid",
    input_dim: int = 3,
    degree: int = 4,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: float = 2048,
):
    """(encode_fn, init_fn, output_dim) for 'None' | 'frequency' |
    'sphere_harmonics' | 'hashgrid' | 'tiledgrid' ('tiledgrid' is the hash
    grid, as in the JAX package)."""
    if encoding in ("None", "none", None):
        return (lambda p, x: x), _no_params, input_dim
    if encoding == "frequency":
        return (lambda p, x: freq_encode(x, degree)), _no_params, freq_output_dim(input_dim, degree)
    if encoding == "sphere_harmonics":
        return (lambda p, x: sh_encode(x, degree)), _no_params, degree**2
    if encoding in ("hashgrid", "tiledgrid"):
        spec = HashGridSpec.create(
            num_levels=num_levels, level_dim=level_dim, base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size, desired_resolution=desired_resolution,
            input_dim=input_dim,
        )

        def init(generator, device="cpu"):
            return hashgrid_init(spec, generator, device)

        return (lambda p, x: hashgrid_encode(p, x, spec)), init, spec.output_dim
    raise ValueError(f"unknown encoding {encoding!r}")
