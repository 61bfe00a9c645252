"""The port's ops: plain PyTorch, and the wrappers of the CUDA kernels."""


def kernel_wrappers():
    """Every kernel wrapper of the port, each counting its launches in
    ``.launches``."""
    from focnerf_tpu_torch.ops.composite import (
        composite_rays_fused,
        composite_rays_fused_backward,
        composite_rays_resume,
    )
    from focnerf_tpu_torch.ops.hashgrid import hashgrid_encode_forward, hashgrid_input_grad, hashgrid_table_grad
    from focnerf_tpu_torch.ops.marching import march_rays_skip

    return (composite_rays_fused, composite_rays_resume, composite_rays_fused_backward, hashgrid_table_grad,
            march_rays_skip, hashgrid_encode_forward, hashgrid_input_grad)
