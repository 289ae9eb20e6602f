"""Block-NeRF: the city-scale model of MLP blocks, each trained on its own
part of the capture and composed at inference (the counterpart of
``unboundednerfpytorch_tpu/models/block_nerf``)."""

from unboundednerfpytorch_tpu_torch.models.block_nerf.model import (
    BlockNeRF, block_nerf_apply, block_nerf_loss, inter_pos_embedding, pos_embedding,
    visibility_apply,
)
from unboundednerfpytorch_tpu_torch.models.block_nerf.rendering import (
    get_cone_mean_conv, render_rays, sample_pdf, volume_rendering,
)

__all__ = [
    "BlockNeRF",
    "block_nerf_apply",
    "block_nerf_loss",
    "inter_pos_embedding",
    "pos_embedding",
    "visibility_apply",
    "get_cone_mean_conv",
    "render_rays",
    "sample_pdf",
    "volume_rendering",
]
