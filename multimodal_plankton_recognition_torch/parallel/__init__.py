"""The parallel layer (``parallel/`` of the JAX package): the process
group as a ``(data, model)`` mesh, its start under ``torchrun``, the
global-negatives losses and the row-sharded kNN."""

from .contrastive import global_clip_loss, global_siglip_loss
from .knn import ShardedGallery, shard_gallery, sharded_topk_euclidean
from .mesh import Mesh, create_mesh, replicate_state, shard_batch

__all__ = [
    "Mesh", "create_mesh", "shard_batch", "replicate_state",
    "global_clip_loss", "global_siglip_loss",
    "ShardedGallery", "shard_gallery", "sharded_topk_euclidean",
]
