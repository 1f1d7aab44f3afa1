"""The parallel runtime over `torch.distributed` (port of `attentiondm_tpu/parallel`)."""
from .distributed import initialize_distributed
from .mesh import batch_sharding, make_mesh, replicate, replicated_sharding, shard_batch
from .tp import UNetParallel, gather_unet_params, shard_batch_spatial, shard_unet_params, sharded_fraction, unet_param_specs

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "initialize_distributed",
    "unet_param_specs",
    "shard_unet_params",
    "gather_unet_params",
    "shard_batch_spatial",
    "sharded_fraction",
    "UNetParallel",
]
