"""The eval networks (port of `attentiondm_tpu/eval`): the FID Inception, FID and the CLIP scorer."""
from .fid import (
    calculate_activation_statistics,
    calculate_fid_given_paths,
    calculate_frechet_distance,
    compute_statistics_of_path,
    save_fid_stats,
)
from .inception import InceptionV3FID, inception_apply, inception_init, load_torch_inception

__all__ = [
    "calculate_frechet_distance",
    "calculate_activation_statistics",
    "compute_statistics_of_path",
    "calculate_fid_given_paths",
    "save_fid_stats",
    "InceptionV3FID",
    "inception_init",
    "inception_apply",
    "load_torch_inception",
]
