"""The port's tools (port of `attentiondm_tpu/tools`) and its Hopper measurement scripts."""
from .activation_range import (
    collect_activation_ranges,
    collect_weight_ranges,
    collect_attention_ranges,
    save_range_report,
    plot_activation_ranges,
    plot_weight_ranges_qdiffusion_style,
    plot_attention_heatmaps,
)

__all__ = [
    "collect_activation_ranges",
    "collect_weight_ranges",
    "collect_attention_ranges",
    "save_range_report",
    "plot_activation_ranges",
    "plot_weight_ranges_qdiffusion_style",
    "plot_attention_heatmaps",
]
