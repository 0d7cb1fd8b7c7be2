"""Watermark core: specs, greenlists, n-gram scoring, detection, sampling."""

from wmar_tpu_torch.core.detect import detect, green_fraction, pvalue_from_counts, score_codes
from wmar_tpu_torch.core.greenlist import (
    HashGreenlist,
    LazyTorchCompatGreenlist,
    TableGreenlist,
    VQInfo,
    build_table_torch_compat,
    clustering_greenlist,
    fixed_greenlist_from_ids,
    make_greenlist,
)
from wmar_tpu_torch.core.sampling import (
    apply_watermark_bias,
    cfg_combine,
    context_keys_at_step,
    rar_cfg_scale,
    warp_and_sample,
)
from wmar_tpu_torch.core.spec import SeedStrategy, SplitStrategy, WatermarkSpec

__all__ = [
    "HashGreenlist",
    "LazyTorchCompatGreenlist",
    "SeedStrategy",
    "SplitStrategy",
    "TableGreenlist",
    "VQInfo",
    "WatermarkSpec",
    "apply_watermark_bias",
    "build_table_torch_compat",
    "cfg_combine",
    "clustering_greenlist",
    "context_keys_at_step",
    "detect",
    "fixed_greenlist_from_ids",
    "green_fraction",
    "make_greenlist",
    "pvalue_from_counts",
    "rar_cfg_scale",
    "score_codes",
    "warp_and_sample",
]
