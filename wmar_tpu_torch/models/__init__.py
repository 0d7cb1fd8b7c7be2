"""Model families: RAR with the MaskGit-VQGAN tokenizer, behind the ARMM API."""

from wmar_tpu_torch.models.armm import ARMMWrapper, GenParams, RarARMM
from wmar_tpu_torch.models.maskgit_vqgan import (
    MASKGIT_IMAGENET_F16,
    MaskGitVQConfig,
    MaskGitVQGAN,
    init_maskgit,
)
from wmar_tpu_torch.models.rar import RAR, RARConfig, RARSampler, init_rar, quantize_rar_params_int8, rar_config

__all__ = [
    "ARMMWrapper",
    "GenParams",
    "MASKGIT_IMAGENET_F16",
    "MaskGitVQConfig",
    "MaskGitVQGAN",
    "RAR",
    "RARConfig",
    "RARSampler",
    "RarARMM",
    "init_maskgit",
    "init_rar",
    "quantize_rar_params_int8",
    "rar_config",
]
