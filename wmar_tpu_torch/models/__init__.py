"""Model families behind the ARMM API: RAR with the MaskGit-VQGAN tokenizer,
Taming's cin_transformer and Chameleon/Anole-7B (Llama) with the Taming
VQGAN tokenizer."""

from wmar_tpu_torch.models.armm import ARMMWrapper, GenParams, RarARMM, TamingARMM
from wmar_tpu_torch.models.chameleon import ChameleonARMM, ChameleonVocab, ImageCFGOptions, build_cfg_prompts
from wmar_tpu_torch.models.llama import (
    CHAMELEON_7B,
    LlamaConfig,
    init_llama_params,
    llama_forward,
    quantize_llama_params_int8,
)
from wmar_tpu_torch.models.maskgit_vqgan import (
    MASKGIT_IMAGENET_F16,
    MaskGitVQConfig,
    MaskGitVQGAN,
    init_maskgit,
)
from wmar_tpu_torch.models.rar import RAR, RARConfig, RARSampler, init_rar, quantize_rar_params_int8, rar_config
from wmar_tpu_torch.models.taming_gpt import (
    GPT,
    TAMING_GPT_1_4B,
    GPTConfig,
    gpt_forward,
    init_gpt,
    quantize_gpt_params_int8,
)
from wmar_tpu_torch.models.vqgan import (
    CHAMELEON_F16,
    TAMING_IMAGENET_F16,
    TamingVQGAN,
    VQGANConfig,
    init_taming_vqgan,
)

__all__ = [
    "ARMMWrapper",
    "CHAMELEON_7B",
    "CHAMELEON_F16",
    "ChameleonARMM",
    "ChameleonVocab",
    "GPT",
    "GPTConfig",
    "GenParams",
    "ImageCFGOptions",
    "LlamaConfig",
    "MASKGIT_IMAGENET_F16",
    "MaskGitVQConfig",
    "MaskGitVQGAN",
    "RAR",
    "RARConfig",
    "RARSampler",
    "RarARMM",
    "TAMING_GPT_1_4B",
    "TAMING_IMAGENET_F16",
    "TamingARMM",
    "TamingVQGAN",
    "VQGANConfig",
    "build_cfg_prompts",
    "gpt_forward",
    "init_gpt",
    "init_llama_params",
    "init_maskgit",
    "init_rar",
    "init_taming_vqgan",
    "llama_forward",
    "quantize_gpt_params_int8",
    "quantize_llama_params_int8",
    "quantize_rar_params_int8",
    "rar_config",
]
