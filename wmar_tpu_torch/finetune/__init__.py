"""RCC finetuning: curriculum augmentations, idempotence loss, the trainer
(``python -m wmar_tpu_torch.finetune``)."""

from wmar_tpu_torch.finetune.rcc import (
    AUG_LEVELS,
    AugBranch,
    MaskGitRCCAdapter,
    RCCConfig,
    RCCState,
    TamingRCCAdapter,
    apply_random_augmentation,
    expand_level,
    init_state,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    make_val_step,
    validation_l0,
)

__all__ = [
    "AUG_LEVELS",
    "AugBranch",
    "MaskGitRCCAdapter",
    "RCCConfig",
    "RCCState",
    "TamingRCCAdapter",
    "apply_random_augmentation",
    "expand_level",
    "init_state",
    "make_loss_fn",
    "make_optimizer",
    "make_train_step",
    "make_val_step",
    "validation_l0",
]
