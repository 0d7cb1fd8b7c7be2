"""PyTorch + CUDA port of ``wmar_tpu`` for NVIDIA Hopper (H100).

A second package beside the JAX one, with the same sub-packages and module
names. It imports torch, numpy and scipy and never JAX. The JAX package is
the reference the port's tests hold it against.

Ported so far: the RAR, Taming and Chameleon-7B (text-to-image and
interleaved) watermarked generate -> decode -> attack -> detect paths
(``core`` with every greenlist source, ``engine``, ``ops``, ``models``,
``augmentations`` with the classic attack grid, ``eval.pipeline`` without
sync, ``eval.analyzer``), RCC tokenizer finetuning (``finetune``, ``python
-m wmar_tpu_torch.finetune``), the flax checkpoint and delta format
(``utils.checkpoint`` over the port's own msgpack codec), the weight bridge
(``bridge``) and the entry points ``python -m wmar_tpu_torch.generate`` and
``python -m wmar_tpu_torch.precompute_imagenet_codes``. Hand-written CUDA
kernels live in ``csrc/``.
"""
