"""PyTorch + CUDA port of ``wmar_tpu`` for NVIDIA Hopper (H100).

A second package beside the JAX one, with the same sub-packages and module
names. It imports torch, numpy and scipy and never JAX. The JAX package is
the reference the port's tests hold it against.

Ported so far: the RAR and the Chameleon-7B text-to-image watermarked
generate -> decode -> detect paths (``core``, ``engine``, ``ops``,
``models.rar``, ``models.maskgit_vqgan``, ``models.llama``,
``models.vqgan``, ``models.chameleon``, ``models.armm.RarARMM``,
``eval.pipeline`` without attacks), the weight bridge (``bridge``) and the
entry point ``python -m wmar_tpu_torch.generate``. Hand-written CUDA
kernels live in ``csrc/``.
"""
