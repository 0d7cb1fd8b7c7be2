"""SyncManager: dispatch between WAM and SyncSeal synchronization (PyTorch
port of ``wmar_tpu.sync.manager``).

As the reference (``wmar/watermarking/synchronization.py:386-409``), the
checkpoint's file name picks the model: "wam" -> WAM quadrant sync (the
file is required), "sync" with ``.pt``/``.pth``/``.safetensors`` -> the
released SyncSeal, any other "sync" file -> the Flax design's msgpack;
``add_sync`` / ``remove_sync`` log their time.
"""

from __future__ import annotations

import os
import time

import torch

from wmar_tpu_torch.sync.wam_logic import WamSync
from wmar_tpu_torch.utils.convert import read_safetensors  # noqa: F401  (still importable from here)


class SyncManager:
    def __init__(self, impl, log_fn=None):
        self.impl = impl
        self.log_fn = log_fn or (lambda *_: None)

    @staticmethod
    def from_path(path, embedder=None, image_size: int = 256, device=None) -> "SyncManager":
        """The manager of the checkpoint ``path`` on ``device``; ``embedder``
        stands in for WAM's pixel watermark."""
        device = torch.device(device) if device is not None else torch.device("cuda")
        if path is None or "wam" in path.lower():
            if embedder is None:
                if path is None or not os.path.exists(path):
                    raise ValueError("WAM sync needs the wam_mit.pth checkpoint (path not found: "
                                     f"{path!r}) or a custom embedder")
                from wmar_tpu_torch.sync.wam_exact import WamExact

                embedder = WamExact.load(path, device=device)
            return SyncManager(WamSync(embedder, image_size=image_size))
        if "sync" in path.lower():
            if path.endswith((".pt", ".pth", ".safetensors")):
                from wmar_tpu_torch.sync.syncseal import SyncSealRef

                return SyncManager(SyncSealRef.load_torch(path, device=device))
            from wmar_tpu_torch.sync.syncseal import SyncSealModel

            return SyncManager(SyncSealModel.load(path, device=device))
        raise ValueError(f"Cannot infer sync model type from path: {path}")

    def add_sync(self, imgs):
        t0 = time.time()
        out = self.impl.add_sync(imgs.float())  # the sync models run in float32
        self.log_fn(f"add_sync time: {time.time() - t0:.2f}s")
        return out

    def remove_sync(self, imgs):
        t0 = time.time()
        out = self.impl.remove_sync(imgs.float())  # the sync models run in float32
        self.log_fn(f"remove_sync time: {time.time() - t0:.2f}s")
        return out
