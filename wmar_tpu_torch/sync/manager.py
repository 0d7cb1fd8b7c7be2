"""SyncManager: dispatch between WAM and SyncSeal synchronization (PyTorch
port of ``wmar_tpu.sync.manager``).

As the reference (``wmar/watermarking/synchronization.py:386-409``), the
checkpoint's file name picks the model: "wam" -> WAM quadrant sync (the
file is required), "sync" with ``.pt``/``.pth``/``.safetensors`` -> the
released SyncSeal, any other "sync" file -> the Flax design's msgpack;
``add_sync`` / ``remove_sync`` log their time.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch

from wmar_tpu_torch.sync.wam_logic import WamSync

# safetensors dtype names -> numpy (BF16 goes through int16 -> torch.bfloat16)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.int16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as tensors: an 8-byte little-endian header
    length, a JSON header (name -> dtype, shape, byte offsets into the
    data that follows), then the raw little-endian buffers."""
    with open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dt = info["dtype"]
        if dt not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {dt}, which the reader does not know")
        dtype = np.dtype(_ST_DTYPES[dt]).newbyteorder("<")
        arr = np.frombuffer(data, dtype, count=(end - begin) // dtype.itemsize, offset=base + begin)
        t = torch.from_numpy(arr.astype(dtype.newbyteorder("="))).reshape(info["shape"])
        out[name] = t.view(torch.bfloat16) if dt == "BF16" else t
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict on the CPU: ``.safetensors`` through
    :func:`read_safetensors`, else ``torch.load`` of a pickle (unwrapping
    ``state_dict`` / ``model``), else a TorchScript archive's state dict."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    except RuntimeError:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    if not isinstance(sd, dict):  # a scripted or eager module
        sd = sd.state_dict()
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k: torch.as_tensor(v) for k, v in sd.items()}


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
