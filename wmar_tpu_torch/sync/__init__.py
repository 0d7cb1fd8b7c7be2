"""Geometric synchronization (PyTorch port of ``wmar_tpu.sync``), the
serving half: what ``generate --sync`` runs.

* ``wam_logic`` / ``wam_exact``: WAM quadrant sync and the WAM model in
  ``wam_mit.pth``'s layout.
* ``syncseal`` / ``syncseal_models``: SyncSeal's embedder and extractor
  (the JAX package's Flax design and the reference's released model).
* ``homography``: the corner homography's solve, warp and unwarp.
* ``manager``: the dispatch on the checkpoint's file name.
"""

from __future__ import annotations


def load_sync_manager(path, image_size: int = 256, device=None):
    from wmar_tpu_torch.sync.manager import SyncManager

    return SyncManager.from_path(path, image_size=image_size, device=device)
