"""Passive geometric synchronization through quadrant watermark messages
(PyTorch port of ``wmar_tpu.sync.wam_logic``; the reference's ``WamSync``,
``wmar/watermarking/synchronization.py:23-340``).

Four distinct 32-bit messages go into the image quadrants (with a cleared
centre band). At detection each pixel is assigned its nearest message, the
(rotation, horizontal cut, vertical cut, flip) that best explains the
quadrant map is found by brute force, and that transform is undone before
re-tokenization. The pixel watermark is pluggable (``embedder``: WAM, or a
mock in tests). The per-pixel assignment runs on the images' device; the
fit is host numpy over label maps (41 rotations), as in the reference, and
``remove_sync`` goes image by image with one device -> host copy each.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def quadrant_messages() -> np.ndarray:
    """The 4 fixed 32-bit messages (``synchronization.py:33-40``)."""
    return np.asarray([[0] * 32, [0] * 16 + [1] * 16, [1] * 16 + [0] * 16, [1] * 32], dtype=np.int32)


def create_grid_mask(size: int) -> np.ndarray:
    """4 quadrant masks ``[4, H, W]`` with a cleared centre band (18 px at
    256, 36 px otherwise; ``synchronization.py:65-88``)."""
    masks = np.zeros((4, size, size), dtype=np.float32)
    half = size // 2
    for i in range(2):
        for j in range(2):
            masks[i * 2 + j, i * half:(i + 1) * half, j * half:(j + 1) * half] = 1.0
    leeway = 18 if size == 256 else 36
    start = size // 2 - leeway // 2
    end = size // 2 + leeway // 2 + 1
    masks[:, :, start:end] = 0
    masks[:, start:end, :] = 0
    return masks


def positions_from_predictions(mask_logits: torch.Tensor, bit_logits: torch.Tensor, messages: torch.Tensor,
                               clip_dist: int = 6) -> torch.Tensor:
    """Per-pixel nearest message: ``mask_logits [H, W]``, ``bit_logits [32,
    H, W]``, ``messages [4, 32]`` -> ``[H, W]`` int32 in {-1, 0, 1, 2, 3}
    (-1 unassigned): Hamming distance <= ``clip_dist`` and a mask
    probability > 0.5 (``:203-266``); ties go to the lowest message."""
    bits = (bit_logits > 0).to(torch.int32)
    diffs = (bits[None] != messages.to(bits.device)[:, :, None, None]).sum(dim=1)  # [4, H, W]
    min_idx = torch.argmin(diffs, dim=0)  # the first minimum, as jnp.argmin
    min_dist = diffs.min(dim=0).values
    ok = (min_dist <= clip_dist) & (torch.sigmoid(mask_logits.float()) > 0.5)
    return torch.where(ok, min_idx, -1).to(torch.int32)


def _rotate_labels(wm: np.ndarray, rotation: float) -> np.ndarray:
    """Rotate a label map one binary mask per label (no mixing of labels)."""
    from scipy import ndimage

    res = np.zeros_like(wm)
    for i in range(1, 5):
        mask_rot = ndimage.rotate((wm == i) * 255.0, rotation, reshape=False)
        res[mask_rot >= 0.5] = i
    return res


def _find_cut(cumsums, pairs, allow_flip: bool, size: int):
    """Best 1-D boundary separating each (left label, right label) pair:
    ``synchronization.py:99-157`` with its tie-midpoint rule, its endpoint
    rule for a one-sided pair and its weighting by component size."""
    cut_acc = 0.0
    weight = 0.0
    flip_votes = 0.0
    for l, r in pairs:
        cl, cr = cumsums[l], cumsums[r]
        errors_normal = cr + (cl[-1] - cl)
        errors_flipped = cl + (cr[-1] - cr)

        def score(err):
            m = err.min()
            idxs = np.flatnonzero(err == m)
            return m - len(idxs) * 1e-3, idxs

        s_n, idx_n = score(errors_normal)
        s_f, idx_f = score(errors_flipped)
        if s_n < s_f or not allow_flip:
            is_flipped, idxs = False, idx_n
            flip_votes -= cl[-1] + cr[-1]
        else:
            is_flipped, idxs = True, idx_f
            flip_votes += cl[-1] + cr[-1]
        if cr[-1] != 0 and cl[-1] == 0:
            pick = idxs[0] if is_flipped else idxs[-1]
        elif cl[-1] != 0 and cr[-1] == 0:
            pick = idxs[-1] if is_flipped else idxs[0]
        else:
            pick = (idxs[0] + idxs[-1]) // 2
        w = cl[-1] + cr[-1]
        cut_acc += pick * w
        weight += w
    if weight == 0:
        return 1e9, size // 2, False
    cut = round(cut_acc / weight)
    flipped = (flip_votes / weight) > 0
    # the error at the averaged cut
    error = 0.0
    for l, r in pairs:
        cl, cr = cumsums[l], cumsums[r]
        err = (cl + (cr[-1] - cr)) if flipped else (cr + (cl[-1] - cl))
        error += err[cut]
    return error, int(cut), bool(flipped)


def fit_best_aug(positions: np.ndarray) -> Tuple[int, int, int, bool]:
    """Brute-force (rotation, cut_i, cut_j, flip) over rotations -20..20
    (``synchronization.py:99-201``). ``positions``: [H, W] in {-1..3}."""
    size = positions.shape[-1]
    wm = positions.astype(np.int32) + 1  # labels 1..4, 0 unassigned
    thresh = max(1, size * 40 // 256)  # the reference's 40 at 256, 80 at 512
    best = (float("inf"), [0], size // 2, size // 2, False)
    for rotation in range(-20, 21):
        wm_rot = _rotate_labels(wm, rotation) if rotation != 0 else wm
        cums = [{}, {}]
        for dim in range(2):
            for lab in range(1, 5):
                sums = (wm_rot == lab).sum(axis=dim)
                cums[dim][lab] = np.cumsum(np.where(sums < thresh, 0, sums))
        # per-row counts: the horizontal boundary between (1, 3) and (2, 4)
        err_i, cut_i, _ = _find_cut(cums[1], [(1, 3), (2, 4)], allow_flip=False, size=size)
        # per-column counts: the vertical boundary; a flip swaps the pairs
        err_j, cut_j, flipped = _find_cut(cums[0], [(1, 2), (3, 4)], allow_flip=True, size=size)
        err = err_i + err_j
        if err < best[0]:
            best = (err, [rotation], cut_i, cut_j, flipped)
        elif err == best[0]:
            best[1].append(rotation)
    rotations = best[1]
    return round((max(rotations) + min(rotations)) / 2), best[2], best[3], best[4]


def revert_augmentation(img01: torch.Tensor, aug_info, pad_thresh: Optional[int] = None) -> torch.Tensor:
    """Undo the estimated transform on NHWC [0, 1] images
    (``synchronization.py:268-296``): the flip, else the rotation (|angle|
    >= 3), else the crop (pad bottom and right, resize back)."""
    from wmar_tpu_torch.augmentations import geometric as G

    angle, cut_i, cut_j, flipped = aug_info
    h, w = img01.shape[1:3]
    if flipped:
        return G.hflip(img01)
    if abs(angle) >= 3:
        return G.rotate(img01, float(angle))
    pad_thresh = pad_thresh if pad_thresh is not None else (10 if h == 256 else 25)
    pad_i = 2 * int(cut_i) - h
    pad_i = 0 if pad_i < pad_thresh else pad_i
    pad_j = max(0, 2 * int(cut_j) - w)
    pad_j = 0 if pad_j < pad_thresh else pad_j
    if pad_i > 0 or pad_j > 0:
        img01 = G.resize_linear(F.pad(img01, (0, 0, 0, pad_j, 0, pad_i)), (h, w))
    return img01


@dataclasses.dataclass
class SyncConfidence:
    """When to trust the detector (``:238-252``); ``coverage`` overrides
    the reference's size rule (0.7 at 256, 0.75 otherwise)."""

    clip_dist: int = 6
    coverage: Optional[float] = None

    def min_coverage(self, size: int) -> float:
        if self.coverage is not None:
            return self.coverage
        return 0.7 if size == 256 else 0.75


class WamSync:
    """Quadrant-message synchronization over a pluggable pixel watermark;
    ``embedder`` provides

      embed(img01 [B, H, W, 3], msg [B, 32]) -> watermarked img01
      detect(img01 [B, H, W, 3]) -> [B, 33, H, W] logits (mask + 32 bits)
    """

    def __init__(self, embedder, image_size: int = 256, conf: Optional[SyncConfidence] = None):
        self.embedder = embedder
        self.image_size = image_size
        self.messages = quadrant_messages()
        self.masks = create_grid_mask(image_size)
        self.conf = conf or SyncConfidence()

    @torch.no_grad()
    def add_sync(self, imgs: torch.Tensor) -> torch.Tensor:
        """NHWC [-1, 1] -> synced NHWC [-1, 1]."""
        img01 = (imgs + 1.0) / 2.0
        out = img01
        b = imgs.shape[0]
        for k in range(4):
            msg = torch.as_tensor(np.tile(self.messages[k][None], (b, 1)), device=imgs.device)
            wm = self.embedder.embed(img01, msg)
            m = torch.as_tensor(self.masks[k], device=imgs.device)[None, :, :, None]
            out = wm * m + out * (1.0 - m)
        return torch.clamp(out * 2.0 - 1.0, -1.0, 1.0)

    @torch.no_grad()
    def estimate(self, img01_row: torch.Tensor):
        """One HWC image -> (aug_info, positions): the assignment on the
        device, the fit on the host."""
        preds = torch.as_tensor(self.embedder.detect(img01_row[None]))[0]  # [33, H, W]
        positions = positions_from_predictions(preds[0], preds[1:], torch.as_tensor(self.messages),
                                               self.conf.clip_dist)
        pos_np = positions.cpu().numpy()
        h, w = pos_np.shape
        coverage = (pos_np >= 0).sum() / (h * w)
        if coverage < self.conf.min_coverage(h):
            return (0, h // 2, w // 2, False), pos_np  # not confident: no-op
        return fit_best_aug(pos_np), pos_np

    @torch.no_grad()
    def remove_sync(self, imgs: torch.Tensor) -> torch.Tensor:
        """NHWC [-1, 1] -> geometry-reverted NHWC [-1, 1], image by image."""
        img01 = (imgs + 1.0) / 2.0
        out = [revert_augmentation(img01[i][None], self.estimate(img01[i])[0])[0] for i in range(imgs.shape[0])]
        return torch.clamp(torch.stack(out) * 2.0 - 1.0, -1.0, 1.0)
