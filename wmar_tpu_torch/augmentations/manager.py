"""The attack registry of the robustness evaluation (PyTorch).

Port of ``wmar_tpu.augmentations.manager``: the reference's seven classic
attacks with their parameter grids, copied as they are (62 cells), so the
result trees and the analyzer line up with the reference and with the JAX
package letter for letter (ints stay ints: brightness ``1``, rotation
``0``). Each attack is ``fn(imgs_01, param, generator) -> imgs_01`` over
NHWC float images on their own device; only gaussian noise draws from the
generator. ``exact_jpeg`` swaps the device JPEG for PIL's on the host.

A bank of codecs (``nc_models``, from ``neural.build_codec_bank``) adds
the reference's "neural-compress" attack, one cell per codec name; each call writes the codec's exact bpp into ``row_tags``,
and a random-weight codec's rows carry ``random_weights``. Unlike the JAX
package's manager, the cell's generator reaches the codec, so a KL-VAE
draws fresh posterior noise in each cell and batch (ROADMAP queue 3, fault
(h)). The DiffPure slot is not ported (ROADMAP queue 1, item 12b).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from wmar_tpu_torch.augmentations import geometric as G
from wmar_tpu_torch.augmentations import valuemetric as V

AugFn = Callable[[torch.Tensor, object, torch.Generator], torch.Tensor]
AugEntry = Tuple[str, AugFn, Sequence[object]]


def _no_rng(fn):
    return lambda imgs, param, generator: fn(imgs, param)


def make_jpeg_fn(exact_pil: bool) -> AugFn:
    if exact_pil:
        return lambda imgs, q, generator: V.jpeg_pil(imgs, int(q))
    return lambda imgs, q, generator: V.jpeg_diff(imgs, int(q))


class AugmentationManager:
    """The reference's attack registry, without DiffPure.

    Args:
      exact_jpeg: PIL's JPEG on the host instead of the device JPEG.
      nc_models: name -> codec; each name, sorted, is a "neural-compress"
        cell (none without codecs).
    """

    def __init__(self, exact_jpeg: bool = False, nc_models: Optional[dict] = None):
        self.augs: List[AugEntry] = [
            ("gaussian-blur", _no_rng(lambda x, k: V.gaussian_blur(x, int(k))),
             [0, 1, 3, 5, 7, 9, 11, 13, 15, 17, 19]),
            ("gaussian-noise", lambda x, s, generator: V.gaussian_noise(x, float(s), generator=generator),
             [0, 0.025, 0.05, 0.075, 0.1, 0.125, 0.15, 0.175, 0.2]),
            ("jpeg", make_jpeg_fn(exact_jpeg),
             [100, 95, 85, 75, 65, 55, 45, 35, 25, 15, 5]),
            ("brightness", _no_rng(lambda x, f: V.brightness(x, float(f))),
             [1, 1.25, 1.5, 1.75, 2, 2.25, 2.5, 2.75, 3]),
            ("rotation", _no_rng(lambda x, a: G.rotate(x, float(a))),
             [-20, -15, -10, -5, 0, 5, 10, 15, 20]),
            ("flip-h", _no_rng(lambda x, do: G.hflip(x) if do else x), [0, 1]),
            ("upperleft-crop", _no_rng(lambda x, f: G.upper_left_crop_resize_back(x, float(f))),
             [1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7, 0.65, 0.6, 0.55, 0.5]),
        ]
        self.exact_jpeg = exact_jpeg
        self.compressors = nc_models or {}
        #: (transform, param) -> extra fields merged into the result records
        #: (a codec's bpp; random-weight codecs' rows, so they cannot pass as real attacks)
        self.row_tags: Dict[tuple, dict] = {}
        if self.compressors:
            self.augs.append(("neural-compress", self._run_codec, sorted(self.compressors)))
            for name, codec in self.compressors.items():
                if codec.random_weights:
                    self.row_tags[("neural-compress", name)] = {"random_weights": True}

    def _run_codec(self, x, name, generator):
        """One codec on the cell's generator; its exact bpp goes to
        ``row_tags``, so the analyzer's TPR-against-bpp axis has the rate."""
        rec, bpp = self.compressors[name](x, generator=generator, return_bpp=True)
        self.row_tags.setdefault(("neural-compress", name), {})["bpp"] = float(bpp)
        return rec

    def names(self) -> List[str]:
        return [name for name, _, _ in self.augs]
