"""Neural compression attacks: the compressai zoo and the diffusers VAEs (PyTorch).

Port of ``wmar_tpu.augmentations.neural``, the counterpart of the
reference's ``wmar/augmentations/neuralcompression.py``. The compressai
families (:mod:`compressai_models`) give the reconstructions and the
likelihood-based bpp of the reference's ``compute_bpp``
(``neuralcompression.py:66-71``); the diffusers VAEs
(:mod:`diffusers_vae`, :mod:`dcae`) give their nominal bpp.

A codec with random weights destroys images rather than compressing them.
So :meth:`NeuralCompression.from_name` refuses to build one without
weights unless ``allow_random=True``; a random codec prints a loud warning
and carries ``random_weights``, which the attack manager puts on its rows.
:func:`build_codec_bank` skips a codec whose weights are missing or whose
weights file does not convert, with a message; any other error (a CUDA
error, running out of memory, a bug, in a random build too) stops the run.
A bank draws each random geometry once (:func:`shared_draws`).

Weights in ``weights_dir``: ``{name}.msgpack`` (a converted tree, as the
JAX package writes it, through the port's own msgpack reader), or
``{name}.pth`` / ``.pth.tar`` (a compressai checkpoint, converted on the
fly); the diffusers codecs read ``.safetensors`` (the port's own reader),
``.bin`` or ``.pth``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from wmar_tpu_torch.augmentations import compressai_models as cm
from wmar_tpu_torch.augmentations import geometric as G

#: the reference's 22-codec grid, in its order (augmentation_manager.py:74-97)
REFERENCE_CODEC_NAMES = [
    f"{fam}-q={q}"
    for fam in ("bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean", "mbt2018", "cheng2020-anchor",
                "cheng2020-attn")
    for q in (1, 3, 6)
] + ["diffusers-sd-vae-ft-ema", "diffusers-sd-vae-fp16", "diffusers-deep-compression", "diffusers-flux"]


# ---------------------------------------------------------------------------
# random init: the JAX package's numpy draws in its order
# ---------------------------------------------------------------------------


def _rng_conv(rng, k, i, o, groups=1):
    fan_in = i * k * k
    kern = rng.normal(0, (2.0 / fan_in) ** 0.5, size=(k, k, i, o)).astype(np.float32)
    return {"kernel": kern, "bias": np.zeros((o,), np.float32)}


def _rng_gdn(c):
    return {"beta": np.ones((c,), np.float32), "gamma_t": (0.1 * np.eye(c)).astype(np.float32)}


def _rng_eb(rng, c, filters=(3, 3, 3, 3), init_scale=10.0):
    fs = (1,) + tuple(filters) + (1,)
    scale = init_scale ** (1.0 / (len(filters) + 1))
    mats, biases, factors = [], [], []
    for i in range(len(filters) + 1):
        init = float(np.log(np.expm1(1.0 / scale / fs[i + 1])))
        mats.append(np.full((c, fs[i + 1], fs[i]), init, np.float32))
        biases.append(rng.uniform(-0.5, 0.5, size=(c, fs[i + 1], 1)).astype(np.float32))
        if i < len(filters):
            factors.append(np.zeros((c, fs[i + 1], 1), np.float32))
    q = np.tile(np.array([[-init_scale, 0.0, init_scale]], np.float32), (c, 1)).reshape(c, 1, 3)
    return {"matrices": mats, "biases": biases, "factors": factors, "quantiles": q}


def _rng_ga(rng, n, m):
    return [_rng_conv(rng, 5, 3, n), _rng_gdn(n), _rng_conv(rng, 5, n, n), _rng_gdn(n), _rng_conv(rng, 5, n, n),
            _rng_gdn(n), _rng_conv(rng, 5, n, m)]


def _rng_gs(rng, n, m):
    return [_rng_conv(rng, 5, m, n), _rng_gdn(n), _rng_conv(rng, 5, n, n), _rng_gdn(n), _rng_conv(rng, 5, n, n),
            _rng_gdn(n), _rng_conv(rng, 5, n, 3)]


def _rng_rb(rng, i, o):
    p = {"conv1": _rng_conv(rng, 3, i, o), "conv2": _rng_conv(rng, 3, o, o)}
    if i != o:
        p["skip"] = _rng_conv(rng, 1, i, o)
    return p


def _rng_rbs(rng, i, o):
    return {"conv1": _rng_conv(rng, 3, i, o), "conv2": _rng_conv(rng, 3, o, o), "gdn": _rng_gdn(o),
            "skip": _rng_conv(rng, 1, i, o)}


def _rng_rbu(rng, i, o, r=2):
    return {"subpel": _rng_conv(rng, 3, i, o * r * r), "conv": _rng_conv(rng, 3, o, o), "igdn": _rng_gdn(o),
            "upsample": _rng_conv(rng, 3, i, o * r * r)}


def _rng_attn(rng, n):
    def unit():
        return {"conv1": _rng_conv(rng, 1, n, n // 2), "conv2": _rng_conv(rng, 3, n // 2, n // 2),
                "conv3": _rng_conv(rng, 1, n // 2, n)}

    return {"conv_a": [unit() for _ in range(3)], "conv_b": [unit() for _ in range(3)] + [_rng_conv(rng, 1, n, n)]}


def init_compressai_params(seed: int, arch: str, n: int, m: int) -> dict:
    """Random parameters in ``convert_compressai``'s layout (the JAX
    package's draws: the same seed gives the same tree)."""
    rng = np.random.default_rng(seed)
    if arch == "bmshj2018-factorized":
        return {"g_a": _rng_ga(rng, n, m), "g_s": _rng_gs(rng, n, m), "eb": _rng_eb(rng, m)}
    if arch == "bmshj2018-hyperprior":
        return {
            "g_a": _rng_ga(rng, n, m), "g_s": _rng_gs(rng, n, m),
            "h_a": [_rng_conv(rng, 3, m, n), _rng_conv(rng, 5, n, n), _rng_conv(rng, 5, n, n)],
            "h_s": [_rng_conv(rng, 5, n, n), _rng_conv(rng, 5, n, n), _rng_conv(rng, 3, n, m)],
            "eb": _rng_eb(rng, n),
        }
    if arch in ("mbt2018-mean", "mbt2018"):
        p = {
            "g_a": _rng_ga(rng, n, m), "g_s": _rng_gs(rng, n, m),
            "h_a": [_rng_conv(rng, 3, m, n), _rng_conv(rng, 5, n, n), _rng_conv(rng, 5, n, n)],
            "h_s": [_rng_conv(rng, 5, n, m), _rng_conv(rng, 5, m, m * 3 // 2), _rng_conv(rng, 3, m * 3 // 2, 2 * m)],
            "eb": _rng_eb(rng, n),
        }
        if arch == "mbt2018":
            p["context_prediction"] = _rng_conv(rng, 5, m, 2 * m)
            p["entropy_parameters"] = [_rng_conv(rng, 1, m * 4, m * 10 // 3),
                                       _rng_conv(rng, 1, m * 10 // 3, m * 8 // 3),
                                       _rng_conv(rng, 1, m * 8 // 3, m * 2)]
        return p
    if arch in ("cheng2020-anchor", "cheng2020-attn"):
        attn = arch == "cheng2020-attn"
        g_a = [_rng_rbs(rng, 3, n), _rng_rb(rng, n, n), _rng_rbs(rng, n, n)]
        if attn:
            g_a.append(_rng_attn(rng, n))
        g_a += [_rng_rb(rng, n, n), _rng_rbs(rng, n, n), _rng_rb(rng, n, n), _rng_conv(rng, 3, n, n)]
        if attn:
            g_a.append(_rng_attn(rng, n))
        g_s = [_rng_attn(rng, n)] if attn else []
        g_s += [_rng_rb(rng, n, n), _rng_rbu(rng, n, n), _rng_rb(rng, n, n), _rng_rbu(rng, n, n)]
        if attn:
            g_s.append(_rng_attn(rng, n))
        g_s += [_rng_rb(rng, n, n), _rng_rbu(rng, n, n), _rng_rb(rng, n, n), _rng_conv(rng, 3, n, 3 * 4)]
        return {
            "g_a": g_a, "g_s": g_s,
            "h_a": [_rng_conv(rng, 3, n, n)] * 2 + [_rng_conv(rng, 3, n, n)] * 3,
            "h_s": [_rng_conv(rng, 3, n, n), _rng_conv(rng, 3, n, n * 4), _rng_conv(rng, 3, n, n * 3 // 2),
                    _rng_conv(rng, 3, n * 3 // 2, n * 3 // 2 * 4), _rng_conv(rng, 3, n * 3 // 2, n * 2)],
            "context_prediction": _rng_conv(rng, 5, n, 2 * n),
            "entropy_parameters": [_rng_conv(rng, 1, n * 4, n * 10 // 3), _rng_conv(rng, 1, n * 10 // 3, n * 8 // 3),
                                   _rng_conv(rng, 1, n * 8 // 3, n * 2)],
            "eb": _rng_eb(rng, n),
        }
    raise ValueError(arch)


# ---------------------------------------------------------------------------
# the attack
# ---------------------------------------------------------------------------


class RandomWeightsError(RuntimeError):
    """Raised when a pretrained codec is requested but no weights exist."""


class CheckpointLayoutError(RuntimeError):
    """Raised when a weights file's layout is one the converter or the
    bridge does not know (their ``KeyError`` or ``ValueError``)."""


@contextlib.contextmanager
def layout_errors(path: str):
    """Around the loading and conversion of the weights file ``path`` only:
    its ``KeyError`` / ``ValueError`` becomes :class:`CheckpointLayoutError`,
    which :func:`build_codec_bank` skips. The same errors from a random
    build are bugs and stay as they are."""
    try:
        yield
    except (KeyError, ValueError) as e:
        raise CheckpointLayoutError(f"{path}: {type(e).__name__}: {e}") from e


class NeuralCompression:
    """The attack ``imgs01 [B, H, W, 3] -> compressed imgs01`` of a compressai
    codec, as the reference's wrapper (``neuralcompression.py:54-116``):
    non-factorized inputs are resized to a multiple of 64 (at least 64), the
    codec round-trips them, the result is resized back and clamped to
    [0, 1]; ``return_bpp`` also gives the exact likelihood-based bits per
    pixel. The codec is deterministic: ``generator`` (the attack cell's) is
    taken as every attack takes it and draws nothing."""

    def __init__(self, name: str, model: torch.nn.Module, random_weights: bool = False):
        self.name = name
        self.model = model.eval()
        self.random_weights = random_weights

    @torch.inference_mode()
    def __call__(self, imgs01: torch.Tensor, generator: Optional[torch.Generator] = None, return_bpp: bool = False):
        b, h, w, _ = imgs01.shape
        needs_64 = not self.name.startswith("bmshj2018-factorized")
        h64 = max((h // 64) * 64, 64) if needs_64 else h
        w64 = max((w // 64) * 64, 64) if needs_64 else w
        x = imgs01.float()
        if (h64, w64) != (h, w):
            x = G.resize_linear(x, (h64, w64))
        rec, liks = self.model(x.permute(0, 3, 1, 2))
        rec = rec.permute(0, 2, 3, 1)
        if rec.shape != imgs01.shape:
            rec = G.resize_linear(rec, (h, w))
        rec = torch.clamp(rec, 0.0, 1.0)
        if return_bpp:
            return rec, cm.bpp_from_likelihoods(liks, b * h64 * w64)
        return rec

    def __repr__(self):
        tag = " (RANDOM WEIGHTS)" if self.random_weights else ""
        return f"NeuralCompression({self.name}{tag})"

    @staticmethod
    def from_name(name: str, weights_dir: Optional[str] = None, allow_random: bool = False, device="cpu"):
        """A codec by the reference's name (``cheng2020-anchor-q=3``,
        ``diffusers-flux``, ...) on ``device``. Without weights in
        ``weights_dir`` this raises :class:`RandomWeightsError` unless
        ``allow_random``: a random codec is not a compression attack."""
        from wmar_tpu_torch import bridge

        if name.startswith("diffusers"):
            from wmar_tpu_torch.augmentations.diffusers_vae import DiffusersCompression

            return DiffusersCompression.from_name(name, weights_dir=weights_dir, allow_random=allow_random,
                                                  device=device)
        arch, q = cm.parse_codec_name(name)
        if arch not in cm.FORWARDS:
            raise ValueError(f"unknown codec {name}")
        path = _codec_weights_file(name, weights_dir)
        if path is not None:
            with layout_errors(path):
                model = bridge.load_compressai(arch, _load_codec_weights(path, arch, q), device)
            return NeuralCompression(name, model)
        if not allow_random:
            raise RandomWeightsError(
                f"no weights for codec '{name}' in {weights_dir!r}; a random-weight codec destroys images instead "
                "of compressing them. Provide --nc_weights_dir with converted checkpoints, or pass "
                "allow_random=True to acknowledge.")
        n, m = cm.quality_nm(arch, q or 3)
        print(f"WARNING: codec {name} running with RANDOM weights — its rows measure destruction, not compression.")
        tree = random_tree(("compressai", arch, n, m), lambda: init_compressai_params(0, arch, n, m))
        return NeuralCompression(name, bridge.load_compressai(arch, tree, device), random_weights=True)


_DRAWS: Optional[dict] = None


@contextlib.contextmanager
def shared_draws():
    """Within the block, :func:`random_tree` draws each random geometry
    once: the bank's random codecs all come from seed 0, so q=1 and q=3 of
    a compressai family, or SD-VAE and SDXL, are the same tree."""
    global _DRAWS
    outer = _DRAWS
    _DRAWS = {} if outer is None else outer
    try:
        yield
    finally:
        _DRAWS = outer


def random_tree(key, draw):
    """``draw()``, or inside :func:`shared_draws` the tree already drawn for
    ``key`` (its geometry). The loaders copy the tree, so sharing it is safe."""
    if _DRAWS is None:
        return draw()
    if key not in _DRAWS:
        _DRAWS[key] = draw()
    return _DRAWS[key]


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's state dict as float32 / integer numpy arrays, read by
    :func:`wmar_tpu_torch.utils.convert.load_torch_state_dict` with
    ``weights_only=True``: the codecs' files are third-party plain state
    dicts, so a pickle that would run code is refused, not unpickled."""
    from wmar_tpu_torch.utils.convert import load_torch_state_dict

    sd = load_torch_state_dict(path, weights_only=True)
    return {k: (v.float() if v.is_floating_point() else v).numpy() for k, v in sd.items()}


def _codec_weights_file(name: str, weights_dir: Optional[str]) -> Optional[str]:
    """``{name}.msgpack``, ``.pth`` or ``.pth.tar`` in ``weights_dir``, the first that exists."""
    for ext in (".msgpack", ".pth", ".pth.tar"):
        path = os.path.join(weights_dir, name + ext) if weights_dir else None
        if path and os.path.exists(path):
            return path
    return None


def _load_codec_weights(path: str, arch: str, q: Optional[int]) -> dict:
    """The parameter tree of a converted ``.msgpack`` (through the port's
    reader) or of a compressai checkpoint (through ``convert_compressai``)."""
    if path.endswith(".msgpack"):
        from wmar_tpu_torch.utils.checkpoint import load_pytree

        n, m = cm.quality_nm(arch, q or 3)
        return load_pytree(path, init_compressai_params(0, arch, n, m))
    return cm.convert_compressai(read_state_dict(path), arch)


def build_codec_bank(names=None, weights_dir: Optional[str] = None, allow_random: bool = False,
                     device="cpu") -> Dict[str, object]:
    """The reference's 22-codec bank (or ``names``) on ``device``. A codec
    without weights (:class:`RandomWeightsError`) or whose weights file
    does not convert (:class:`CheckpointLayoutError`) is skipped with a
    message rather than registered at random; any other error, a random
    build's included, stops the run."""
    bank = {}
    with shared_draws():
        for name in names or REFERENCE_CODEC_NAMES:
            try:
                bank[name] = NeuralCompression.from_name(name, weights_dir=weights_dir, allow_random=allow_random,
                                                         device=device)
            except (RandomWeightsError, CheckpointLayoutError) as e:
                print(f"skipping codec {name}: {type(e).__name__}: {e}")
    return bank
