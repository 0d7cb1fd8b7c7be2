"""Parameter-tree files and the reference's weight-delta format (PyTorch
port of ``wmar_tpu.utils.checkpoint``).

The reference publishes RCC finetune results as deltas against the frozen
originals and adds them back at load time (``wmar/utils/utils.py:47-66``).
Files are flax msgpack, written and read by the port's own codec
(:mod:`wmar_tpu_torch.utils.msgpack_codec`): a file written here reads back
with ``flax.serialization.from_bytes``, and a file flax wrote reads here.

A tree is nested dicts (and lists) of tensors; numpy arrays are taken too.
:func:`save_pytree` writes what ``flax.serialization.to_bytes(jax.device_get
(tree))`` writes: dict keys sorted, a list as a map ``{"0": ..., "1": ...}``
in index order. Deltas are computed and added in float32 and cast back to
the target leaf's dtype, so ``orig + (new - orig)`` equals ``new`` within
float32 rounding (a few ulps of ``max |w|``), not bit for bit.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from wmar_tpu_torch.bridge import to_tensor
from wmar_tpu_torch.utils import msgpack_codec


def to_state_dict(tree: Any) -> Any:
    """The tree as flax's ``to_state_dict(jax.device_get(tree))`` sees it:
    dicts with their keys as strings in sorted order, lists and tuples as
    maps ``{"0": ...}`` in index order, numpy scalars as 0-d arrays; other
    leaves unchanged."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return np.asarray(tree) if isinstance(tree, np.generic) else tree


def to_bytes(tree: Any) -> bytes:
    return msgpack_codec.serialize(to_state_dict(tree), sort_keys=False)


def save_pytree(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(to_bytes(tree))


def _like(like: Any, state: Any, path: str, dtypes: bool) -> Any:
    if isinstance(like, dict):
        if not isinstance(state, dict) or set(map(str, like)) != set(state):
            raise ValueError(f"{path or '/'}: keys {sorted(state) if isinstance(state, dict) else type(state)} "
                             f"!= {sorted(map(str, like))}")
        return {k: _like(v, state[str(k)], f"{path}/{k}", dtypes) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(state, dict) or set(state) != {str(i) for i in range(len(like))}:
            raise ValueError(f"{path or '/'}: a list of {len(like)} against {type(state).__name__}")
        return type(like)(_like(v, state[str(i)], f"{path}/{i}", dtypes) for i, v in enumerate(like))
    if isinstance(like, (torch.Tensor, np.ndarray)) or hasattr(like, "shape"):
        want = to_tensor(like)
        if not isinstance(state, torch.Tensor):
            raise ValueError(f"{path}: {type(state).__name__} where an array of {tuple(want.shape)} belongs")
        if tuple(state.shape) != tuple(want.shape):
            raise ValueError(f"{path}: shape {tuple(state.shape)} != {tuple(want.shape)}")
        if dtypes and state.dtype != want.dtype:
            raise ValueError(f"{path}: dtype {state.dtype} != {want.dtype}")
    return state


def load_pytree(path: str, like: Any = None, dtypes: bool = True) -> Any:
    """The tree in ``path`` (maps as dicts). Given ``like``, its structure
    (lists come back as lists) with every leaf's shape, and dtype unless
    ``dtypes=False``, checked against ``like``'s."""
    size = os.path.getsize(path)
    buf = bytearray(size)  # writable, so tensors can be made over its slices
    with open(path, "rb") as f:
        if f.readinto(buf) != size:
            raise IOError(f"short read of {path}")
    state = msgpack_codec.restore(buf)
    return state if like is None else _like(like, state, "", dtypes)


def _map2(fn, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        if set(a) != set(b):
            raise ValueError(f"trees differ: {sorted(a)} against {sorted(b)}")
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b, strict=True))
    return fn(to_tensor(a), to_tensor(b))


def compute_delta(new_tree: Any, orig_tree: Any) -> Any:
    """new - orig per leaf, in float32 (the published artifact format)."""
    return _map2(lambda a, b: a.float() - b.to(a.device).float(), new_tree, orig_tree)


def apply_delta(orig_tree: Any, delta_tree: Any) -> Any:
    """orig + delta per leaf, added in float32 and cast to orig's dtype
    (reference ``update_weights(delta=True)``)."""
    return _map2(lambda a, d: (a.float() + d.to(a.device).float()).to(a.dtype), orig_tree, delta_tree)


def save_delta(path: str, new_tree: Any, orig_tree: Any) -> None:
    save_pytree(path, compute_delta(new_tree, orig_tree))


def load_and_apply_delta(path: str, orig_tree: Any) -> Any:
    """``orig_tree`` plus the delta in ``path`` (its shapes checked)."""
    return apply_delta(orig_tree, load_pytree(path, like=orig_tree, dtypes=False))
