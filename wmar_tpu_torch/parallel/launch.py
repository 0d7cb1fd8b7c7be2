"""Ranks on one host without a launcher: the counterpart of ``torchrun
--nproc_per_node N`` for code that starts its own ranks (``chip_smoke.py``'s
multi-rank phase, the tests).

:func:`spawn_ranks` starts ``world`` processes (the ``spawn`` method: a
CUDA context never crosses a fork), each joins a process group at
``init_method`` (``file://<path>`` or ``tcp://localhost:<port>``) and calls
``fn(rank, *args)``; it returns when all have ended and raises if one
failed (or at once, to be waited on). A rank reports back through files. CUDA tensors among the
arguments reach the ranks by CUDA IPC, as views of the caller's memory.
"""

from __future__ import annotations

import socket
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, backend: str, init_method: str, devices, args) -> None:
    if devices is not None:
        torch.cuda.set_device(devices[rank])
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, backend: str, init_method: Optional[str] = None, args: Sequence = (),
                devices: Optional[Sequence[int]] = None, join: bool = True):
    """Run ``fn(rank, *args)`` in ``world`` new processes that form one
    process group over ``backend``; ``devices[rank]``, where given, is the
    rank's card. ``init_method`` defaults to a free localhost port. With
    ``join=False`` it returns the processes' context at once, for the
    caller to work beside the ranks and then :func:`wait` (the arguments'
    CUDA tensors must live until then)."""
    init_method = init_method or f"tcp://localhost:{free_port()}"
    return mp.spawn(_rank_main, args=(fn, world, backend, init_method, devices, tuple(args)), nprocs=world,
                    join=join)


def wait(context) -> None:
    """Block until every rank of ``context`` has ended; raises if one failed."""
    while not context.join():
        pass
