"""Process-group initialisation and cross-rank metric reduction
(counterpart of ``tile_match_tpu.parallel.distributed``).

The env batch is rank-local (independent boards: no traffic on the step
path); the process group joins the ranks so that a sharded learner and the
reduced metrics span them.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

# every group's collective timeout: a rank that dies leaves the others
# waiting in a collective at most this long
TIMEOUT = datetime.timedelta(seconds=60)


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> bool:
    """Join this process to the default process group.

    Arguments left out come from torchrun's variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``coordinator_address`` "host:port"), ``WORLD_SIZE``,
    ``RANK``; ``LOCAL_RANK`` picks the card, ``cuda:LOCAL_RANK %
    device_count``.  Returns False, and does nothing, for a single process
    with none of them set.  ``backend``: ``"nccl"`` where a card is present,
    ``"gloo"`` on the CPU by default (two ranks sharing one card need
    ``"gloo"``: NCCL refuses two ranks on one device).
    """
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    num_processes = num_processes or _int_env("WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("RANK")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_distributed needs the coordinator's address, the number of "
            f"processes and this process's rank; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}"
        )
    if torch.cuda.is_available():
        local = _int_env("LOCAL_RANK")
        torch.cuda.set_device((process_id if local is None else local) % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=TIMEOUT,
    )
    return True


def all_hosts_mean(x, group=None):
    """Mean of a rank-local tensor over the ranks of ``group`` (default: the
    world), an ``all_reduce`` sum over their number; ``x`` itself at one
    rank or without a process group."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    if torch.is_tensor(x):
        x = x.clone()
    else:
        x = torch.tensor(x, dtype=torch.float32, device="cuda" if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


def default_backend(n: int, device_type: str) -> str:
    """The backend of ``n`` ranks on ``device_type``: ``"nccl"`` where each
    rank has a card of its own, else ``"gloo"`` (NCCL refuses two ranks on
    one device; gloo takes CPU tensors, and CUDA ones for ``all_reduce``
    and ``broadcast``)."""
    cards = torch.cuda.device_count() if device_type == "cuda" and torch.cuda.is_available() else 0
    return "nccl" if 0 < n <= cards else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, backend, results, fn, args):
    """The body of a rank spawned by ``launch``."""
    os.environ.update(
        MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(n),
        RANK=str(rank), LOCAL_RANK=str(rank),
    )
    torch.set_num_threads(1)
    initialize_distributed(backend=backend)
    try:
        results.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def launch(n: int, fn: Callable, *args, backend: Optional[str] = None, timeout: float = 600.0):
    """Run ``fn(*args)`` in ``n`` ranks and return their results, by rank.

    Each rank is a process spawned by ``torch.multiprocessing``, joined to
    a group on a free localhost port by ``initialize_distributed`` (one
    CPU thread each); a port another process took before rank 0 bound it
    is replaced, up to three ports in all.  ``fn`` must be importable by
    name (a module-level function) and return numpy arrays or plain
    Python values (a torch tensor would travel through shared memory that
    ends with its rank).  ``backend``: ``default_backend(n, ...)`` of the
    card, or of the CPU without one.  When a rank fails or ``timeout``
    seconds pass, the others are killed and this raises.
    """
    import torch.multiprocessing as mp

    if backend is None:
        backend = default_backend(n, "cuda" if torch.cuda.is_available() else "cpu")
    deadline = time.monotonic() + timeout
    for attempt in range(3):
        try:
            return _launch_once(n, fn, args, backend, deadline, timeout)
        except mp.ProcessRaisedException as e:
            if attempt == 2 or "address already in use" not in str(e).lower():
                raise


def _launch_once(n, fn, args, backend, deadline, timeout):
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(
        _rank_main, args=(n, _free_port(), backend, results, fn, args), nprocs=n,
        join=False, start_method="spawn",
    )
    out = {}
    try:
        done = False
        while not done:
            # read while waiting: a rank exits only once its result is read
            while len(out) < n:
                try:
                    rank, value = results.get(timeout=0.05)
                except queue.Empty:
                    break
                out[rank] = value
            done = ctx.join(timeout=0.05)  # raises when a rank failed
            if not done and time.monotonic() > deadline:
                raise TimeoutError(f"launch: {n} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    while len(out) < n:
        rank, value = results.get(timeout=30)
        out[rank] = value
    return [out[r] for r in range(n)]
