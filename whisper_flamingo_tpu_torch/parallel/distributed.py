"""Process bootstrap: one process per rank over ``torch.distributed``.

Port of ``whisper_flamingo_tpu/parallel/distributed.py``. JAX ran one
process per host with every local device in it; here each rank is a
process with one device. :func:`initialize` reads the JAX package's
variables (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``) or
``torchrun``'s (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and calls
``init_process_group``:

- ``nccl`` when each rank of the host has a card of its own;
- ``gloo`` on the CPU and when ranks share a card. NCCL refuses two ranks
  on one GPU, and gloo takes CUDA tensors only in ``all_reduce`` and
  ``broadcast``, so the port moves device tensors with those two alone
  (see :mod:`.mesh`) and Python objects with ``all_gather_object``.

A rank's device is ``cuda:{LOCAL_RANK % device_count}`` unless the caller
names the CPU; with no card and no CPU named it raises. ``timeout_s`` bounds
the group's set-up and each of its collectives: a rank that dies or stops
answering ends the others with an error instead of a hang.

:func:`spawn` starts ``n`` local ranks for the tests, the dry run and
``chip_smoke.py``; :func:`start` starts them without waiting, leaving
ranks out for the caller to take itself (:func:`join_local`, the
benchmark's data-parallel cell runs rank 0 in its own process); a user
launches with ``torchrun --nproc-per-node N``.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def local_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """This rank's device: the CPU when named, else the card
    ``LOCAL_RANK % device_count`` (raises when there is none)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local_rank = _env_int("LOCAL_RANK") or 0
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def pick_backend(device: torch.device) -> str:
    """``nccl`` when every local rank has a card of its own, else ``gloo``."""
    if device.type != "cuda":
        return "gloo"
    local_world = _env_int("LOCAL_WORLD_SIZE") or _env_int("WORLD_SIZE", "NUM_PROCESSES") or 1
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    timeout_s: Optional[float] = None,
) -> torch.device:
    """Join the process group (a no-op when this process is in one) and
    return this rank's device. ``coordinator_address`` is ``host:port``
    (``COORDINATOR_ADDRESS``, else ``MASTER_ADDR``:``MASTER_PORT``); the
    backend is :func:`pick_backend`'s; ``timeout_s`` (torch's default when
    ``None``) bounds the rendezvous and every collective of the group."""
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if address is None and os.environ.get("MASTER_ADDR"):
        address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    world = num_processes if num_processes is not None else _env_int("NUM_PROCESSES", "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("PROCESS_ID", "RANK")
    if address is None or world is None or rank is None:
        raise ValueError(
            "no process group: launch with `torchrun --nproc-per-node N -m <module> ...` "
            "or set COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID"
        )
    backend = pick_backend(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=int(world), rank=int(rank),
        device_id=dev if backend == "nccl" else None,
        timeout=None if timeout_s is None else datetime.timedelta(seconds=timeout_s),
    )
    return dev


def process_info() -> dict:
    initialized = dist.is_available() and dist.is_initialized()
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": dist.get_world_size() if initialized else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if initialized else 1,
        "backend": dist.get_backend() if initialized else None,
    }


def is_primary() -> bool:
    """True on the rank that writes logs and checkpoints (rank 0, or the
    only process)."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Local ranks for tests, the dry run and the smoke script
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join_local(rank: int, world: int, port: int, device: str = "cpu",
               timeout_s: Optional[float] = None) -> torch.device:
    """Take rank ``rank`` of ``world`` local ranks meeting on ``port`` in this
    process, as a rank of :func:`start` does: torchrun's variables set,
    then :func:`initialize`. Returns the rank's device."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    return initialize(device=device, timeout_s=timeout_s)


def _rank_main(fn, rank: int, world: int, port: int, device: str, threads: int,
               timeout_s: Optional[float], args: Sequence[Any], queue) -> None:
    if threads:
        torch.set_num_threads(threads)
    try:
        dev = join_local(rank, world, port, device, timeout_s)
        result = fn(rank, dev, *args)
        queue.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


_PORT_RACE = ("address already in use", "EADDRINUSE")
SPAWN_TIMEOUT_S = 600.0  # a rank still running after this fails the spawn


class LocalRanks:
    """Rank processes started by :func:`start`: :meth:`join` collects their
    results; the processes are stopped however it ends."""

    def __init__(self, procs: dict, queue, port: int):
        self.procs, self.queue, self.port = procs, queue, port

    def join(self, timeout_s: float = SPAWN_TIMEOUT_S) -> dict:
        """Each rank's result by rank, waiting at most ``timeout_s``; a
        failed, silent or late rank raises ``RuntimeError`` with the
        tracebacks."""
        import queue as queue_mod

        results: dict = {}
        failures: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) + len(failures) < len(self.procs):
                try:
                    rank, ok, value = self.queue.get(timeout=1.0)
                    (results if ok else failures)[rank] = value
                    continue
                except queue_mod.Empty:
                    pass
                silent = [r for r, p in self.procs.items() if p.exitcode not in (None, 0)
                          and r not in results and r not in failures]
                for r in silent:
                    failures[r] = f"exited with code {self.procs[r].exitcode} and sent nothing"
                if time.monotonic() > deadline:
                    failures[-1] = f"ranks still running after {timeout_s} s"
                    break
        finally:
            self.stop()
        if failures:
            text = "\n".join(f"rank {r}:\n{tb}" for r, tb in sorted(failures.items()))
            raise RuntimeError(f"{len(failures)} of {len(self.procs)} ranks failed\n{text}")
        return results

    def stop(self) -> None:
        """Join the processes, killing any still alive after 30 s."""
        for p in self.procs.values():
            p.join(timeout=30)
        for p in self.procs.values():
            if p.is_alive():
                p.kill()
                p.join()


def start(fn: Callable, nprocs: int, args: Sequence[Any] = (), *, device: str = "cpu",
          threads: int = 1, ranks: Optional[Sequence[int]] = None,
          timeout_s: Optional[float] = None) -> LocalRanks:
    """Start ``fn(rank, device, *args)`` in a fresh process for each of
    ``ranks`` (all ``nprocs`` by default) of one process group on a free
    local port, and return at once; ranks left out are the caller's to
    take with :func:`join_local` on ``LocalRanks.port``. ``timeout_s`` is
    the group's (:func:`initialize`)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = {r: ctx.Process(target=_rank_main,
                            args=(fn, r, nprocs, port, device, threads, timeout_s, tuple(args), q))
             for r in (range(nprocs) if ranks is None else ranks)}
    for p in procs.values():
        p.start()
    return LocalRanks(procs, q, port)


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (), *, device: str = "cpu",
          threads: int = 1) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in ``nprocs`` fresh processes joined
    into one process group on a free local port (one retry when another
    process takes the port first); returns the ranks' results in rank
    order. ``fn`` and its results must pickle. A failed or silent rank
    raises with its traceback; every process is stopped before return."""
    for attempt in range(2):
        try:
            results = start(fn, nprocs, args, device=device, threads=threads).join()
        except RuntimeError as e:
            if attempt == 0 and any(s in str(e) for s in _PORT_RACE):
                continue
            raise RuntimeError(f"spawn: {e}") from None
        return [results[r] for r in range(nprocs)]
    raise AssertionError("unreachable")
