"""Multi-process runs on ``torch.distributed``: initialization, the pod mesh,
a rank's slice of a batch, and a local spawn of ranks.

Counterpart of ``minigrid_tpu/parallel/multihost.py``.  JAX runs one process
per host over a global ``jax.sharding.Mesh`` of devices; PyTorch runs one
process per rank, one card per rank on a multi-GPU host, launched by
``torchrun``.  Every rank runs the same program: the env loop has no
collectives (each rank generates the levels of its own rows from keys every
rank holds), and the learner's only traffic is its gradient reduction
(``minigrid_tpu_torch.rl.mesh``).

Typical use (the same script on every rank, ``torchrun --nproc-per-node N``)::

    from minigrid_tpu_torch.parallel.multihost import initialize, pod_mesh
    initialize()                       # reads torchrun's environment
    mesh = pod_mesh(tp=1)              # dp = every rank
    trainer = PPO(env, None, cfg, mesh=mesh)
    runner = trainer.init(rng.PRNGKey(0))   # the same key on every rank
    runner, metrics = trainer.update(runner)

:func:`spawn` runs a function on n local ranks of one process group (the
counterpart of JAX's one-process virtual device farm): the tests, the
weak-scaling sweep (``tools/bench_sharded.py``) and ``chip_smoke.py`` use it.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _backend(backend: str | None, local_world: int) -> str:
    """``nccl`` when each local rank has a card of its own, ``gloo`` without
    a card; NCCL with more local ranks than cards raises (it refuses two
    ranks on one card), naming ``gloo``, which shares one."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        if cards == 0:
            return "gloo"
        backend = "nccl"
    if backend == "nccl" and local_world > cards:
        raise RuntimeError(
            f"NCCL needs a card per rank: {local_world} ranks on this host, {cards} "
            "card(s); pass backend='gloo' to run ranks that share a card")
    return backend


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> bool:
    """Initialize the default process group of a multi-process run.

    With no arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``) and
    returns ``False`` when none of it is set: a plain single-process run.
    With a coordinator (``"host:port"``) it needs ``num_processes`` and
    ``process_id`` too.  Returns ``True`` once the group is up, and whether
    it has more than one rank when it was already initialized.  Any other
    failure raises: nothing degrades quietly to one process.

    The backend defaults to ``nccl`` where each rank has a card of its own
    and ``gloo`` on the CPU; on a card host each rank's current device is
    its ``LOCAL_RANK``'s card (shared round robin under ``gloo``)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    explicit = (coordinator_address, num_processes, process_id)
    if all(v is None for v in explicit):
        present = [k for k in _TORCHRUN_VARS if k in env]
        if not present:
            return False
        missing = [k for k in _TORCHRUN_VARS if k not in env]
        if missing:
            raise RuntimeError(f"torchrun environment incomplete: {present} set, "
                               f"{missing} not")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    elif any(v is None for v in explicit):
        raise ValueError("pass coordinator_address, num_processes and process_id together")
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    local_rank = int(env.get("LOCAL_RANK", process_id % local_world))
    backend = _backend(backend, local_world)
    device = None
    if torch.cuda.is_available():
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    # NCCL binds its communicator to the rank's card; gloo takes no device
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            device_id=device if backend == "nccl" else None)
    return True


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def pod_mesh(tp: int = 1, axis_names: tuple[str, str] = ("dp", "tp"),
             devices: Sequence[int] | None = None):
    """A ``(dp, tp)`` ``DeviceMesh`` over every rank of the run (or the ranks
    ``devices``), ``dp = n // tp``: ``dp`` shards the env batch and reduces
    the gradients, ``tp`` shards the parameters' feature dims
    (:func:`minigrid_tpu_torch.rl.tp_param_sharding`).  A rank's ``tp``
    group is ``tp`` consecutive ranks, so on a multi-card host it stays on
    the host's links."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("pod_mesh needs a process group: call initialize() first "
                           "(a single process runs unsharded, with mesh=None)")
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    n = len(ranks)
    assert n % tp == 0, f"{n} devices not divisible by tp={tp}"
    return DeviceMesh(_mesh_device_type(), torch.tensor(ranks).reshape(n // tp, tp),
                      mesh_dim_names=tuple(axis_names))


def process_local_slice(num_global: int) -> tuple[int, int]:
    """(start, size) of this rank's contiguous share of a batch axis of
    ``num_global``: useful for host-side feeding (demo corpora, evaluation
    episodes).  One process owns it all."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = num_global // world
    return rank * per, per


# -- a local spawn of ranks ----------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_host(tree: Any) -> Any:
    """Tensors in a result as numpy (bf16 as float32), so that nothing of a
    rank's memory crosses the queue."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _rank_main(rank: int, nprocs: int, port: int, backend: str | None,
               fn: Callable, args: tuple, results) -> None:
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    try:
        if not initialize(f"127.0.0.1:{port}", nprocs, rank, backend):
            raise RuntimeError("initialize() with a coordinator started no process group")
        results.put((rank, True, to_host(fn(*args))))
    except Exception:  # the rank's boundary: reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), backend: str | None = None,
          timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``nprocs`` local ranks of one process group
    (rank ``r`` of ``nprocs``, a ``tcp://127.0.0.1`` coordinator on a free
    port) and return each rank's result in rank order, tensors as numpy.

    ``fn`` is pickled by its import path, so it must be a module-level
    function; each rank starts from a fresh interpreter (``spawn``), so
    what it needs comes through ``args``.  If any rank fails, the others
    are stopped and the first failure's traceback is raised; a rank that
    does not answer within ``timeout`` seconds fails the call.  ``backend``
    as :func:`initialize` picks it."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, nprocs, port, backend, fn, args, results),
                         daemon=True) for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < nprocs:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {nprocs} died with exit code "
                                       f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(nprocs)) - set(out))} "
                                       f"of {nprocs} gave no result in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(nprocs)]

