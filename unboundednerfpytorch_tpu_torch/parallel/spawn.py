"""Run a function on several local processes joined by one process group:
the CPU rehearsal of a multi-card run (gloo), as ``torchrun`` would launch
it on a node.

``run(fn, world, store_dir, *args)`` starts ``world`` processes (the spawn
method), each of which initialises the group from a file store under
``store_dir`` (no port is taken, so many such runs can share a machine),
calls ``fn(rank, world, *args)`` and hands its result back. The results
come back in rank order; a failure on any rank raises here with its
traceback. ``fn`` and ``args`` reach the processes through a file under
``store_dir``, not through the start of each process: a start blocks until
the process has read what it is sent, so large arguments would make the
processes start one after the other.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import pickle
import traceback


def _worker(call_file: str, rank: int, world: int, init_file: str, backend: str,
            threads: int, queue) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    try:
        with open(call_file, "rb") as f:
            fn, args = pickle.load(f)  # written by run() of this module
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world)
        try:
            queue.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001: reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))


def run(fn, world: int, store_dir: str, *args, backend: str = "gloo", threads: int = 1,
        timeout: float = 300.0) -> list:
    """[fn(rank, world, *args) for each rank], computed on ``world``
    processes of one group. ``fn`` and ``args`` must pickle (``fn`` a
    module-level function)."""
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(store_dir, exist_ok=True)
    init_file = os.path.join(store_dir, "pg_store")
    if os.path.exists(init_file):
        os.remove(init_file)
    call_file = os.path.join(store_dir, "call.pkl")
    with open(call_file, "wb") as f:
        pickle.dump((fn, args), f)
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(call_file, r, world, init_file, backend, threads,
                                               queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            r, ok, value = queue.get(timeout=timeout)
            if ok:
                results[r] = value
            else:
                errors.append(f"rank {r}:\n{value}")
                break
    finally:
        whole = len(results) == world
        for p in procs:
            p.join(timeout=timeout if whole else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors or len(results) != world:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors or ["no result"]))
    return [results[r] for r in range(world)]


def run_main(rank: int, world: int, module: str, argv: list, device: str = "cpu") -> int:
    """``module.main(argv, device=device)`` on this rank (for :func:`run`):
    the rehearsal of ``torchrun --nproc_per_node world -m module argv``."""
    return importlib.import_module(module).main(list(argv), device=device)
