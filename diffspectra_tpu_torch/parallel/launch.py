"""Run a function on several ranks in processes of their own, without
``torchrun``: the tests on the CPU (gloo) and ``chip_smoke.py`` on one card.

    results = spawn_ranks(fn, world=2, device="cpu", timeout=120, args=(config,))

Each rank is a process started with the ``spawn`` method; it joins a
process group through a file in a temporary directory
(``init_method="file://..."``; NCCL for a cuda device unless ``backend``
says otherwise, gloo for the CPU), calls ``fn(mesh, *args)`` with its
``parallel.Mesh`` and hands the result back through a file. ``fn`` must be
importable by name from a module that imports torch and the port alone.
The parent waits for every rank under ``timeout`` seconds: when a rank
raises, or the time runs out, it kills the others (one that waits in a
collective for the failed rank would never return) and raises with the
traceback of the rank that failed first.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback

import torch

POLL_SECONDS = 0.05


def _rank_main(fn, rank, world, device, backend, threads, tmp, args):
    import torch.distributed as dist

    from .mesh import Mesh

    result_path = os.path.join(tmp, f"result_{rank}.pt")
    try:
        torch.set_num_threads(threads)
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                                rank=rank, world_size=world)
        result = fn(Mesh(rank, world, device), *args)
    except BaseException:
        # written before the group goes down with this process, so that the
        # first rank to fail writes the first traceback
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    dist.destroy_process_group()
    torch.save({"result": result}, result_path + ".tmp")
    os.replace(result_path + ".tmp", result_path)


def spawn_ranks(fn, world: int, device="cpu", timeout: float = 120.0, args=(),
                backend=None, threads: int = 1) -> list:
    """``[fn(mesh_r, *args) for r in range(world)]``, each rank in its own
    process on ``device`` with ``threads`` CPU threads. Raises
    ``RuntimeError`` when a rank fails or ``timeout`` seconds pass."""
    from .mesh import backend_for

    backend = backend or backend_for(device)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, str(device), backend, threads, tmp, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(POLL_SECONDS)
            else:
                failed = next((r for r, p in enumerate(procs) if p.exitcode != 0), None)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errors = {}  # rank -> (when its traceback was written, the traceback)
        for r in range(world):
            path = os.path.join(tmp, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors[r] = (os.stat(path).st_mtime_ns, f.read())
        if failed is not None or errors:
            # the first to fail: the others may have failed in a collective with it
            rank = min(errors, key=lambda r: errors[r][0], default=failed)
            raise RuntimeError(f"rank {rank} of {world} failed (exit codes "
                               f"{[p.exitcode for p in procs]}):\n{errors.get(rank, (0, ''))[1]}")
        missing = [r for r in range(world)
                   if not os.path.exists(os.path.join(tmp, f"result_{r}.pt"))]
        if missing:
            raise RuntimeError(f"ranks {missing} of {world} did not finish within {timeout} s "
                               f"(exit codes {[p.exitcode for p in procs]}); killed")
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)["result"]
                for r in range(world)]
