"""Start the ranks of a mesh: ``spawn(world, fn, args, ...)``.

Each rank is a process of ``torch.multiprocessing``'s "spawn" start method
(a fresh interpreter: no state of the parent, and nothing of the parent's
imports but what ``fn``'s module imports), joined to the others by a
``file://`` rendezvous, so that ranks started by different test workers
never meet on a TCP port.  ``fn(rank, world, *args)`` runs with the
default process group initialised and is torn down after it; what it
returns comes back to the parent (pickled).  Every rank is waited for
with a time limit, and a rank's exception or non-zero exit is raised in
the parent, the other ranks stopped.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback


def _rank_main(rank, world, fn, args, backend, init_method, results,
               timeout_s):
    import torch
    import torch.distributed as dist

    try:
        # ranks that share a host share its cores
        share = max(1, (os.cpu_count() or 1) // world)
        if torch.get_num_threads() > share:
            torch.set_num_threads(share)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(world: int, fn, args=(), backend: str = "gloo",
          init_file=None, timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes over
    ``backend``; return the ranks' results in rank order.  ``init_file``:
    the rendezvous file (a path that does not exist yet; default a new
    one in a temporary directory).  Raises ``RuntimeError`` naming the
    rank whose ``fn`` raised or whose process exited non-zero, and
    ``TimeoutError`` when the ranks are not done within ``timeout_s``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="sddmm_rdzv_") as tmp:
        path = init_file or os.path.join(tmp, "rendezvous")
        if os.path.exists(path):
            raise ValueError(f"spawn: rendezvous file {path} already exists")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            rank, world, fn, tuple(args), backend, f"file://{path}",
            results, timeout_s)) for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        out, failure = {}, None
        try:
            while len(out) < world and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn: ranks {sorted(set(range(world)) - set(out))}"
                        f" not done within {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    continue
                if ok:
                    out[rank] = payload
                else:
                    failure = f"rank {rank} raised:\n{payload}"
            if failure is None:
                for p in procs:
                    p.join(max(deadline - time.monotonic(), 1.0))
                bad = [(r, p.exitcode) for r, p in enumerate(procs)
                       if p.exitcode != 0]
                if bad:
                    failure = f"rank {bad[0][0]} exited with code {bad[0][1]}"
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            results.close()
        if failure is not None:
            raise RuntimeError(f"spawn over {backend}: {failure}")
        return [out[r] for r in range(world)]
