"""Spawned gloo worlds for the port's mesh tests (a helper, not a test).

`run_world(fn, n, *args)` starts `n` processes, each joining a gloo
process group of `n` ranks over a file store, calls ``fn(rank, *args)``
in each with one torch thread, and returns the ranks' results in rank
order (tensors in them as numpy arrays).  A world that does not finish within `timeout` seconds (120 at
most) is killed and the call raises, so a hung collective costs one test,
not the suite.  `fn` must be a module-level function of an importable
module (the children are spawned, not forked).
"""
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

WORLD_TIMEOUT = 120


def _to_numpy(x):
    """Results cross as numpy: a tensor's storage would be shared with the
    parent by a file descriptor that dies with its process."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    return x


def _worker(rank, n, fn, store, q, args):
    import torch
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=n)
        q.put((rank, None, _to_numpy(fn(rank, *args))))
    except BaseException:
        q.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, n, *args, timeout=WORLD_TIMEOUT):
    timeout = min(timeout, WORLD_TIMEOUT)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    fd, store = tempfile.mkstemp(prefix="gloo_store_")
    os.close(fd)
    os.unlink(store)
    env = {"OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    procs = [ctx.Process(target=_worker, args=(r, n, fn, store, q, args))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout
        while len(out) < n:
            try:
                rank, err, res = q.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"ranks {dead} of a world of {n} "
                                       f"died") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {n} ranks did not "
                                       f"finish in {timeout} s") from None
                continue
            if err:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            out[rank] = res
        return [out[r] for r in range(n)]
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for p in procs:
            if p.pid is None:
                continue
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(store):
            os.unlink(store)
