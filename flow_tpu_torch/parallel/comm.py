# The collectives of the distributed layer, and a launcher of ranks.
#
# The JAX package runs each distributed stepper as one shard_map program
# over a device mesh, and its collectives (lax.psum, lax.pmax,
# lax.all_gather, lax.ppermute, lax.axis_index) name a mesh axis. Here every
# rank is a process that holds one device (cuda:<local rank>, or the CPU
# for tests) and its own row of what JAX keeps as an [ndev, ...] stack, and
# the collectives are torch.distributed calls on a process group:
#
#   lax.psum     -> all_reduce_sum   (one all_reduce(SUM) per psum)
#   lax.pmax     -> all_reduce_max
#   lax.all_gather (stacked or tiled) -> all_gather (all_gather_into_tensor)
#   lax.ppermute over the ring pairs  -> ring_exchange (batch_isend_irecv;
#                                        a rank with no sender gets zeros)
#   lax.axis_index -> dist.get_rank(group)
#
# CUDA tensors go through NCCL and CPU tensors through gloo. Nothing falls
# back: a CUDA device without an NCCL group, or fewer cards than ranks,
# raises (resolve_device).
#
# launch(target, world_size, ...) starts world_size ranks as fresh
# interpreters (`python -m flow_tpu_torch.parallel.comm`), each running the
# module-level function named by "module:function" with the given
# arguments, and returns every rank's result in rank order. It picks a free
# localhost port, sets one CPU thread per rank (gloo; NCCL ranks share the
# host's cores) and raises if any rank fails
# (the others are then stopped). A world of 1 runs in the calling process,
# on a store of its own.
from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = [
    "resolve_device",
    "all_reduce_sum",
    "all_reduce_max",
    "all_gather",
    "ring_exchange",
    "launch",
    "CALLS",
]

# collective calls by kind, since the process started (a caller may reset
# them): what a step costs in collectives
CALLS = {"all_reduce": 0, "all_gather": 0, "ring_exchange": 0}


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------
def resolve_device(device, group=None):
    """The device of this rank: `device` as given, or cuda:<local rank>
    (LOCAL_RANK, else the global rank). A CUDA device needs an NCCL group
    and a card for every rank of the host; a CPU device a gloo group."""
    if not dist.is_initialized():
        raise RuntimeError("flow_tpu_torch.parallel: no process group; start the "
                           "ranks with parallel.comm.launch or init_process_group")
    backend = dist.get_backend(group)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the distributed steppers run on the GPU by "
                "default; pass device='cpu' (with a gloo group) to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        if backend != "nccl":
            raise RuntimeError(f"flow_tpu_torch.parallel: CUDA tensors need an NCCL "
                               f"group, this one is {backend!r}")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             dist.get_rank())))
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"flow_tpu_torch.parallel: rank {dist.get_rank()} "
                               f"wants {device}, the host has "
                               f"{torch.cuda.device_count()} cards")
        # a collective first, so that the group's communicator exists before
        # any point-to-point batch (which NCCL wants all ranks to start)
        dist.barrier(group=group, device_ids=[device.index])
    elif device.type == "cpu":
        if backend != "gloo":
            raise RuntimeError(f"flow_tpu_torch.parallel: CPU tensors need a gloo "
                               f"group, this one is {backend!r}")
    else:
        raise ValueError(f"flow_tpu_torch.parallel: no collectives for {device}")
    return device


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
# the flat all-gather (all_gather_into_tensor, renamed all_gather_single in
# later releases); gloo takes only the flat output
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_reduce_sum(t, group=None):
    """lax.psum: the sum over the group's ranks (a new tensor)."""
    CALLS["all_reduce"] += 1
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_max(t, group=None):
    """lax.pmax."""
    CALLS["all_reduce"] += 1
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_gather(t, group=None):
    """lax.all_gather: [size, *t.shape], rank-major (tiled: reshape the
    leading two axes)."""
    CALLS["all_gather"] += 1
    size = dist.get_world_size(group)
    out = torch.empty(size * t.numel(), dtype=t.dtype, device=t.device)
    _ALL_GATHER(out, t.reshape(-1).contiguous(), group=group)
    return out.view((size,) + tuple(t.shape))


def ring_exchange(to_right, to_left, group=None):
    """The two ppermutes of a 1-D ring without wrap-around: every rank sends
    to_right to rank + 1 and to_left to rank - 1, and returns (from_left,
    from_right), zeros where there is no such neighbour."""
    CALLS["ring_exchange"] += 1
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    to_right, to_left = to_right.contiguous(), to_left.contiguous()
    from_left = torch.zeros_like(to_right)
    from_right = torch.zeros_like(to_left)
    ops = []

    def peer(r):
        return r if group is None else dist.get_global_rank(group, r)

    if rank + 1 < size:
        ops.append(dist.P2POp(dist.isend, to_right, peer(rank + 1), group))
        ops.append(dist.P2POp(dist.irecv, from_right, peer(rank + 1), group))
    if rank > 0:
        ops.append(dist.P2POp(dist.isend, to_left, peer(rank - 1), group))
        ops.append(dist.P2POp(dist.irecv, from_left, peer(rank - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_left, from_right


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve(target):
    mod, _, fn = target.partition(":")
    if not fn:
        raise ValueError(f"launch: target must be 'module:function', got {target!r}")
    return getattr(importlib.import_module(mod), fn)


def _init(backend, rank, world_size, init_method=None, store=None, timeout=600):
    kw = {"timeout": timedelta(seconds=timeout)}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} of {world_size} needs cuda:{local}; the "
                               f"host has {torch.cuda.device_count()} cards")
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, **kw)


def launch(target, world_size, args=(), kwargs=None, backend="gloo",
           timeout=1800, threads=None):
    """Run target(*args, **kwargs) on world_size ranks -> [result of rank 0,
    ..., rank world_size - 1]. backend "gloo" (CPU tensors) or "nccl" (one
    card a rank, cuda:<rank>). Results and arguments must pickle (numpy
    arrays and Python values). threads: CPU threads a rank (default 1 with
    gloo; with NCCL the host's cores shared out, for the host-side setup).
    Raises RuntimeError naming the ranks that failed, with their output."""
    kwargs = dict(kwargs or {})
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"launch: backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise RuntimeError("launch: NCCL needs CUDA and an NCCL build of torch")
        if torch.cuda.device_count() < world_size:
            raise RuntimeError(f"launch: {world_size} ranks need {world_size} cards, "
                               f"the host has {torch.cuda.device_count()}")
    fn = _resolve(target)
    if world_size == 1:
        if dist.is_initialized():
            raise RuntimeError("launch: a process group already exists here")
        _init(backend, 0, 1, store=dist.HashStore(), timeout=timeout)
        try:
            return [fn(*args, **kwargs)]
        finally:
            dist.destroy_process_group()
    with tempfile.TemporaryDirectory(prefix="flow_ranks_") as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump((target, args, kwargs, backend, timeout), f)
        port = _free_port()
        if threads is None:
            threads = 1 if backend == "gloo" else max(1, (os.cpu_count() or 1) // world_size)
        procs, logs = [], []
        # the ranks import this copy of the package, wherever they start
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
        for r in range(world_size):
            env = dict(os.environ, PYTHONPATH=path)
            env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world_size),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads),
                       FLOW_RANK_THREADS=str(threads))
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "flow_tpu_torch.parallel.comm", job,
                 os.path.join(tmp, f"out{r}.pkl")],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout
        failed = []
        try:
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            hung = [r for r, p in enumerate(procs) if p.poll() is None]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if failed or hung:
            text = []
            for r in failed + hung:
                logs[r].seek(0)
                tail = logs[r].read()[-4000:]
                text.append(f"--- rank {r} ---\n{tail}")
            for log in logs:
                log.close()
            why = (f"ranks {failed} failed" if failed else
                   f"ranks {hung} did not finish in {timeout} s")
            raise RuntimeError(f"launch({target!r}, {world_size}): {why}\n"
                               + "\n".join(text))
        for log in logs:
            log.close()
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(job, out):
    with open(job, "rb") as f:
        target, args, kwargs, backend, timeout = pickle.load(f)
    torch.set_num_threads(int(os.environ.get("FLOW_RANK_THREADS", "1")))
    rank = int(os.environ["RANK"])
    world_size = int(os.environ["WORLD_SIZE"])
    init = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    _init(backend, rank, world_size, init_method=init, timeout=timeout)
    try:
        result = _resolve(target)(*args, **kwargs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    try:
        _rank_main(sys.argv[1], sys.argv[2])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
