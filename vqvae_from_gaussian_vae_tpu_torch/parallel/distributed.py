"""Data parallelism over ``torch.distributed``: one process a card.

Counterpart of ``vqvae_from_gaussian_vae_tpu/parallel/mesh.py``.  The JAX
package runs one SPMD program over a ``data`` mesh axis and lets GSPMD
insert the gradient sums; the port runs one process a card under
``torchrun`` and reduces explicitly (``parallel/train_step.py``), to the
same global-batch semantics.

``maybe_initialize_distributed`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) and is a no-op without it.  Each rank computes on the card
``cuda:LOCAL_RANK``; the backend is NCCL when each rank has a card of its
own, and gloo when the ranks share cards (NCCL refuses two ranks on one
card) or run on the CPU.  Beside an NCCL group a gloo group carries the
host-side collectives (gathers of per-image rows, small objects, and
``broadcast_object`` from rank 0), since gloo has no CUDA ``all_gather``.
A rank that asks for the card and finds none raises.

The helpers are no-ops in one process: ``rank()`` is 0 and ``world()`` 1.
A mesh spec ``{"data": -1 | N}`` names the data-parallel size; a ``model``
axis above 1 (tensor parallelism, ``mesh.py:tensor_parallel_params``,
``megatron_params``) is not ported and raises.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
BUCKET_BYTES = 64 << 20  # one all-reduce per 64 MiB of flattened gradients
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")

_host_group = None  # the gloo group of the host-side collectives


def launched() -> bool:
    """Whether torchrun's environment is set."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def maybe_initialize_distributed(device: str = "cuda") -> torch.device:
    """This rank's device; joins the process group first when torchrun's
    environment is set.  ``device`` is "cuda" (this rank's card) or "cpu"."""
    global _host_group
    kind = torch.device(device).type
    if not launched():
        return torch.device(device)
    local = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {os.environ['RANK']}: --device cuda but no CUDA device "
                               "is available")
        cards = torch.cuda.device_count()
        own_card = cards >= local_world
        out = torch.device("cuda", local if own_card else local % cards)
        torch.cuda.set_device(out)
        name = "nccl" if own_card else "gloo"
    elif kind == "cpu":
        out, name = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device {device!r}: the port runs on cuda or cpu")
    if not is_initialized():
        dist.init_process_group(backend=name)
        _host_group = dist.new_group(backend="gloo") if name == "nccl" else dist.group.WORLD
    return out


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _host_group
    if is_initialized():
        dist.destroy_process_group()
    _host_group = None


def data_parallel_size(mesh_spec: Optional[Mapping[str, int]] = None) -> int:
    """The data-parallel size a mesh spec names over this process group:
    ``{"data": -1}`` (the default) every rank, ``{"data": 1}`` this rank
    alone, ``{"data": N}`` N, which must be the world size."""
    spec = dict(mesh_spec or {})
    unknown = set(spec) - {DATA_AXIS, MODEL_AXIS}
    if unknown:
        raise ValueError(f"mesh {spec!r}: unknown axes {sorted(unknown)}")
    if int(spec.get(MODEL_AXIS, 1)) > 1:
        raise NotImplementedError(
            f"mesh {spec!r}: tensor parallelism (a model axis above 1) is not ported; "
            "the port trains data-parallel only")
    n = int(spec.get(DATA_AXIS, -1))
    if n in (-1, world()):
        return world()
    if n == 1:
        return 1
    raise ValueError(f"mesh {spec!r}: {n} data-parallel ranks, but the process group has "
                     f"{world()}")


# ------------------------------------------------------------- device tensors

def _reduce_(flat: torch.Tensor, op) -> None:
    """All-reduce one flat tensor in place; gloo reduces host copies."""
    if flat.is_cuda and backend() != "nccl":
        host = flat.cpu()
        dist.all_reduce(host, op=op)
        flat.copy_(host)
    else:
        dist.all_reduce(flat, op=op)


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` in runs of one device and dtype, each run at
    most BUCKET_BYTES (a larger tensor is a run of its own)."""
    runs, size = [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        head = tensors[runs[-1][0]] if runs else None
        if (head is None or head.dtype != t.dtype or head.device != t.device
                or size + nbytes > BUCKET_BYTES):
            runs.append([i])
            size = nbytes
        else:
            runs[-1].append(i)
            size += nbytes
    return runs


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     dtype: Optional[torch.dtype] = None) -> None:
    """Replace each tensor by its mean over the ranks, in place: flattened
    into buckets, summed by one all-reduce a bucket (in ``dtype`` when
    given: cast before the sum, back after it), divided by the world size.
    Every rank gets the same bits."""
    n = world()
    if n == 1 and dtype is None:
        return
    tensors = list(tensors)
    for run in _buckets(tensors):
        parts = [tensors[i] for i in run]
        flat = torch.cat([p.reshape(-1) for p in parts])
        if dtype is not None:
            flat = flat.to(dtype)
        if n > 1:
            _reduce_(flat, dist.ReduceOp.SUM)
        flat = flat.to(parts[0].dtype)
        if n > 1:
            flat = flat / n
        offset = 0
        for p in parts:
            p.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()


_OPS = {"mean": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def all_reduce_scalars(values: Mapping[str, torch.Tensor], op: str = "mean"
                       ) -> Dict[str, torch.Tensor]:
    """Float32 scalars reduced over the ranks (``op`` mean, min or max)
    in one all-reduce; the same keys, as 0-d tensors on the first value's
    device."""
    keys = list(values)
    if world() == 1 or not keys:
        return dict(values)
    first = values[keys[0]]
    device = first.device if torch.is_tensor(first) else torch.device("cpu")
    flat = torch.stack([torch.as_tensor(values[k], dtype=torch.float32, device=device
                                        ).detach().reshape(()) for k in keys])
    _reduce_(flat, _OPS[op])
    if op == "mean":
        flat = flat / world()
    return {k: flat[i] for i, k in enumerate(keys)}


# ------------------------------------------------------------- host values

def all_gather_rows(rows: np.ndarray) -> np.ndarray:
    """Every rank's rows (any count, the same trailing shape and dtype)
    joined in rank order, on every rank."""
    rows = np.ascontiguousarray(rows)
    if world() == 1:
        return rows
    counts = torch.zeros(world(), dtype=torch.int64)
    counts[rank()] = rows.shape[0]
    dist.all_reduce(counts, group=_host_group)
    most = int(counts.max())
    padded = np.zeros((most,) + rows.shape[1:], rows.dtype)
    padded[:rows.shape[0]] = rows
    mine = torch.from_numpy(padded)
    out = [torch.empty_like(mine) for _ in range(world())]
    dist.all_gather(out, mine, group=_host_group)
    return np.concatenate([o.numpy()[:int(c)] for o, c in zip(out, counts)])


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if world() == 1:
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj, group=_host_group)
    return out


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_host_group)
    return box[0]


def barrier() -> None:
    """Wait for every rank (on the host group: files written by one rank
    are there for the others after it)."""
    if world() > 1:
        dist.barrier(group=_host_group)
