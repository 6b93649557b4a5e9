"""The ('data', 'model') mesh over ``torch.distributed`` (counterpart of
``neuraltexttospeech_tpu/parallel/mesh.py``, :30-63).

JAX's data-parallel step is one jitted function over the global batch, so a
sharded step equals the one-device step up to reduction order
(``train/harness.py:7-10``). Here each rank runs its own eager step on its
rows of the global batch, and these helpers give that step the global
semantics:

- :func:`shard_batch` takes this rank's rows of a global host batch: every
  rank iterates the same batches from the same seed, as JAX's one process
  does. The trainers shard in one place, where batches enter them
  (``device_iter``, ``evaluate``); their steps take this rank's rows;
- inside ``with mesh:`` the port's layers and losses see the data group.
  :func:`global_count` sums a count over it (the masked losses' normalisers),
  :func:`global_mean` is a mean over the global batch, and
  :func:`global_draw` draws a random tensor at the global batch shape from
  the step's generator and returns this rank's rows (dropout, the diffusion
  draws). So each rank's loss is its share of the global loss, and the
  shares' gradients add up to the global gradient;
- :class:`FlatGrads` sums the gradients over the data group in one
  all-reduce of a persistent buffer, and :func:`reduce_metrics` the
  metrics, which are shares too.

Rank ``r`` sits at data index ``r // n_model`` and model index
``r % n_model`` (JAX's ``devices.reshape(n_data, n_model)``). Ranks at or
past ``n_data · n_model`` are in no group and run no step.

A :class:`ServingReplica` is the serving loop's mesh
(``utils/serving.py``): the replicas of one process, one a thread, each
with its rows of the global batch. Under it :func:`global_draw` gives each
replica its rows of the global draw, as here; it has no process group, so
what would need a collective (:func:`global_count`, :func:`global_mean`,
BatchNorm's batch statistics) raises.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "ServingReplica", "make_mesh", "current",
           "collective_mesh", "shard_batch", "replicated", "global_count", "global_mean",
           "global_draw", "reduce_metrics", "FlatGrads"]

DATA_AXIS = "data"
MODEL_AXIS = "model"

_state = threading.local()


class Mesh:
    """This rank's place on an ``n_data × n_model`` grid of ranks, and its
    process groups: ``group`` (every rank of the grid), ``data_group`` (the
    ranks with this model index, over which the batch is sharded) and
    ``model_group`` (the ranks with this data index, over which
    :mod:`.tp` shards the transformer). ``with mesh:`` makes it the mesh that
    :func:`current` returns."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, n_data: int, n_model: int = 1):
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs torch.distributed to be initialised "
                               "(parallel.initialize_distributed)")
        world, self.rank = dist.get_world_size(), dist.get_rank()
        if n_data < 1 or n_model < 1 or n_data * n_model > world:
            raise ValueError(f"a {n_data} x {n_model} mesh does not fit {world} ranks")
        self.n_data, self.n_model = n_data, n_model
        self.active = self.rank < n_data * n_model
        self.data_index, self.model_index = divmod(self.rank, n_model)
        # every rank creates every group, in the same order (a collective)
        self.group = dist.new_group(list(range(n_data * n_model)))
        self.data_group = self.model_group = None
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if self.active and m == self.model_index:
                self.data_group = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if self.active and d == self.data_index:
                self.model_group = g

    def __enter__(self):
        if not self.active:
            raise RuntimeError(f"rank {self.rank} is not on the {self.n_data} x "
                               f"{self.n_model} mesh")
        return _push(self)

    def __exit__(self, *exc):
        _state.stack = _state.stack[:-1]
        return False


class ServingReplica:
    """Replica ``index`` of ``n`` serving rows ``[index·b, (index+1)·b)`` of a
    global batch of ``n·b`` rows, one a thread of one process. ``with
    replica:`` makes it this thread's :func:`current` mesh: a data axis of
    ``n`` with no model axis and no process group."""

    n_model, model_index = 1, 0
    group = data_group = model_group = None

    def __init__(self, n: int, index: int):
        if not 0 <= index < n:
            raise ValueError(f"replica {index} of {n}")
        self.n_data, self.data_index = n, index

    def __enter__(self):
        return _push(self)

    def __exit__(self, *exc):
        _state.stack = _state.stack[:-1]
        return False


def _push(mesh):
    stack = getattr(_state, "stack", [])
    _state.stack = stack + [mesh]
    return mesh


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ``n_data × n_model`` mesh over the initialised process group;
    ``n_data`` defaults to every rank the model axis leaves."""
    if n_data is None:
        n_data = dist.get_world_size() // n_model
    return Mesh(n_data, n_model)


def current() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:`` block, or None."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


def collective_mesh(what: str) -> Optional[Mesh]:
    """The current mesh for ``what``, a collective over its data group, or
    None; raises under a :class:`ServingReplica`, which has no group."""
    mesh = current()
    if isinstance(mesh, ServingReplica):
        raise RuntimeError(f"{what} needs a collective, and a serving replica has no "
                           "process group")
    return mesh


def _rows(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim >= 1


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of the global ``batch``: rows ``[i·b, (i+1)·b)`` of
    every tensor and numpy array, and of every list as long as an array
    (transcripts), ``i`` the data index and ``b = B / n_data``; other values
    (tuples such as a batch's position, names) pass through."""
    rows = {v.shape[0] for v in batch.values() if _rows(v)}

    def take(k, v):
        if len(v) % mesh.n_data:
            raise ValueError(f"batch[{k!r}] has {len(v)} rows, which {mesh.n_data} data "
                             "shards do not divide")
        b = len(v) // mesh.n_data
        return v[mesh.data_index * b:(mesh.data_index + 1) * b]

    return {k: take(k, v) if _rows(v) or (isinstance(v, list) and len(v) in rows) else v
            for k, v in batch.items()}


@torch.no_grad()
def replicated(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """``module`` with the parameters and buffers of rank 0 on every rank of
    the mesh (one broadcast a tensor, once)."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def global_count(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group of the current mesh, without
    gradient: the global count a loss divides by. Outside ``with mesh:``
    it is ``x``."""
    mesh = collective_mesh("global_count")
    if mesh is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.data_group)
    return x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch: this rank's mean over the
    number of data shards (``torch.mean(x)`` outside ``with mesh:``). Every
    shard has ``x.numel()`` elements, so no collective is needed."""
    mesh = collective_mesh("global_mean")
    if mesh is None:
        return torch.mean(x)
    return torch.mean(x) / mesh.n_data


def global_draw(fn, shape: Sequence[int], generator: Optional[torch.Generator], *,
                batch_axis: int = 0, model_axis: Optional[int] = None, **kwargs):
    """``fn(shape, generator=generator, **kwargs)`` (``torch.rand``,
    ``torch.randn``, ``partial(torch.randint, low, high)``) as the
    one-process step draws it. Under a mesh the draw is at the global shape,
    ``batch_axis`` times ``n_data`` (and ``model_axis``, the heads of a
    tensor-parallel block, times ``n_model``), and this rank's slices come
    back: every rank's generator stays where the one-process step's would be.

    A generator on another device than ``kwargs["device"]`` draws on its
    own device, and the slices are copied: serving replicas on several
    cards share the draws of one card's generator."""
    device = kwargs.get("device")
    if generator is not None and device is not None and torch.device(device) != generator.device:
        kwargs["device"] = generator.device
        return global_draw(fn, shape, generator, batch_axis=batch_axis,
                           model_axis=model_axis, **kwargs).to(device)
    mesh = current()
    if mesh is None:
        return fn(tuple(shape), generator=generator, **kwargs)
    shape = list(shape)
    b = shape[batch_axis]
    shape[batch_axis] *= mesh.n_data
    if model_axis is not None:
        h = shape[model_axis]
        shape[model_axis] *= mesh.n_model
    x = fn(tuple(shape), generator=generator, **kwargs)
    x = x.narrow(batch_axis, mesh.data_index * b, b)
    if model_axis is not None:
        x = x.narrow(model_axis, mesh.model_index * h, h)
    return x


def reduce_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A step's metrics (0-d shares of the global ones, as f32) summed over
    the data group in one all-reduce."""
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(flat, group=mesh.data_group)
    return dict(zip(keys, flat.unbind()))


class FlatGrads:
    """A persistent f32 buffer that sums the gradients of ``params`` over
    the data group in one collective.

    :meth:`all_reduce_` copies the step's gradients into it, all-reduces
    it and copies the sums back: each copy is one multi-tensor call, so
    the step keeps the plain step's gradients and launches but for a few,
    and allocates nothing."""

    def __init__(self, params: Sequence[torch.nn.Parameter]):
        params = list(params)
        if any(p.dtype != torch.float32 for p in params):
            raise TypeError("FlatGrads holds f32 parameters' gradients only")
        self.flat = torch.zeros(sum(p.numel() for p in params), dtype=torch.float32,
                                device=params[0].device)
        self.views, i = [], 0
        for p in params:
            self.views.append(self.flat[i:i + p.numel()].view_as(p))
            i += p.numel()

    def all_reduce_(self, grads: Sequence[torch.Tensor], mesh: Mesh) -> Sequence[torch.Tensor]:
        """``grads`` (one a parameter, in ``params``' order) summed over
        ``mesh``'s data group, in place; returns them."""
        torch._foreach_copy_(self.views, grads)
        dist.all_reduce(self.flat, group=mesh.data_group)
        torch._foreach_copy_(grads, self.views)
        return grads
