"""Replay a module's serving forward from a CUDA graph, one graph a shape.

A batch-1 request through FastPitch and HiFi-GAN is ~1,360 small kernels,
and the host issuing them one by one through Python sets its pace, not the
card. :func:`run` calls a module's eager body through a cache of CUDA
graphs: the first call at a shape runs the body eagerly (its warm-up, and
its own result) and then captures it; every later call at that shape copies
its inputs into the graph's, replays the graph (the same kernels in the
same order, one launch from the host) and returns copies of its outputs.

It engages only where it can observe that a graph computes what the body
would: the call's tensors are on one card, inference mode is on, the module
is in eval mode and no capture is underway. Anything else (the CPU,
autograd, training, a value the key cannot hold, such as a callable) runs
the body as it is, so the trainers and every CPU path never meet a graph.

- **The key** is everything the body reads besides the module's weights:
  each argument's shape and dtype (integer tensors only as integers: they
  enter the graph in the dtype of the call that captured it, so token ids
  in int32 and int64 share one graph) or its value, the argument names, the
  device, the compute dtype of ``nn/precision.py`` and the backends' TF32,
  reduced-precision and determinism switches, which are baked in at
  capture. A replay computes on a contiguous copy of each input.
- **Bounded**: at most :data:`CAP` graphs a module a device; past it a new
  shape runs eagerly (``graph.eager``). The graphs of a module on a device
  share one memory pool: they replay one at a time on the caller's stream.
- **Guarded**: a graph reads the parameter and buffer storage it captured.
  A call that finds other storage (a ``Parameter`` replaced, the module
  moved or cast) drops the module's graphs and runs eagerly
  (``graph.eager``); the next call at a shape captures afresh. Loads in
  place (``copy_``, ``load_state_dict``) keep the graphs valid.
- **Held**: a tensor the body reads from outside the module and the call
  (a cached constant) is kept alive by the graph when the body passes it
  through :func:`hold`.
- **Not copied**: the cache lives in the module's ``__dict__``, out of its
  state dict; ``copy.deepcopy`` and pickling give a copy an empty cache, so
  each serving replica captures its own.

Counters (``utils/profiling.py``): ``graph.capture`` (a call that captured
its shape), ``graph.replay`` and ``graph.eager``. The counts the body makes
while it is captured (``precision.casts``, ``norms.weight_norm``) are
tallied whether or not tracing is on, and each traced replay adds them, so
they count the work the card does whichever way it was issued. Spans inside
the body are recorded only on eager calls.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Callable, Dict, List, Optional

import torch
from torch.nn.modules import module as _nn_module
from torch.utils import _pytree

from ..nn import precision
from . import profiling

__all__ = ["CAP", "run", "hold", "GraphCache"]

CAP = 32  # graphs a module a device; bucketed serving at one batch needs 16 + 13

_ATTR = "_cuda_graphs"
_PLAIN = (bool, int, float, str, torch.dtype)
_INT = "int"
_capture_lock = threading.Lock()  # one capture at a time in the process
_local = threading.local()        # the keep-alive list of the capture underway

# Bumped (to a fresh value) whenever a module that a cache captured against,
# or one of its submodules, registers a parameter, a buffer or a submodule:
# a cache that saw another value walks its module again before it trusts its
# graphs. (A forward may register modules into a new container, as slicing a
# ``ModuleList`` does: such registrations are not watched.)
_generations = itertools.count(1)
_generation = 0
_watched: "weakref.WeakSet[torch.nn.Module]" = weakref.WeakSet()
_watching = False


def _bump(module, *_args):
    global _generation
    if module in _watched:
        _generation = next(_generations)


def _watch():
    global _watching
    with _capture_lock:
        if not _watching:
            _nn_module.register_module_parameter_registration_hook(_bump)
            _nn_module.register_module_buffer_registration_hook(_bump)
            _nn_module.register_module_module_registration_hook(_bump)
            _watching = True


def hold(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor``, kept alive by the graph being captured on this thread (a
    tensor from outside the module and the call that the body reads, such as
    a cached constant, which the graph reads by its address); outside a
    capture, ``tensor`` alone."""
    held = getattr(_local, "held", None)
    if held is not None:
        held.append(tensor)
    return tensor


class _Graph:
    """One captured shape: its static inputs and outputs, the outputs'
    structure, the counts its body made and the tensors it holds."""

    __slots__ = ("graph", "inputs", "outputs", "spec", "tally", "held")

    def replay(self, tensors: List[torch.Tensor]):
        for static, t in zip(self.inputs, tensors):
            static.copy_(t)
        self.graph.replay()
        return _pytree.tree_unflatten(
            [t.clone() if isinstance(t, torch.Tensor) else t for t in self.outputs], self.spec)


class _Card:
    """A module's graphs on one device: the capture stream, the memory pool
    and the graphs by key."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, _Graph] = {}

    def first_call(self, key, body: Callable, args, kwargs, tensors: List[torch.Tensor]):
        """Run the body eagerly on the capture stream (the caller's result,
        and the warm-up that sets up the stream's library state), then
        capture it at this shape under ``key``."""
        caller = torch.cuda.current_stream(tensors[0].device)
        s = self.stream
        s.wait_stream(caller)
        with torch.cuda.stream(s):
            out = body(*args, **kwargs)
        caller.wait_stream(s)
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(caller)

        entry = _Graph()
        # integer inputs take the capture call's dtype; every input is contiguous
        entry.inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
        for static, t in zip(entry.inputs, tensors):
            static.copy_(t)
        static = iter(entry.inputs)
        args, kwargs = _pytree.tree_map_only(torch.Tensor, lambda _: next(static), (args, kwargs))
        entry.graph = torch.cuda.CUDAGraph()
        entry.held = _local.held = []
        try:
            with profiling.tally() as entry.tally, torch.cuda.stream(s):
                entry.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    captured = body(*args, **kwargs)
                except BaseException:
                    try:
                        entry.graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is already broken: report the body's error
                    raise
                entry.graph.capture_end()
        finally:
            _local.held = None
        entry.outputs, entry.spec = _pytree.tree_flatten(captured)
        self.graphs[key] = entry
        return out


class GraphCache:
    """A module's CUDA graphs, by device. Copies and pickles of it are
    empty, so a copied module captures its own."""

    def __init__(self):
        self.cards: Dict[torch.device, _Card] = {}
        self.tensors: Optional[list] = None  # the parameters and buffers captured against
        self.ptrs: Optional[list] = None
        self.generation = None

    def __reduce__(self):
        return (GraphCache, ())

    def current(self, module: torch.nn.Module) -> bool:
        """Whether the module still holds the storage the graphs read; if
        not, the graphs are dropped."""
        if self.tensors is None:
            return True
        if self.generation == _generation:
            if all(t.data_ptr() == p for t, p in zip(self.tensors, self.ptrs)):
                return True
        else:
            tensors, ptrs = self.tensors, self.ptrs
            self.tensors = None
            self.pin(module)
            if (len(tensors) == len(self.tensors) and self.ptrs == ptrs
                    and all(a is b for a, b in zip(tensors, self.tensors))):
                return True
        self.clear()
        return False

    def pin(self, module: torch.nn.Module):
        """Record the storage the graphs about to be captured read, and
        watch the module's tree for replaced parameters, buffers and
        submodules."""
        if self.tensors is None:
            self.generation = _generation
            _watched.update(module.modules())
            self.tensors = [*module.parameters(), *module.buffers()]
            self.ptrs = [t.data_ptr() for t in self.tensors]

    def clear(self):
        self.cards.clear()
        self.tensors = self.ptrs = self.generation = None


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


def _key(args, kwargs):
    """``(key, tensors)`` of a call, or None where a tensor is off the card
    or on another device than the first, or a value is one the key cannot
    hold."""
    tensors, parts = [], []
    for v in itertools.chain(args, kwargs.values()):
        if isinstance(v, torch.Tensor):
            if not _on_card(v):
                return None
            tensors.append(v)
            dtype = v.dtype
            kind = _INT if not (dtype.is_floating_point or dtype.is_complex
                                or dtype == torch.bool) else dtype
            parts.append((tuple(v.shape), kind))
        elif v is None or isinstance(v, _PLAIN):
            parts.append((type(v), v))
        else:
            return None
    if not tensors:
        return None
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        return None
    backends = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction,
                torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    return (tuple(kwargs), tuple(parts), device, precision.current(), backends), tensors


def run(module: torch.nn.Module, body: Callable, *args, **kwargs):
    """``body(*args, **kwargs)``, the eager forward of ``module``: replayed
    from the module's graph of this call's key where there is one, captured
    after it runs where there is none (up to :data:`CAP`), or called as it
    is where a graph cannot stand in for it (see the module's docstring)."""
    if module.training or not torch.is_inference_mode_enabled():
        return body(*args, **kwargs)
    keyed = _key(args, kwargs)
    if keyed is None or _capturing():
        return body(*args, **kwargs)
    key, tensors = keyed
    cache = module.__dict__.get(_ATTR)
    if cache is None:
        cache = module.__dict__[_ATTR] = GraphCache()
    if not cache.current(module):
        profiling.count("graph.eager")
        return body(*args, **kwargs)
    device = key[2]
    card = cache.cards.get(device)
    entry = None if card is None else card.graphs.get(key)
    if entry is not None:
        out = entry.replay(tensors)
        profiling.count("graph.replay")
        for name, n in entry.tally.items():
            profiling.count(name, n)
        return out
    if card is not None and len(card.graphs) >= CAP:
        profiling.count("graph.eager")
        return body(*args, **kwargs)
    _watch()
    with _capture_lock:
        cache.pin(module)
        if card is None:
            card = cache.cards[device] = _Card(device)
        out = card.first_call(key, body, args, kwargs, tensors)
    profiling.count("graph.capture")
    return out
