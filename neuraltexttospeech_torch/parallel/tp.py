"""Tensor parallelism on the mesh's ``model`` axis (counterpart of
``neuraltexttospeech_tpu/parallel/tp.py``, :39-98): Megatron's layouts for
the FFT transformer of FastPitch and FastSpeech 2, over the port's
state-dict names (``convert.py`` maps JAX's onto them).

- the fused ``qkv`` projection is column-parallel: each rank computes the
  attention of its own heads;
- the attention's ``o`` is row-parallel: each rank's partial output is
  summed over the model group;
- the ConvFF pair is column- then row-parallel over the inner features,
  ``conv2``'s bias added after the sum;
- a dimension that the model axis does not divide replicates.

Where this differs from JAX: ``qkv``'s output features are ordered
``[3][n_head][d_head]``. JAX splits them contiguously and XLA inserts the
collectives that keep the attention right; an eager shard must hold whole
heads of q, k and v, so the port splits the heads axis of the ``[3, H, D]``
view, and ``qkv`` shards only when the model axis divides ``n_head``. When
it does not (FastPitch's one head), ``qkv`` replicates and ``o`` stays
row-parallel over this rank's slice of the attention output.

``shard_params_tp`` keeps this rank's slices in place and hands the blocks
the mesh; ``nn/transformer.py`` then runs them with the two collectives
below: :func:`copy_to_model` (identity forward, sum of the gradient over
the model group backward) where a replicated tensor enters a sharded layer,
and :func:`reduce_from_model` (sum forward, identity backward) after a
row-parallel one.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["Shard", "TPRule", "FFT_TRANSFORMER_TP_RULES", "tp_param_specs", "local_slice",
           "shard_params_tp", "copy_to_model", "reduce_from_model"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """Dimension ``dim`` of a parameter split over the model axis. The
    dimension is ``blocks`` equal blocks (``qkv``: q, k and v), each split
    alike; with ``heads`` each rank's piece is whole heads of the owning
    attention's ``d_head``."""
    dim: int
    blocks: int = 1
    heads: bool = False


# (state-dict name regex, Shard). Linear weights are [out, in], conv
# weights [out, in, width].
TPRule = Tuple[str, Shard]

FFT_TRANSFORMER_TP_RULES: Sequence[TPRule] = (
    # fused qkv: column-parallel over heads
    (r"\.attn\.qkv\.weight$", Shard(0, blocks=3, heads=True)),
    (r"\.attn\.qkv\.bias$", Shard(0, blocks=3, heads=True)),
    # attention out (no bias): row-parallel
    (r"\.attn\.o\.weight$", Shard(1)),
    # ConvFF: column- then row-parallel over the inner features
    (r"\.ff\.conv1\.weight$", Shard(0)),
    (r"\.ff\.conv1\.bias$", Shard(0)),
    (r"\.ff\.conv2\.weight$", Shard(1)),
)


def _owner(name: str) -> str:
    """The block that owns parameter ``name`` (``….attn`` or ``….ff``)."""
    return name.rsplit(".", 2)[0]


def tp_param_specs(model: torch.nn.Module, rules: Sequence[TPRule] = FFT_TRANSFORMER_TP_RULES,
                   model_axis_size: Optional[int] = None) -> Dict[str, Optional[Shard]]:
    """Each parameter's :class:`Shard`, or None where it replicates. With
    ``model_axis_size``, a rule's hit whose dimension that size does not
    divide (for ``heads``, whose head count) replicates."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    specs = {}
    for name, p in model.named_parameters():
        spec = next((s for pat, s in compiled if pat.search(name)), None)
        if spec is not None and model_axis_size is not None:
            units = p.shape[spec.dim] // spec.blocks
            if spec.heads:
                units //= model.get_submodule(_owner(name)).d_head
            if units % model_axis_size:
                spec = None
        specs[name] = spec
    return specs


def local_slice(t: torch.Tensor, spec: Shard, n: int, i: int) -> torch.Tensor:
    """Rank ``i`` of ``n``'s slice of ``t`` under ``spec``."""
    d, shape = spec.dim, tuple(t.shape)
    v = t.reshape(shape[:d] + (spec.blocks, n, shape[d] // (spec.blocks * n)) + shape[d + 1:])
    return v.select(d + 1, i).reshape(shape[:d] + (-1,) + shape[d + 1:]).contiguous()


@torch.no_grad()
def shard_params_tp(model: torch.nn.Module, mesh: Mesh,
                    rules: Sequence[TPRule] = FFT_TRANSFORMER_TP_RULES) -> torch.nn.Module:
    """Keep this rank's slices of the parameters ``rules`` shard on the
    mesh's model axis (in place; build the optimizer after), and give the
    blocks that own them the mesh."""
    for name, spec in tp_param_specs(model, rules, mesh.n_model).items():
        if spec is None:
            continue
        p = model.get_parameter(name)
        p.data = local_slice(p.data, spec, mesh.n_model, mesh.model_index)
        model.get_submodule(_owner(name)).tp = mesh
    return model


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x``, whose gradient is summed over the model group: where a
    replicated tensor enters a column-parallel layer."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over the model group: after a
    row-parallel layer."""
    return _ReduceFromModel.apply(x, mesh.model_group)
