"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``neuraltexttospeech_tpu/parallel``): the ('data', 'model') mesh and its
helpers, joining a multi-process run, and the FFT transformer's
tensor-parallel layouts. JAX's ``P`` and ``data_sharding`` name XLA
shardings and have no counterpart; ``tp.Shard`` is the layout of one
parameter."""

from .distributed import initialize_distributed, launch
from .mesh import (
    DATA_AXIS, MODEL_AXIS, global_count, global_draw, global_mean, make_mesh, replicated,
    shard_batch,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "make_mesh", "replicated", "shard_batch",
           "initialize_distributed", "launch", "global_count", "global_mean", "global_draw"]
