"""flax-exact weight norm and spectral norm for the port's convs.

``torch.nn.utils.weight_norm`` normalises over other axes than flax and has
no eps, and ``torch.nn.utils.spectral_norm`` keeps its power iteration in
another form, so neither matches the JAX package. Here, for a ``Conv1d``
weight ``[Cout, Cin/g, K]`` or a ``ConvTranspose1d`` weight ``[Cin, Cout, K]``
(dim 0 is the flax kernel's last axis in both):

- :class:`WeightNorm` (flax ``nn.WeightNorm``): ``w = v * rsqrt(sum v^2 +
  1e-12) * scale``, summed over every dim but 0, as a
  ``torch.nn.utils.parametrize`` parametrization with ``original0 = v`` and
  ``original1 = scale``;
- :class:`SpectralNorm` (flax 0.12 ``nn.SpectralNorm._spectral_normalize``):
  one power step from the stored ``u [1, Cout]`` with eps 1e-12, ``u`` and
  ``v`` under stop-gradient, ``sigma = v W u^T``; ``w / sigma``. With
  ``update_stats=True`` the new ``u`` and ``sigma`` are stored, so a second
  call in the same step starts from the ``u`` that the first one wrote, as in
  flax.

With tracing on (``utils/profiling.py``) each computation of either counts
as ``norms.weight_norm``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize

from ..utils.profiling import count

__all__ = ["WeightNorm", "SpectralNorm", "weight_norm", "folded_state_dict"]

EPS = 1e-12


def _l2_normalize(x: torch.Tensor, dims) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=dims, keepdim=True) + EPS)


class WeightNorm(nn.Module):
    """Parametrization ``(v, scale) -> v * rsqrt(sum v^2 + 1e-12) * scale``."""

    def forward(self, v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        count("norms.weight_norm")
        dims = tuple(range(1, v.ndim))
        return _l2_normalize(v, dims) * scale.reshape((-1,) + (1,) * (v.ndim - 1))

    def right_inverse(self, w: torch.Tensor):
        dims = tuple(range(1, w.ndim))
        return w, torch.sqrt((w * w).sum(dim=dims) + EPS)


def weight_norm(module: nn.Module) -> nn.Module:
    """Register :class:`WeightNorm` on ``module.weight``; its current weight
    becomes ``v`` and its per-channel norm ``scale``."""
    parametrize.register_parametrization(module, "weight", WeightNorm(), unsafe=True)
    return module


def folded_state_dict(module: nn.Module) -> dict:
    """``module``'s state dict with every parametrized weight folded into a
    plain one (the serving layout)."""
    out = {}
    for key, value in module.state_dict().items():
        if ".parametrizations." not in key:
            out[key] = value
    for name, sub in module.named_modules():
        if parametrize.is_parametrized(sub):
            for pname in sub.parametrizations:
                out[f"{name}.{pname}" if name else pname] = getattr(sub, pname).detach()
    return out


class SpectralNorm(nn.Module):
    """Power-iteration state of one weight: buffers ``u [1, Cout]`` and
    ``sigma []``. ``forward(w, update_stats)`` returns ``w / sigma``."""

    def __init__(self, out_features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.register_buffer("u", torch.randn(1, out_features, generator=generator))
        self.register_buffer("sigma", torch.ones(()))

    def forward(self, w: torch.Tensor, update_stats: bool) -> torch.Tensor:
        count("norms.weight_norm")
        mat = w.reshape(w.shape[0], -1)  # [Cout, rest]: flax's (-1, Cout) transposed
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat, (-1,))
            u = _l2_normalize(v @ mat.t(), (-1,))
        sigma = (u @ mat @ v.t())[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
