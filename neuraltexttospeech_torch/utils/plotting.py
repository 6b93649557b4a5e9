"""Spectrogram and alignment plots (counterpart of
``neuraltexttospeech_tpu/utils/plotting.py``, :11-56; reference
``HiFiGAN_TF/utils.py:11-22``, ``Grad-TTS_TF/utils.py:24-45``).

matplotlib is imported inside the functions, with the ``Agg`` backend:
nothing else of the port needs it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_spectrogram", "plot_alignment", "save_figure_to_numpy"]


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _as_numpy(x) -> np.ndarray:
    """numpy view of an array or a (card) tensor."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def plot_spectrogram(spectrogram, title=None):
    """[T, n_mel] or [n_mel, T] → matplotlib Figure."""
    plt = _pyplot()
    spec = _as_numpy(spectrogram)
    if spec.shape[0] > spec.shape[1]:
        spec = spec.T
    fig, ax = plt.subplots(figsize=(10, 3))
    im = ax.imshow(spec, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bins")
    if title:
        ax.set_title(title)
    fig.canvas.draw()
    plt.close(fig)
    return fig


def plot_alignment(alignment, title=None):
    """[T_mel, T_text] attention map → matplotlib Figure."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(_as_numpy(alignment).T, aspect="auto", origin="lower",
                   interpolation="none")
    plt.colorbar(im, ax=ax)
    ax.set_xlabel("decoder step")
    ax.set_ylabel("encoder step")
    if title:
        ax.set_title(title)
    fig.canvas.draw()
    plt.close(fig)
    return fig


def save_figure_to_numpy(fig) -> np.ndarray:
    """Figure → HWC uint8 array (an image summary's pixels)."""
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3]
