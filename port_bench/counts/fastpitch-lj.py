"""FLOPs of the ``fastpitch-lj`` configuration: serving, FastPitch's
inference and the HiFi-GAN generator, counted from the published widths at
an utterance's own length (``tokens`` symbols, ``frames`` mel frames), not
at the padded shapes the program computes; and a training micro-step
(:func:`train_flops`), at a batch's padded shapes."""

from __future__ import annotations

from ._layers import conv, generator_flops

__all__ = ["fft_stack", "fastpitch_flops", "utterance_flops", "aligner_flops", "train_flops"]


def fft_stack(n_layers: int, t: int, d: int, heads: int, d_head: int, inner: int, k: int) -> int:
    """A stack of FFT blocks over ``t`` positions."""
    hd = heads * d_head
    per = (2 * t * d * 3 * hd          # qkv
           + 2 * 2 * heads * t * t * d_head  # scores and the weighted sum
           + 2 * t * hd * d            # o
           + conv(t, d, inner, k) + conv(t, inner, d, k))
    return n_layers * per


def _predictor(t: int, d: int, filt: int, k: int, n_layers: int) -> int:
    return (conv(t, d, filt, k) + (n_layers - 1) * conv(t, filt, filt, k)
            + 2 * t * filt)


def fastpitch_flops(c: dict, tokens: int, frames: int) -> int:
    d = c["symbols_embedding_dim"]
    return (fft_stack(c["in_fft_n_layers"], tokens, d, c["in_fft_n_heads"], c["in_fft_d_head"],
                      c["in_fft_conv1d_filter_size"], c["in_fft_conv1d_kernel_size"])
            + _predictor(tokens, d, c["dur_predictor_filter_size"],
                         c["dur_predictor_kernel_size"], c["dur_predictor_n_layers"])
            + _predictor(tokens, d, c["pitch_predictor_filter_size"],
                         c["pitch_predictor_kernel_size"], c["pitch_predictor_n_layers"])
            + _predictor(tokens, d, c["energy_predictor_filter_size"],
                         c["energy_predictor_kernel_size"], c["energy_predictor_n_layers"])
            + conv(tokens, 1, d, c["pitch_embedding_kernel_size"])
            + conv(tokens, 1, d, c["energy_embedding_kernel_size"])
            + fft_stack(c["out_fft_n_layers"], frames, d, c["out_fft_n_heads"],
                        c["out_fft_d_head"], c["out_fft_conv1d_filter_size"],
                        c["out_fft_conv1d_kernel_size"])
            + 2 * frames * d * c["n_mel_channels"])


def utterance_flops(cfg: dict, tokens: int, frames: int) -> int:
    """Text → mel → audio of one utterance."""
    return fastpitch_flops(cfg["fastpitch"], tokens, frames) + generator_flops(cfg["vocoder"],
                                                                               frames)


def aligner_flops(c: dict, tokens: int, frames: int) -> int:
    """The aligner's key and query convs (its squared distances, a
    broadcast difference in the reference, count nothing)."""
    d, n_mel, n_attn = c["symbols_embedding_dim"], c["n_mel_channels"], c["n_attn_channels"]
    return (conv(tokens, d, 2 * d, 3) + conv(tokens, 2 * d, n_attn, 1)
            + conv(frames, n_mel, 2 * n_mel, 3) + conv(frames, 2 * n_mel, n_mel, 1)
            + conv(frames, n_mel, n_attn, 1))


def train_flops(cfg: dict, batch: int, tokens: int, frames: int) -> int:
    """One training micro-step of ``batch`` rows padded to ``tokens`` symbols
    and ``frames`` mel frames: the forward, then each product's input
    gradient and weight gradient, as much again each, but for the three
    convs whose input needs none (the aligner's first query conv on the mel,
    the pitch and energy embeddings on their targets)."""
    c = cfg["fastpitch"]
    d = c["symbols_embedding_dim"]
    forward = fastpitch_flops(c, tokens, frames) + aligner_flops(c, tokens, frames)
    no_input_grad = (conv(frames, c["n_mel_channels"], 2 * c["n_mel_channels"], 3)
                     + conv(tokens, 1, d, c["pitch_embedding_kernel_size"])
                     + conv(tokens, 1, d, c["energy_embedding_kernel_size"]))
    return batch * (3 * forward - no_input_grad)
