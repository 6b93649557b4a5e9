"""neuraltexttospeech_torch — the PyTorch/CUDA port of ``neuraltexttospeech_tpu``.

It mirrors the JAX package's layout and names, so each module here has a
counterpart there that it is tested against on the CPU:

- ``text``    — the text front-end (a verbatim copy).
- ``audio``   — STFT / mel-filterbank front-end; on a CUDA tensor the log-mel
                goes through the hand-written kernel in ``ops``.
- ``ops``     — CUDA C++ kernels for Hopper (``ops/csrc``), each beside its
                plain PyTorch twin: the log-mel (B1) and the MSD's
                tap-window grouped GEMM (B2).
- ``nn``      — shared layers, the FFT transformer stack, weight/spectral
                norm, the MSD's folded grouped conv.
- ``models``  — FastPitch (inference), HiFi-GAN (generator, discriminators,
                losses) and its GAN training step.
- ``data``    — filelists, the vocoder dataset, prefetching.
- ``train``   — checkpoints.
- ``convert`` — flax parameter trees to PyTorch state dicts.
- ``cli``     — the serving entry points (text → wav, mel/wav → wav) and the
                HiFi-GAN trainer.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no such request they raise. The package never imports
JAX or the JAX package.
"""
