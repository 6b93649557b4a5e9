"""neuraltexttospeech_torch — the PyTorch/CUDA port of ``neuraltexttospeech_tpu``.

It mirrors the JAX package's layout and names, so each module here has a
counterpart there that it is tested against on the CPU:

- ``text``    — the text front-end (a verbatim copy).
- ``audio``   — STFT / mel-filterbank front-end; on a CUDA tensor the log-mel
                goes through the hand-written kernel in ``ops``.
- ``ops``     — CUDA C++ kernels for Hopper (``ops/csrc``), each beside its
                plain PyTorch twin.
- ``nn``      — shared layers and the FFT transformer stack.
- ``models``  — FastPitch (inference) and the HiFi-GAN generator.
- ``convert`` — flax parameter trees to PyTorch state dicts.
- ``cli``     — the serving entry points (text → wav, mel/wav → wav).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no such request they raise. The package never imports
JAX or the JAX package.
"""
