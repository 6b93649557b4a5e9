"""Entry points: ``fastpitch_infer`` (text → mel → wav), ``hifigan_infer``
(mel or wav → wav) and ``hifigan_train`` (HiFi-GAN GAN training)."""
