"""Serving entry points: ``fastpitch_infer`` (text → mel → wav) and
``hifigan_infer`` (mel or wav → wav)."""
