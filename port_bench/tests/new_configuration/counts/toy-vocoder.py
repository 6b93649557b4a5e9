"""Counts of the stand-in ``toy-vocoder`` configuration: none, since no
metric of its cell reads FLOPs or bytes; the harness loads a
configuration's counts file for every cell."""
