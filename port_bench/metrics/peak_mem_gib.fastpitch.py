"""The allocator's peak over the FastPitch training window, in GiB: the
``peak_mem_gib.train`` reader's code, under the name that the FastPitch training
cell reports, whose metrics move ``train_audio_s_per_device_s``."""

import pathlib

from port_bench.reference import load_by_path

read = load_by_path(pathlib.Path(__file__).with_name("peak_mem_gib.train.py"),
                    "port_bench.metrics").read
