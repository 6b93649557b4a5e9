"""Share of the traced stretch of the FastPitch training window in which no
operation ran on the device, in %: the
``device_idle_pct.train`` reader's code, under the name that the FastPitch training
cell reports, whose metrics move ``train_audio_s_per_device_s``."""

import pathlib

from port_bench.reference import load_by_path

read = load_by_path(pathlib.Path(__file__).with_name("device_idle_pct.train.py"),
                    "port_bench.metrics").read
