"""Host milliseconds from a FastPitch micro-step's call to its return,
before any synchronisation (the CTC's read of the lengths waits for the
forward inside it), over every micro-step of the window: the
``host_issue_ms.train`` reader's code, under the name that the FastPitch training
cell reports, whose metrics move ``train_audio_s_per_device_s``."""

import pathlib

from port_bench.reference import load_by_path

read = load_by_path(pathlib.Path(__file__).with_name("host_issue_ms.train.py"),
                    "port_bench.metrics").read
