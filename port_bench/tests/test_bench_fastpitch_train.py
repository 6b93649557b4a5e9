"""The FastPitch training cell's reference against the port, on the CPU: the
plain MAS against the port's plain twin, tie for tie; and the reference's
tiny training micro-steps against the port's ``Trainer`` steps from the same
weights, with the dropout masks the program drew, in f32."""

import pathlib
import time

import torch

from port_bench.drivers.fastpitch_train import train_reference
from port_bench.harness import run

from ._tiny import REPO, overrides

BENCH = REPO / "port_bench"


def test_plain_mas_is_the_ports_path():
    from neuraltexttospeech_torch.ops.mas_kernel import maximum_path_reference

    ref = train_reference(BENCH, "fastpitch-lj")
    gen = torch.Generator().manual_seed(3)
    log_attn = torch.log_softmax(torch.randn(6, 60, 17, generator=gen), -1)
    log_attn = torch.round(log_attn * 4) / 4  # coarse values: many exact ties
    in_lens = torch.tensor([17, 9, 1, 12, 17, 5])
    out_lens = torch.tensor([60, 30, 7, 59, 17, 5])
    assert torch.equal(ref.mas(log_attn, in_lens, out_lens),
                       maximum_path_reference(log_attn, in_lens, out_lens))


def test_the_reference_steps_are_the_trainers_steps():
    """Four micro-steps (two LAMB updates) at the traffic's own lengths and a
    small width, the program in f32 with TF32 off. Bounds: MAS's path is
    exact; the losses differ by the prior, which the port makes in f32
    ``lgamma`` and the reference in float64 (the port documents it within
    2e-3 of the pmf), and by f32 rounding, the gradients by rounding; a
    parameter's change by the zero biases whose gradient is rounding noise
    in part (the keys' biases under softmax), which LAMB steps by about
    ``lr`` an element whatever the sign."""
    cfg, mix = overrides("fastpitch-lj.train")
    result, checks = run("fastpitch-lj.train", 2 ** 31 + 19, 0.2, False, torch.device("cpu"),
                         pathlib.Path(REPO / "BENCHMARK.json"), time.time(),
                         dict(cfg, precision="f32"), mix)
    got = {k: v for k, v, _ in checks}
    assert got["mas"] == 0
    assert got["loss"] < 1e-4
    assert got["grad"] < 1e-5 and got["grad.median"] < 1e-6
    assert got["update"] < 0.05
    assert result["correct"] is True
