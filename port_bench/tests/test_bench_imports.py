"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import json
import pathlib
import subprocess
import sys

from port_bench.harness import forbidden_modules

REPO = pathlib.Path(__file__).resolve().parents[2]


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    assert forbidden_modules() == []
    for name in ("jax_like", "flaxen", "neuraltexttospeech_torch", "neuraltexttospeech_tpu_x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert forbidden_modules() == []
    for name in ("jax.numpy", "jaxlib", "flax.linen", "neuraltexttospeech_tpu.models"):
        monkeypatch.setitem(sys.modules, name, object())
    assert forbidden_modules() == ["flax", "jax", "jaxlib", "neuraltexttospeech_tpu"]


def _loaded_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_and_the_yardstick_load_nothing_of_the_program():
    loaded = _loaded_after(
        "import pathlib\n"
        "from port_bench.reference import load_by_path\n"
        "import port_bench.reference.nets, port_bench.reference.text\n"
        "import port_bench.yardstick.judge, port_bench.yardstick.bounds\n"
        "import port_bench.yardstick.breakdown, port_bench.yardstick.traffic\n"
        "for d in ('reference', 'counts'):\n"
        "    for f in pathlib.Path('port_bench', d).glob('*-*.py'):\n"
        "        load_by_path(f, 'port_bench.' + d)\n")
    assert not loaded & {"neuraltexttospeech_torch", "neuraltexttospeech_tpu", "jax", "jaxlib",
                         "flax"}


def test_the_harness_loads_no_jax():
    loaded = _loaded_after("import port_bench.harness, port_bench.faults, port_bench.calibrate")
    assert not loaded & {"neuraltexttospeech_tpu", "jax", "jaxlib", "flax"}


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "fastpitch-lj.serve-doc", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
