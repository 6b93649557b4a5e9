"""The PyTorch port stands alone: no JAX, no JAX package, no CPU fallback.

``neuraltexttospeech_torch``, ``chip_smoke.py`` and the port's tools
(``tools/torch_*.py``) import neither ``jax`` nor ``flax`` nor
``neuraltexttospeech_tpu`` (not even its pure-Python modules), and their
entry points run on the card unless the caller asks for the CPU.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "neuraltexttospeech_torch"
FORBIDDEN = ("jax", "flax", "neuraltexttospeech_tpu")


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(extra)
    return env


def test_package_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import neuraltexttospeech_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, 'neuraltexttospeech_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert callable(importlib.import_module(P.__name__ + '.convert').tacotron2_from_flax)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(names), bad)\n"
        "print(' '.join(names))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20  # every submodule was imported
    for name in ("models.talknet", "data.asr_dataset", "cli.talknet_train",
                 "cli.talknet_infer", "nn.rnn", "models.tacotron2", "models.tacotron2_train",
                 "cli.tacotron2_prepare_dataset", "cli.tacotron2_train", "cli.tacotron2_infer",
                 "models.flowtron", "cli.flowtron_train", "cli.flowtron_infer", "cli.dump_mels",
                 "cli.align_from_fastpitch", "cli.export", "parallel.distributed",
                 "parallel.mesh", "parallel.tp", "utils.profiling", "utils.plotting"):
        assert f"neuraltexttospeech_torch.{name}" in out.stdout.split(), name


def test_no_forbidden_import_statements():
    pat = re.compile(r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")\b", re.M)
    files = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("torch_*.py")))
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text(encoding="utf-8"))]
    assert not hits, hits
    scanned = {f.name for f in files}
    assert {"torch_trace_capture.py", "torch_trace_breakdown.py",
            "torch_audio_compare.py"} <= scanned, scanned


def test_port_tools_import_without_jax():
    names = sorted(f.stem for f in (ROOT / "tools").glob("torch_*.py"))
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module('tools.' + n)\n"
        "import tools.torch_trace_capture as t\n"
        "from neuraltexttospeech_torch.utils import profiling\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert {"torch_trace_capture", "torch_trace_breakdown", "torch_audio_compare"} <= set(names)


def test_chip_smoke_fails_without_gpu():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         env=_clean_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory, the script gets past the device check (stubbed
    to say a card is there) and fails at the import of the package."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    code = ("import runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    env = _clean_env()
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "No module named 'neuraltexttospeech_torch'" in out.stderr, out.stderr[-2000:]
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("cli", ["fastpitch_infer", "hifigan_infer", "diffwave_infer",
                                 "gradtts_infer", "fastspeech2_infer", "talknet_infer",
                                 "tacotron2_infer", "flowtron_infer"])
def test_cli_without_device_raises_when_no_gpu(cli, tmp_path):
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    mod = importlib.import_module(f"neuraltexttospeech_torch.cli.{cli}")
    checkpoints = (["--duration-checkpoint", str(tmp_path), "--pitch-checkpoint", str(tmp_path),
                    "--spectrogram-checkpoint", str(tmp_path)] if cli == "talknet_infer"
                   else ["--checkpoint", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(checkpoints + ["-i", str(tmp_path / "in.txt"), "-o", str(tmp_path / "out")])


def test_resolve_device_policy():
    import torch

    from neuraltexttospeech_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


@pytest.mark.parametrize("cli", ["diffwave_train", "hifigan_train", "fastpitch_train",
                                 "gradtts_train", "fastspeech2_train",
                                 "fastspeech2_prepare_dataset", "talknet_train",
                                 "tacotron2_prepare_dataset", "tacotron2_train"])
def test_trainer_cli_without_device_raises_when_no_gpu(cli, tmp_path):
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    mod = importlib.import_module(f"neuraltexttospeech_torch.cli.{cli}")
    argv = {"fastspeech2_train": ["-o", str(tmp_path / "out"), "-d", str(tmp_path / "feats")],
            "fastspeech2_prepare_dataset": ["--raw-path", str(tmp_path / "raw"),
                                            "--textgrid-path", str(tmp_path / "tg"),
                                            "--out-dir", str(tmp_path / "out")],
            "talknet_train": ["--model", "asr", "-o", str(tmp_path / "out"), "-d",
                              str(tmp_path / "list.txt")],
            "tacotron2_prepare_dataset": ["-d", str(tmp_path / "feats"), "--training-files",
                                          str(tmp_path / "list.txt")],
            }.get(cli, ["-o", str(tmp_path / "out"), "--training-files",
                        str(tmp_path / "list.txt")])
    if cli in ("fastpitch_train", "gradtts_train", "tacotron2_train"):
        argv += ["-d", str(tmp_path / "feats")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
