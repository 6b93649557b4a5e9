"""The training CLIs' shared epoch loop (``train/harness.py::Trainer.fit``) on
a toy model and loss, on the CPU.

- A run resumed from any of its checkpoints, one taken inside an epoch
  included, equals the straight run bit for bit: the same parameters and
  optimizer moments, the same ``position`` and the same ``data_rng`` (the
  dataset's generator, which draws each batch's noise and is left alone by
  the batches a resumed epoch skips).

No JAX here.
"""

import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig  # noqa: E402
from neuraltexttospeech_torch.train.state import OptimizerConfig  # noqa: E402

EPOCHS, STEPS, ROWS = 2, 3, 2  # steps an epoch, rows a batch


class ToyData:
    """Ten rows; each epoch a seeded order of them, and each batch the rows
    plus noise drawn from ``rng``, as the crops of ``VocoderDataset``."""

    def __init__(self):
        self.rng = np.random.default_rng(7)
        data = np.random.default_rng(0)
        self.x = data.standard_normal((10, 4)).astype(np.float32)
        self.y = data.standard_normal((10, 1)).astype(np.float32)

    def batches(self, epoch, skip):
        order = np.random.default_rng(epoch).permutation(len(self.x))
        for s in range(skip * ROWS, STEPS * ROWS, ROWS):
            rows = order[s:s + ROWS]
            noise = self.rng.standard_normal((ROWS, 4)).astype(np.float32)
            yield {"x": torch.as_tensor(self.x[rows] + noise), "y": torch.as_tensor(self.y[rows])}


def loss_fn(model, batch, generator):
    """A two-layer net with dropout drawn from the step's generator."""
    h = model[0](batch["x"])
    h = h * (torch.rand(h.shape, generator=generator) >= 0.5) * 2.0
    loss = torch.mean(torch.square(model[1](torch.tanh(h)) - batch["y"]))
    return loss, {"mse": loss}


def train(out, **kw):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 1))
    data = ToyData()
    trainer = Trainer(loss_fn, model,
                      TrainerConfig(optimizer=OptimizerConfig(learning_rate=1e-2), seed=3,
                                    checkpoint_dir=str(out), checkpoint_every=1,
                                    max_checkpoints=EPOCHS * STEPS),
                      torch.device("cpu"))
    result = trainer.fit(data.batches, EPOCHS, data_rng=data.rng, **kw)
    return trainer, data, result


def final_state(out):
    return torch.load(out / str(EPOCHS * STEPS) / "train_state.pt", weights_only=False)


@pytest.mark.parametrize("resume_at", [1, 3, 4])
def test_resumed_run_equals_the_straight_run(tmp_path, resume_at):
    straight, straight_data, done = train(tmp_path / "a")
    assert done["steps"] == EPOCHS * STEPS
    kept = torch.load(tmp_path / "a" / str(resume_at) / "train_state.pt", weights_only=False)
    # (epoch, batches done in it): taken inside its epoch, after the step's batch
    assert tuple(kept["position"]) == ((resume_at - 1) // STEPS, (resume_at - 1) % STEPS + 1)

    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / str(resume_at), tmp_path / "b" / str(resume_at))
    resumed, resumed_data, rest = train(tmp_path / "b", resume=True)
    assert rest["steps"] == EPOCHS * STEPS - resume_at
    assert resumed.step == straight.step == EPOCHS * STEPS
    for k, v in straight.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, rtol=0, atol=0)
    assert resumed_data.rng.bit_generator.state == straight_data.rng.bit_generator.state
    a, b = final_state(tmp_path / "a"), final_state(tmp_path / "b")
    assert tuple(a["position"]) == tuple(b["position"]) == (EPOCHS - 1, STEPS)
    assert a["data_rng"] == b["data_rng"]
    assert a["trainer"]["optimizer"]["count"] == b["trainer"]["optimizer"]["count"]
    for name in ("mu", "nu"):
        for x, y in zip(a["trainer"]["optimizer"][name], b["trainer"]["optimizer"][name],
                        strict=True):
            torch.testing.assert_close(y, x, rtol=0, atol=0)
