"""Tacotron 2's modules in the port against the JAX package, on the CPU.

- ``nn/rnn.py``: ``LSTMCell`` against flax's ``LSTMCell`` and
  ``OptimizedLSTMCell`` (f32, and bf16 by the yardstick), and ``run_rnn``
  forward and reversed (``reverse=True, keep_order=True``) with ragged
  ``seq_lengths`` against ``nn.RNN``, every position, at 1e-6;
  ``flip_sequences`` exactly; ``BiLSTM`` (the CPU loop) against the
  encoder's pair of ``nn.RNN``s;
- the committed ``tacotron2`` golden (``tools/make_goldens.py:162-204``)
  through ``convert.tacotron2_from_flax``: ``mel_out``, ``mel_post``,
  ``gate`` and ``align`` at the goldens' 1e-5;
- at ``tests/test_tacotron2.py``'s ``TINY`` with random weights and
  BatchNorm statistics drawn with numpy: the train-mode forward and the
  BatchNorm buffers after it at 1e-5 (JAX's dropout passed through by
  ``monkeypatch``, the port without a generator); ``tacotron2_loss`` and
  ``gate_targets``; ``infer`` in both forms (the scan, and the while loop of
  ``early_stop``) with the prenet deterministic: ``mel_lengths`` equal and
  the mels, gates and alignments at 1e-4, where every row runs to the cap,
  where the rows stop at different steps, and where all stop early; the
  ``dtype=bf16`` forward by the bf16 yardstick of ``test_torch_bf16.py``.

``pytest -s`` prints each comparison's largest difference.
"""

import contextlib
import dataclasses
import pathlib
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.convert import tacotron2_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import tacotron2 as port_t2  # noqa: E402
from neuraltexttospeech_torch.models.tacotron2_train import gate_targets  # noqa: E402
from neuraltexttospeech_torch.nn import rnn as port_rnn  # noqa: E402
from neuraltexttospeech_tpu.models import tacotron2 as jax_t2  # noqa: E402
from neuraltexttospeech_tpu.models import tacotron2_train as jax_t2_train  # noqa: E402
from test_tacotron2 import TINY  # noqa: E402
from test_torch_bf16 import yardstick  # noqa: E402
from test_torch_talknet import _close, random_variables  # noqa: E402
from tools.make_goldens import GOLDEN_DIR  # noqa: E402

B, TT, TM = 3, 9, 20
T_DEC = TINY.max_decoder_steps


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def jax_dropout_off():
    """JAX's ``tacotron2`` module with an ``nn`` whose ``Dropout`` passes its
    input through (the prenet's is on unless ``prenet_deterministic``, and
    ``_infer_while`` never passes that); nothing in the JAX package changes."""
    view = types.SimpleNamespace(**{k: getattr(flax_nn, k) for k in dir(flax_nn)
                                    if not k.startswith("__")})
    view.Dropout = lambda rate, deterministic=None: (lambda x, deterministic=None: x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_t2, "nn", view)
        yield


def port_config(dtype=None, config=TINY):
    """The port's ``Tacotron2Config`` with the fields of a JAX one."""
    return port_t2.Tacotron2Config(**{f.name: getattr(config, f.name)
                                      for f in dataclasses.fields(config) if f.name != "dtype"},
                                   dtype=dtype)


def batch(seed):
    """A random padded batch of the trainer (numpy): text zero past its
    length, mels zero past theirs."""
    rng = np.random.default_rng(seed)
    lens, mel_lens = np.asarray([TT, 6, 3], np.int32), np.asarray([TM, 14, 7], np.int32)
    text = rng.integers(1, TINY.n_symbols, (B, TT)).astype(np.int32)
    text[np.arange(TT)[None] >= lens[:, None]] = 0
    mel = rng.standard_normal((B, TM, 80)).astype(np.float32)
    mel[np.arange(TM)[None] >= mel_lens[:, None]] = 0.0
    return {"text": text, "input_lens": lens, "mel": mel, "mel_lens": mel_lens}


def jax_variables(seed=1):
    b = batch(0)
    return random_variables(jax_t2.Tacotron2(TINY), seed, b["text"], b["input_lens"], b["mel"],
                            b["mel_lens"])


def port_model(variables, dtype=None):
    m = port_t2.Tacotron2(port_config(dtype))
    m.load_state_dict(tacotron2_from_flax(variables))
    return m


def _t(b):
    return {k: torch.as_tensor(np.array(v)) for k, v in b.items()}


# infer cases: the gate layer's kernel scale and bias. With the kernel
# negated and scaled 20×, the random decoder's gate logits rise step by step.
GATES = {"cap": (1.0, 0.0), "stops": (-20.0, -3.4), "all_stop": (-20.0, -2.6)}


def gated(variables, case):
    scale, bias = GATES[case]
    v = jax.tree_util.tree_map(np.array, variables)
    v["params"]["cell"]["gate_layer"]["kernel"] *= scale
    v["params"]["cell"]["gate_layer"]["bias"][:] = bias
    return v


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's outputs at ``TINY`` for one draw of the variables, each program
    compiled at once in threads: the train-mode forward (with the new
    batch statistics) in f32 and bf16 (bf16 compiled with XLA's excess
    precision off), the eval forward in both, and ``infer`` in both forms
    for each gate case."""
    variables = jax_variables()
    b = batch(2)
    args = (b["text"], b["input_lens"], b["mel"], b["mel_lens"])

    def forward(dtype, train):
        model = jax_t2.Tacotron2(dataclasses.replace(TINY, dtype=dtype))
        options = {} if dtype is None else {"xla_allow_excess_precision": False}
        fn = jax.jit(lambda v, *a: model.apply(v, *a, train=train, mutable=["batch_stats"],
                                               prenet_deterministic=True),
                     compiler_options=options)
        out, mut = fn(variables, *args)
        return _np(out), _np(mut["batch_stats"])

    def infer(case, early_stop):
        model = jax_t2.Tacotron2(TINY)
        fn = jax.jit(lambda v, t, l: model.apply(
            v, t, l, method=jax_t2.Tacotron2.infer, early_stop=early_stop,
            prenet_deterministic=True, rngs={"dropout": jax.random.PRNGKey(0)}))
        return _np(fn(gated(variables, case), b["text"], b["input_lens"]))

    jobs = {}
    with jax_dropout_off(), ThreadPoolExecutor(8) as pool:
        for dtype in (None, jnp.bfloat16):
            for train in (True, False):
                jobs["forward", dtype, train] = pool.submit(forward, dtype, train)
        for case in GATES:
            for early_stop in (False, True):
                jobs["infer", case, early_stop] = pool.submit(infer, case, early_stop)
        return {"variables": variables, "batch": b,
                **{k: f.result() for k, f in jobs.items()}}


# ---------------------------------------------------------------------- LSTM

@pytest.mark.parametrize("cls", ["LSTMCell", "OptimizedLSTMCell"])
def test_lstm_cell_matches_flax(cls):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 12)).astype(np.float32)
    c, h = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2))
    flax_cell = getattr(flax_nn, cls)(8)
    params = random_variables(flax_cell, 4, (c, h), x)
    (want_c, want_h), want_y = flax_cell.apply(params, (c, h), x)
    cell = port_rnn.LSTMCell(12, 8)
    sd = tacotron2_lstm_state(params["params"])
    cell.load_state_dict(sd)
    (got_c, got_h), got_y = cell((torch.as_tensor(c), torch.as_tensor(h)), torch.as_tensor(x))
    for what, got, want in (("c", got_c, want_c), ("h", got_h, want_h), ("y", got_y, want_y)):
        _close(f"{cls} {what}", got, want, atol=1e-6, rtol=1e-6)


def tacotron2_lstm_state(params):
    """One flax LSTM cell's params → ``nn/rnn.py::LSTMCell``'s state dict,
    through the converter's own mapping."""
    from neuraltexttospeech_torch.convert import _lstm, _Reader, _plain

    sd, r = {}, _Reader(_plain(params))
    _lstm(sd, "cell", r)
    r.finish()
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


def test_lstm_cell_bf16_matches_flax():
    """``dtype=bf16`` as flax's: bf16 gates against the f32 carry."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 12)).astype(np.float32)
    c, h = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2))
    params = random_variables(flax_nn.LSTMCell(8), 6, (c, h), x)
    want = {dt: flax_nn.LSTMCell(8, dtype=dt).apply(params, (c, h), x)
            for dt in (jnp.bfloat16, jnp.float32)}
    cell = port_rnn.LSTMCell(12, 8, dtype=torch.bfloat16)
    cell.load_state_dict(tacotron2_lstm_state(params["params"]))
    (got_c, got_h), _ = cell((torch.as_tensor(c), torch.as_tensor(h)), torch.as_tensor(x))
    assert got_c.dtype == got_h.dtype == torch.float32  # f·c and o·tanh(c) promote to f32
    for i, what in enumerate(("c", "h")):
        yardstick(f"LSTMCell {what}", (got_c, got_h)[i].detach().numpy(),
                  want[jnp.bfloat16][0][i], want[jnp.float32][0][i])


def test_flip_sequences_matches_flax():
    from flax.linen.recurrent import flip_sequences

    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    lens = np.asarray([5, 2], np.int32)
    want = np.asarray(flip_sequences(x, lens, num_batch_dims=1, time_major=False))
    got = port_rnn.flip_sequences(torch.as_tensor(x), torch.as_tensor(lens)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port_rnn.flip_sequences(torch.as_tensor(got), torch.as_tensor(lens)).numpy(), x)


@pytest.mark.parametrize("reverse", [False, True])
def test_run_rnn_matches_flax_rnn(reverse):
    """Every position, padding included (both run the cell over it)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 7, 6)).astype(np.float32)
    lens = np.asarray([7, 4, 1], np.int32)
    rnn = flax_nn.RNN(flax_nn.OptimizedLSTMCell(5), reverse=reverse, keep_order=True)
    params = random_variables(rnn, 8, x, seq_lengths=lens)
    want = rnn.apply(params, x, seq_lengths=lens)
    cell = port_rnn.LSTMCell(6, 5)
    cell.load_state_dict(tacotron2_lstm_state(params["params"]["cell"]))
    got = port_rnn.run_rnn(cell, torch.as_tensor(x), torch.as_tensor(lens), reverse=reverse)
    _close(f"run_rnn reverse={reverse}", got, want, atol=1e-6, rtol=1e-6)


def test_bilstm_matches_the_encoders_pair():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 7, 6)).astype(np.float32)
    lens = np.asarray([7, 4, 1], np.int32)
    fwd = flax_nn.RNN(flax_nn.OptimizedLSTMCell(5))
    bwd = flax_nn.RNN(flax_nn.OptimizedLSTMCell(5), reverse=True, keep_order=True)
    pf, pb = (random_variables(m, s, x, seq_lengths=lens) for m, s in ((fwd, 10), (bwd, 11)))
    want = np.concatenate([fwd.apply(pf, x, seq_lengths=lens),
                           bwd.apply(pb, x, seq_lengths=lens)], -1)
    bi = port_rnn.BiLSTM(6, 5)
    bi.fwd.load_state_dict(tacotron2_lstm_state(pf["params"]["cell"]))
    bi.bwd.load_state_dict(tacotron2_lstm_state(pb["params"]["cell"]))
    _close("BiLSTM", bi(torch.as_tensor(x), torch.as_tensor(lens)), want, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------- golden

def test_golden_matches():
    from flax import serialization

    variables = serialization.msgpack_restore((GOLDEN_DIR / "tacotron2.msgpack").read_bytes())
    want = np.load(GOLDEN_DIR / "tacotron2_golden.npz")
    # tools/make_goldens.py::tacotron2: TINY's config, then the batch's draws
    model = port_t2.Tacotron2(port_config())
    model.load_state_dict(tacotron2_from_flax(variables))
    model.eval()
    rng = np.random.default_rng(103)
    text = torch.as_tensor(rng.integers(1, 40, (2, 9)).astype(np.int32))
    lens = torch.as_tensor(np.asarray([9, 6], np.int32))
    mel = torch.as_tensor(rng.standard_normal((2, 20, 80)).astype(np.float32))
    with torch.no_grad():
        out = model(text, lens, mel, torch.as_tensor(np.asarray([20, 14], np.int32)))
    for key, got in zip(("mel_out", "mel_post", "gate", "align"), out):
        _close(f"golden tacotron2 {key}", got, want[key])


def test_conversion_raises_on_a_leaf_left_over(jax_runs):
    v = jax.tree_util.tree_map(np.array, jax_runs["variables"])
    v["params"]["cell"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unconsumed"):
        tacotron2_from_flax(v)


# --------------------------------------------------------------- forwards

@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(train, jax_runs):
    """Train mode: batch statistics, and the BatchNorm buffers after it;
    eval mode: the buffers. No dropout on either side."""
    want, want_stats = jax_runs["forward", None, train]
    model = port_model(jax_runs["variables"]).train(train)
    b = _t(jax_runs["batch"])
    with torch.no_grad():
        out = model(b["text"], b["input_lens"], b["mel"], b["mel_lens"])
    for key, got, w in zip(port_t2.Tacotron2Output._fields, out, want):
        if w is not None:
            _close(f"{'train' if train else 'eval'} forward {key}", got, w)
    sd = model.state_dict()
    want_sd = tacotron2_from_flax({"params": jax_runs["variables"]["params"],
                                   "batch_stats": want_stats})
    for k in (k for k in sd if "running" in k):
        _close(f"BatchNorm buffer {k}", sd[k], want_sd[k].numpy())
    moved = max((sd[k] - tacotron2_from_flax(jax_runs["variables"])[k]).abs().max().item()
                for k in sd if "running" in k)
    assert (moved > 1e-3) == train


def test_amp_forward_matches_jax_bf16(jax_runs):
    """``dtype=bf16`` against JAX's bf16 forward, by the yardstick; the
    encoder's BiLSTM and ``memory`` stay f32, the decoder computes in bf16."""
    for train in (True, False):
        want_b, _ = jax_runs["forward", jnp.bfloat16, train]
        want_f, _ = jax_runs["forward", None, train]
        model = port_model(jax_runs["variables"], torch.bfloat16).train(train)
        b = _t(jax_runs["batch"])
        with torch.no_grad():
            out = model(b["text"], b["input_lens"], b["mel"], b["mel_lens"])
            memory = model._encode(b["text"], b["input_lens"], None)[0]
        assert memory.dtype == torch.float32 and out.mel_out.dtype == torch.bfloat16
        for key, got, wb, wf in zip(port_t2.Tacotron2Output._fields, out, want_b, want_f):
            if wb is not None:
                yardstick(f"Tacotron 2 {'train' if train else 'eval'} {key}",
                          got.float().numpy(), wb.astype(np.float32), wf)


def test_loss_and_gate_targets_match_jax(jax_runs):
    b = jax_runs["batch"]
    want_g = np.asarray(jax_t2_train.gate_targets(jnp.asarray(b["mel_lens"]), TM))
    got_g = gate_targets(torch.as_tensor(b["mel_lens"]), TM)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    out, _ = jax_runs["forward", None, True]
    want_loss, want_meta = jax_t2.tacotron2_loss(jax_t2.Tacotron2Output(*out), b["mel"], want_g)
    port_out = port_t2.Tacotron2Output(*(torch.as_tensor(np.array(x)) for x in out[:4]))
    loss, meta = port_t2.tacotron2_loss(port_out, torch.as_tensor(b["mel"]), got_g)
    for k, got, want in (("loss", loss, want_loss), ("mel_loss", meta["mel_loss"],
                                                      want_meta["mel_loss"]),
                         ("gate_loss", meta["gate_loss"], want_meta["gate_loss"])):
        print(f"{k}: port {float(got):.8e}, JAX {float(want):.8e}")
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -------------------------------------------------------------------- infer

@pytest.mark.parametrize("early_stop", [False, True], ids=["scan", "while"])
@pytest.mark.parametrize("case", list(GATES))
def test_infer_matches_jax(case, early_stop, jax_runs):
    want = jax_runs["infer", case, early_stop]
    model = port_model(gated(jax_runs["variables"], case))
    b = _t(jax_runs["batch"])
    with torch.no_grad():
        out = model.infer(b["text"], b["input_lens"], early_stop=early_stop)
    lens = np.asarray(want.mel_lengths)
    np.testing.assert_array_equal(out.mel_lengths.numpy(), lens)
    if case == "cap":
        assert (lens == T_DEC).all()
    elif case == "stops":  # rows stop at different steps, one runs to the cap
        assert len(set(lens)) == B and lens.max() == T_DEC
    else:  # every row stops early: the while loop exits before the cap
        assert lens.max() < T_DEC
    assert model.training  # infer runs in eval mode and gives the mode back
    for key, got, w in zip(port_t2.Tacotron2Output._fields, out, want):
        _close(f"infer {case} {'while' if early_stop else 'scan'} {key}", got, w, atol=1e-4,
               rtol=1e-4)


def test_dropout_follows_the_generator_and_the_mode(jax_runs):
    """A generator drops out: in eval mode the prenet alone (the same seed,
    the same draws), in train mode every dropout; no generator, none."""
    model = port_model(jax_runs["variables"])
    b = _t(jax_runs["batch"])

    def run(train, seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model.train(train)(b["text"], b["input_lens"], b["mel"], b["mel_lens"],
                                      gen).mel_out_postnet

    plain = run(False, None)
    assert torch.equal(run(False, 3), run(False, 3)) and not torch.equal(run(False, 3), plain)
    assert not torch.equal(run(True, 3), run(True, 4))
    assert not torch.equal(run(True, 3), run(True, None))
