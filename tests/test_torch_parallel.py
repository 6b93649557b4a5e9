"""Data and tensor parallelism of the port (``neuraltexttospeech_torch/parallel``).

JAX's sharded step is one jitted function over the global batch, so it
equals the one-device step up to reduction order (``tests/test_multichip.py``).
The port runs one eager step per rank, and these tests hold that it keeps
JAX's semantics:

- ``initialize_distributed`` is a no-op without a configured run
  (``tests/test_misc.py:50-54``);
- the port's tensor-parallel rules shard the same 12 FastPitch parameters
  as JAX's (``tests/test_tp.py:59-69``), mapped through ``convert.py``, and
  split ``qkv`` by whole heads of q, k and v;
- two gloo processes on the CPU (``tools/torch_parallel_check.py``): a
  FastPitch step and a TalkNet 2 spectrogram step with ragged lengths,
  dropout on and BatchNorm equal the one-process step on the global batch
  (loss at rtol 2e-5, gradients at rtol/atol 2e-4, the BatchNorm buffers
  equal on both ranks), and so does a 2-head FastPitch on a 1 × 2 model
  axis. The run fails at its own timeout rather than hang;
- in the same run, with dropout off, each rank's sharded FastPitch and
  TalkNet 2 step from weights the JAX package initialised equals JAX's
  one-device loss, gradients and BatchNorm statistics on the same global
  ragged batch (``jax.value_and_grad``; loss and BatchNorm buffers at rtol
  2e-5, gradients at rtol/atol 2e-4);
- under ``slow`` (outside tier-1, as JAX's multi-device tests): the dp = 4
  matrix of the seven ``Trainer`` families, the QuartzNet ASR (with the
  CLI's WER over the ranks' transcripts) and the GAN step, dp × tp
  (2 × 2), and a 2-process run joined from the environment variables.
"""

import dataclasses
import importlib
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraltexttospeech_torch import parallel
from neuraltexttospeech_torch.convert import fastpitch_train_from_flax, talknet_from_flax
from neuraltexttospeech_torch.models.fastpitch import FastPitch as PortFastPitch
from neuraltexttospeech_torch.models.fastpitch import FastPitchConfig as PortConfig
from neuraltexttospeech_torch.nn.transformer import FFTransformer
from neuraltexttospeech_torch.parallel.tp import local_slice, tp_param_specs
from neuraltexttospeech_tpu.models import talknet as jax_tn
from neuraltexttospeech_tpu.models.fastpitch import FastPitch, FastPitchConfig
from neuraltexttospeech_tpu.models.gradtts import generate_path as jax_generate_path
from neuraltexttospeech_tpu.ops.prior import beta_binomial_prior
from neuraltexttospeech_tpu.parallel.tp import FFT_TRANSFORMER_TP_RULES
from neuraltexttospeech_tpu.parallel.tp import tp_param_specs as jax_tp_param_specs
from neuraltexttospeech_tpu.utils.masking import mask_from_lens as jax_mask
from test_torch_talknet import jax_dropout_off, random_variables
from tools.torch_parallel_check import (DP_CASES, FP_CFG, TN_BACKBONE, TN_HEAD, fastpitch_case,
                                        passed, run, talknet_case)

jax_fp_loss = importlib.import_module("neuraltexttospeech_tpu.models.fastpitch_loss")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_tp.py's CFG: 2 heads of 8 in each FFT stack
CFG = dict(n_symbols=40, symbols_embedding_dim=32, in_fft_n_layers=1, in_fft_n_heads=2,
           in_fft_d_head=8, in_fft_conv1d_filter_size=64, out_fft_n_layers=1,
           out_fft_n_heads=2, out_fft_d_head=8, out_fft_conv1d_filter_size=64,
           dur_predictor_filter_size=16, pitch_predictor_filter_size=16,
           energy_predictor_filter_size=16)
RUN_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
            "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def test_initialize_distributed_single_process_noop(monkeypatch):
    for name in RUN_VARS:
        monkeypatch.delenv(name, raising=False)
    assert parallel.initialize_distributed() is False
    assert parallel.launch("cpu", 16) == (torch.device("cpu"), None)
    assert not torch.distributed.is_initialized()


def _jax_params(heads):
    cfg = FastPitchConfig(**{**CFG, "in_fft_n_heads": heads, "out_fft_n_heads": heads})
    B, Tt, Tm = 2, 8, 16
    args = (jax.numpy.ones((B, Tt), jax.numpy.int32), jax.numpy.full((B,), Tt),
            jax.numpy.zeros((B, Tm, 80)), jax.numpy.full((B,), Tm),
            jax.numpy.zeros((B, 1, Tm)), jax.numpy.zeros((B, Tm)), None,
            jax.numpy.ones((B, Tm, Tt)))
    return jax.eval_shape(lambda: FastPitch(cfg).init(jax.random.PRNGKey(0), *args))


@pytest.mark.parametrize("heads,axis,n_port,n_jax", [(2, None, 12, 12), (2, 2, 12, 12),
                                                      (1, 2, 8, 12)])
def test_tp_specs_shard_the_parameters_jax_shards(heads, axis, n_port, n_jax):
    """Each JAX leaf is filled with its own index and carried through
    ``convert.py``: the port's sharded parameters are the images of JAX's.
    With one head (FastPitch's default) on a model axis of 2 the port
    replicates qkv, which JAX splits by features (ROADMAP §C)."""
    shapes = _jax_params(heads)
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(s.shape, i, np.float32) for i, s in enumerate(leaves)])
    jax_specs = jax.tree_util.tree_leaves(
        jax_tp_param_specs(shapes, FFT_TRANSFORMER_TP_RULES, model_axis_size=axis),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    jax_sharded = {i for i, s in enumerate(jax_specs) if s != jax.sharding.PartitionSpec()}
    assert len(jax_sharded) == n_jax

    state = fastpitch_train_from_flax(jax.tree_util.tree_map(np.asarray, marked))
    model = PortFastPitch(PortConfig(**{**CFG, "in_fft_n_heads": heads,
                                        "out_fft_n_heads": heads}))
    model.load_state_dict(state)
    specs = tp_param_specs(model, model_axis_size=axis)
    sharded = {n for n, s in specs.items() if s is not None}
    assert len(sharded) == n_port
    images = {n: set(np.unique(state[n].numpy()).astype(int)) for n in sharded}
    assert all(len(v) == 1 for v in images.values()), images
    assert {next(iter(v)) for v in images.values()} <= jax_sharded
    if heads == 2:
        assert {next(iter(v)) for v in images.values()} == jax_sharded


def test_qkv_shard_is_the_heads_slice():
    """Rank r of 2 holds heads [2r, 2r + 2) of q, k and v: the H-slice of
    the ``[3, H, D]`` view of qkv's output features, and o's matching input
    features."""
    torch.manual_seed(0)
    stack = FFTransformer(1, 4, 16, 4, 32, 3, embed_input=False)
    specs = tp_param_specs(stack, model_axis_size=2)
    w, b = stack.layers[0].attn.qkv.weight, stack.layers[0].attn.qkv.bias
    o = stack.layers[0].attn.o.weight
    for r in range(2):
        got = local_slice(w, specs["layers.0.attn.qkv.weight"], 2, r)
        want = w.view(3, 4, 4, 16)[:, 2 * r:2 * r + 2].reshape(-1, 16)
        assert torch.equal(got, want)
        got_b = local_slice(b, specs["layers.0.attn.qkv.bias"], 2, r)
        assert torch.equal(got_b, b.view(3, 4, 4)[:, 2 * r:2 * r + 2].reshape(-1))
        assert torch.equal(local_slice(o, specs["layers.0.attn.o.weight"], 2, r),
                           o[:, 8 * r:8 * r + 8])
    assert specs["layers.0.attn.layer_norm.weight"] is None
    assert tp_param_specs(stack, model_axis_size=8)["layers.0.attn.qkv.weight"] is None


def _jax_fastpitch():
    """JAX's FastPitch (dropout off) initialised on the ``fastpitch`` case's
    global batch, and its one-device loss and gradients there."""
    _, _, b = fastpitch_case(np.random.default_rng(DP_CASES.index("fastpitch")))
    cfg = FastPitchConfig(**FP_CFG)
    cfg = dataclasses.replace(cfg, **{f.name: 0.0 for f in dataclasses.fields(cfg)
                                      if f.name.startswith("p_")})
    model = FastPitch(cfg)
    text, lens = jnp.asarray(b["text"], jnp.int32), jnp.asarray(b["input_lens"])
    mel, mel_lens = jnp.asarray(b["mel"]), jnp.asarray(b["mel_lens"])
    prior = beta_binomial_prior(mel_lens, lens, mel.shape[1], text.shape[1])
    args = (text, lens, mel, mel_lens, jnp.asarray(b["pitch"]), jnp.asarray(b["energy"]), None,
            prior)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), *args)

    def loss_fn(p):
        out = model.apply(p, *args, deterministic=True)
        return jax_fp_loss.fastpitch_loss(out, mel, lens, mel_lens)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return fastpitch_train_from_flax(np_tree(params)), {
        "metrics": {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}},
        "grads": fastpitch_train_from_flax(np_tree(grads)), "buffers": {}}


def _jax_talknet():
    """JAX's TalkNet 2 spectrogram head (dropout off) from random variables,
    and its one-device loss (``talknet/train.py``'s), gradients and new
    BatchNorm statistics on the ``talknet`` case's global batch."""
    _, _, b = talknet_case(np.random.default_rng(DP_CASES.index("talknet")))
    model = jax_tn.SpectrogramModel(jax_tn.TalkNet2Config(
        **TN_HEAD, backbone=jax_tn.QuartzNetConfig(**TN_BACKBONE)))
    text, dur = jnp.asarray(b["text"], jnp.int32), jnp.asarray(b["dur"], jnp.float32)
    mel, t_mel = jnp.asarray(b["mel"]), b["mel"].shape[1]
    f0 = jnp.einsum("bxt,bx->bt", jax_generate_path(dur, jnp.ones(dur.shape + (t_mel,))),
                    jnp.asarray(b["pitch"]))
    m = jax_mask(jnp.asarray(b["mel_lens"]), t_mel)[..., None].astype(jnp.float32)
    variables = random_variables(model, 11, text, dur, f0, t_mel)

    def loss_fn(params):
        out, mut = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               text, dur, f0, t_mel, train=True, mutable=["batch_stats"])
        loss = jnp.sum(jnp.abs(out - mel) * m) / jnp.maximum(jnp.sum(m), 1.0)
        return loss, mut["batch_stats"]

    with jax_dropout_off():
        (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
    after = talknet_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": grads, "batch_stats": stats}))
    return talknet_from_flax(variables), {
        "metrics": {"loss": float(loss), "mel_l1": float(loss)}, "grads": after,
        "buffers": {k: v for k, v in after.items() if k.endswith(("running_mean", "running_var"))}}


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    """One 2-process gloo run of the tool: the port-vs-port checks, and each
    rank's sharded step from JAX's weights (``--start``) beside JAX's
    one-device step on the global batch."""
    start = tmp_path_factory.mktemp("start")
    jax_steps = {}
    for case, fn in (("fastpitch", _jax_fastpitch), ("talknet", _jax_talknet)):
        weights, jax_steps[case] = fn()
        torch.save(weights, start / f"{case}.start.pt")
    results, _ = run(2, ["fastpitch", "talknet", "tp"], device="cpu", timeout=240, start=start)
    return results, jax_steps, start


def test_two_process_steps_equal_the_one_process_step(two_process):
    """FastPitch and TalkNet 2 data parallel over 2 gloo processes, and a
    2-head FastPitch tensor parallel over them, against the one-process
    step (each process holds both and reports the errors as ratios to the
    tolerances)."""
    results = two_process[0]
    by = {(r["case"], r["rank"]): r for r in results}
    assert set(by) == {(c, k) for c in ("fastpitch", "talknet", "tp2h", "tp1h")
                       for k in (0, 1)}
    for key, r in by.items():
        assert passed(r), (key, r)
    assert by[("talknet", 0)]["n_buffers"] > 0
    assert by[("tp2h", 0)]["n_sharded"] == 12 and by[("tp1h", 0)]["n_sharded"] == 8


@pytest.mark.parametrize("case", ["fastpitch", "talknet"])
def test_two_process_steps_match_jax(two_process, case):
    """Each rank's reduced loss and gradients (the global normalisers, the
    gradient sum) and its BatchNorm buffers (global statistics) against JAX's
    one-device step on the same global ragged batch and weights."""
    _, jax_steps, start = two_process
    want = jax_steps[case]
    for rank in (0, 1):
        got = torch.load(start / f"{case}.rank{rank}.pt")
        for k in sorted(set(got["metrics"]) & set(want["metrics"])):
            print(f"{case} rank {rank} {k}: port {got['metrics'][k]:.7e} "
                  f"JAX {want['metrics'][k]:.7e}")
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=2e-5,
                                       atol=2e-5, err_msg=f"{case} rank {rank} {k}")
        assert "loss" in got["metrics"] and set(got["grads"]) <= set(want["grads"])
        worst = max((got["grads"][n] - want["grads"][n]).abs().max().item()
                    for n in got["grads"])
        print(f"{case} rank {rank}: {len(got['grads'])} gradients, max |port - JAX| {worst:.3e}")
        for n, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["grads"][n].numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=f"{case} rank {rank} {n}")
        assert sorted(got["buffers"]) == sorted(want["buffers"])
        assert (len(got["buffers"]) > 0) == (case == "talknet")
        for k, v in got["buffers"].items():
            np.testing.assert_allclose(v.numpy(), want["buffers"][k].numpy(), rtol=2e-5,
                                       atol=2e-5, err_msg=f"{case} rank {rank} {k}")


# ------------------------------------------------------------------ slow

DP4_CASES = ("fastpitch", "fastspeech2", "tacotron2", "gradtts", "flowtron", "talknet",
             "diffwave", "asr", "gan")


@pytest.fixture(scope="module")
def dp4_results():
    results, _ = run(4, list(DP4_CASES), device="cpu", timeout=900)
    return results


@pytest.mark.slow
@pytest.mark.parametrize("case", DP4_CASES)
def test_dp4_step_matches_one_process(dp4_results, case):
    """``tests/test_multichip.py:324,351``: each family's step on 4 data
    shards, with ragged lengths where it has lengths; the ASR's with the
    CLI's WER over the ranks' transcripts."""
    mine = [r for r in dp4_results if r["case"] == case]
    assert len(mine) == 4
    for r in mine:
        assert passed(r), r


@pytest.mark.slow
def test_dp_tp_2x2_matches_replicated():
    """``tests/test_tp.py:73,108``: FastPitch on a 2 × 2 (data × model) mesh,
    2 heads and 1 head."""
    results, _ = run(4, ["tp"], device="cpu", tp=2, timeout=300)
    assert len(results) == 8
    for r in results:
        assert r["mesh"] == [2, 2] and passed(r), r


_WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, sys.argv[1])
    from neuraltexttospeech_torch.parallel import initialize_distributed
    assert initialize_distributed(device="cpu") is True
    x = torch.full((1,), float(dist.get_rank() + 1))
    dist.all_reduce(x)
    print(f"rank {dist.get_rank()} of {dist.get_world_size()}: sum {float(x[0])}", flush=True)
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
@pytest.mark.parametrize("style", ["coordinator", "torchrun"])
def test_two_process_initialize_distributed_from_env(tmp_path, style):
    """``tests/test_distributed.py:61``: two processes join one run from the
    environment alone (JAX's variables, or ``torchrun``'s) and reduce across
    it."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k not in RUN_VARS}
    procs = []
    for rank in range(2):
        run_vars = ({"COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NUM_PROCESSES": "2",
                     "PROCESS_ID": str(rank)} if style == "coordinator" else
                    {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2",
                     "RANK": str(rank), "LOCAL_RANK": str(rank)})
        procs.append(subprocess.Popen([sys.executable, str(worker), ROOT],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, env={**base, **run_vars}))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"rank {rank} of 2: sum 3.0" in out, out
