"""The CUDA-graph cache of the serving forwards (``utils/graphs.py``).

- On the CPU, with the capture stubbed (a "graph" that runs the body again
  on the call's tensors), the dispatch rules: no graph on the CPU, under
  autograd, in train mode or during a capture; the key separates compute
  dtypes, shapes and scalar arguments, and integer ids of either width
  share a graph; the cap sends calls past it to the eager path; a replaced
  parameter or moved storage drops the graphs and a load in place keeps
  them; ``copy.deepcopy`` and pickling leave the copy's cache empty; the
  state dict is unchanged; the counters count, and a replay adds the counts
  its body made at capture.
- On the card (``-m gpu``): a replay of ``FastPitch.infer`` and of the v1
  generator is bit-equal to the eager call at three shapes each, in bf16
  and f32; two replays hand out tensors that do not alias; a replaced
  parameter never replays stale; a cached constant the graph reads outlives
  its cache; ``synthesize`` at batch 1 and 8 gives the same mels and audio
  as with the cache bypassed.

No JAX here, so the file also runs on the card (``--noconftest``).
"""

import copy
import pathlib
import pickle
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from neuraltexttospeech_torch.cli import fastpitch_infer  # noqa: E402
from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig  # noqa: E402
from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig  # noqa: E402
from neuraltexttospeech_torch.nn import transformer  # noqa: E402
from neuraltexttospeech_torch.nn.precision import compute_dtype  # noqa: E402
from neuraltexttospeech_torch.utils import graphs, profiling  # noqa: E402
from torch.utils import _pytree  # noqa: E402

CPU = torch.device("cpu")
TINY_HG = dict(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
               upsample_initial_channel=32, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16, win_size=64,
               num_mels=80)
TINY_FP = dict(n_symbols=40, symbols_embedding_dim=32, in_fft_n_layers=1, in_fft_d_head=16,
               in_fft_n_heads=2, in_fft_conv1d_filter_size=64, out_fft_n_layers=1,
               out_fft_d_head=16, out_fft_n_heads=2, out_fft_conv1d_filter_size=64,
               dur_predictor_filter_size=32, pitch_predictor_filter_size=32,
               energy_predictor_filter_size=32)
COUNTERS = ("graph.capture", "graph.replay", "graph.eager")


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


def _fastpitch(**kw):
    torch.manual_seed(0)
    fp = FastPitch(FastPitchConfig(**kw)).eval()
    with torch.no_grad():
        fp.duration_predictor.fc.bias.fill_(float(np.log(4.0)))
    return fp


def _generator(config):
    torch.manual_seed(1)
    return Generator(config).eval()


def _cards(module):
    cache = module.__dict__.get(graphs._ATTR)
    return {} if cache is None else cache.cards


def _n_graphs(module):
    return sum(len(c.graphs) for c in _cards(module).values())


def _counted(run):
    """``run()`` inside a span under the profiler: (its result, the span's
    counts)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("t"):
            out = run()
    (rec,) = profiling.spans()
    profiling.reset()
    return out, rec.counts


def _same(a, b):
    for x, y in zip(_pytree.tree_leaves(a), _pytree.tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ------------------------------------------------------------ CPU, capture stubbed

class _StubGraph:
    """Stands in for a captured graph: replays by running the body again on
    the call's tensors, its counts kept from every span."""

    def __init__(self, body, args, kwargs, tally):
        self.body, self.args, self.kwargs, self.tally = body, args, kwargs, tally

    def replay(self, tensors):
        it = iter(tensors)
        args, kwargs = _pytree.tree_map_only(torch.Tensor, lambda _: next(it),
                                             (self.args, self.kwargs))
        with profiling.tally():
            out = self.body(*args, **kwargs)
        return _pytree.tree_map_only(torch.Tensor, torch.clone, out)


class _StubCard:
    def __init__(self, device):
        self.graphs = {}

    def first_call(self, key, body, args, kwargs, tensors):
        out = body(*args, **kwargs)
        with profiling.tally() as tally:  # the capture's run, as the card's
            body(*args, **kwargs)
        self.graphs[key] = _StubGraph(body, args, kwargs, tally)
        return out


@pytest.fixture
def stub(monkeypatch):
    """The cache engaged on the CPU, capture stubbed."""
    monkeypatch.setattr(graphs, "_on_card", lambda t: True)
    monkeypatch.setattr(graphs, "_capturing", lambda: False)
    monkeypatch.setattr(graphs, "_Card", _StubCard)


def test_no_graph_on_the_cpu():
    gen, fp = _generator(HiFiGANConfig(**TINY_HG)), _fastpitch(**TINY_FP)
    mel = torch.randn(2, 12, 80)
    text = torch.randint(1, 40, (2, 8))
    with torch.inference_mode():
        (audio, out), counts = _counted(lambda: (gen(mel), fp.infer(text, max_mel_len=64)))
        _same(audio, gen._forward(mel))
        _same(out, fp._infer(text, pace=1.0, max_mel_len=64, speaker=None, dur_tgt=None,
                             pitch_tgt=None, energy_tgt=None, max_duration=75.0,
                             pitch_transform=None))
    assert graphs._ATTR not in gen.__dict__ and graphs._ATTR not in fp.__dict__
    assert not any(name in counts for name in COUNTERS)


@pytest.mark.parametrize("case", ["autograd", "no_grad", "train", "capturing", "callable"])
def test_no_graph_where_it_cannot_stand_in(stub, monkeypatch, case):
    gen, fp = _generator(HiFiGANConfig(**TINY_HG)), _fastpitch(**TINY_FP)
    mel, text = torch.randn(1, 8, 80), torch.randint(1, 40, (1, 8))
    if case == "train":
        gen.train(), fp.train()
    if case == "capturing":
        monkeypatch.setattr(graphs, "_capturing", lambda: True)

    def call():
        kw = {"pitch_transform": lambda p: p + 1.0} if case == "callable" else {}
        return gen(mel), fp.infer(text, max_mel_len=32, **kw)

    for _ in range(2):
        if case == "autograd":
            call()
        elif case == "no_grad":
            with torch.no_grad():
                call()
        else:
            with torch.inference_mode():
                call()
    assert _n_graphs(fp) == 0
    assert _n_graphs(gen) == (0 if case != "callable" else 1)


def test_key_separates_compute_dtypes_shapes_and_scalars(stub):
    gen = _generator(HiFiGANConfig(**TINY_HG))
    fp = _fastpitch(**TINY_FP)
    a, b = torch.randn(1, 8, 80), torch.randn(1, 16, 80)
    text = torch.randint(1, 40, (1, 8))
    with torch.inference_mode():
        gen(a)
        with compute_dtype(torch.bfloat16):
            gen(a)
        gen(b)
        assert _n_graphs(gen) == 3
        (_, counts) = _counted(lambda: (gen(a), gen(b)))
        with compute_dtype(torch.bfloat16):
            (bf, counts_bf) = _counted(lambda: gen(a))
            _same(bf, gen._forward(a))
        assert counts == {"graph.replay": 2} and counts_bf["graph.replay"] == 1
        assert _n_graphs(gen) == 3

        fp.infer(text.long(), max_mel_len=32)
        out, counts = _counted(lambda: fp.infer(text.int(), max_mel_len=32))
        assert counts == {"graph.replay": 1}  # int32 ids replay the int64 capture
        _same(out, fp.infer(text.long(), max_mel_len=32))
        fp.infer(text, max_mel_len=48)
        fp.infer(text, max_mel_len=32, pace=1.5)
        assert _n_graphs(fp) == 3


def test_the_cap_sends_new_shapes_to_the_eager_path(stub, monkeypatch):
    monkeypatch.setattr(graphs, "CAP", 3)
    gen = _generator(HiFiGANConfig(**TINY_HG))
    mels = [torch.randn(1, t, 80) for t in (4, 5, 6, 7, 8)]
    with torch.inference_mode():
        outs, counts = _counted(lambda: [gen(m) for m in mels])
        assert counts == {"graph.capture": 3, "graph.eager": 2}
        again, counts = _counted(lambda: [gen(m) for m in mels])
        assert counts == {"graph.replay": 3, "graph.eager": 2}
        for x, y, m in zip(outs, again, mels):
            _same(x, y)
            _same(x, gen._forward(m))
    assert _n_graphs(gen) == 3


@pytest.mark.parametrize("change", ["replace", "data", "cast", "submodule",
                                    "data_and_register"])
def test_replaced_storage_drops_the_graphs(stub, change):
    gen = _generator(HiFiGANConfig(**TINY_HG))
    spare = copy.deepcopy(gen.conv_post)  # built before the capture
    mel = torch.randn(1, 8, 80)
    with torch.inference_mode():
        gen(mel)
    with torch.no_grad():
        w = gen.conv_post.weight
        if change == "replace":
            gen.conv_post.weight = torch.nn.Parameter(w * 2.0)
        elif change == "data":
            w.data = w.data * 2.0
        elif change == "cast":
            gen.double().float()
        elif change == "data_and_register":  # storage moved, and a registration in the tree
            w.data = w.data * 2.0
            gen.conv_pre.weight = gen.conv_pre.weight
        else:
            spare.weight.mul_(2.0)
            gen.conv_post = spare
    with torch.inference_mode():
        (out, counts) = _counted(lambda: gen(mel))
        assert counts == {"graph.eager": 1} and _n_graphs(gen) == 0
        _same(out, gen._forward(mel))
        (_, counts) = _counted(lambda: (gen(mel), gen(mel)))
        assert counts == {"graph.capture": 1, "graph.replay": 1}


def test_a_load_in_place_keeps_the_graphs(stub):
    gen = _generator(HiFiGANConfig(**TINY_HG))
    other = _generator(HiFiGANConfig(**TINY_HG))
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(0.5)
    mel = torch.randn(1, 8, 80)
    with torch.inference_mode():
        gen(mel)
    gen.load_state_dict(other.state_dict())
    with torch.inference_mode():
        (out, counts) = _counted(lambda: gen(mel))
        assert counts == {"graph.replay": 1}
        _same(out, other._forward(mel))


def test_copies_and_pickles_leave_the_cache_behind(stub):
    gen = _generator(HiFiGANConfig(**TINY_HG))
    with torch.inference_mode():
        gen(torch.randn(1, 8, 80))
    assert _n_graphs(gen) == 1
    for twin in (copy.deepcopy(gen), pickle.loads(pickle.dumps(gen))):
        assert _n_graphs(twin) == 0
    assert _n_graphs(gen) == 1
    twin = copy.deepcopy(gen)
    with torch.inference_mode():
        twin(torch.randn(1, 8, 80))
    assert _n_graphs(twin) == 1 and _cards(twin) is not _cards(gen)


def test_the_state_dict_is_unchanged(stub):
    fp = _fastpitch(**TINY_FP)
    before = {k: v.clone() for k, v in fp.state_dict().items()}
    with torch.inference_mode():
        fp.infer(torch.randint(1, 40, (1, 8)), max_mel_len=32)
    after = fp.state_dict()
    assert _n_graphs(fp) == 1
    assert list(after) == list(before)
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_the_counters_count_and_a_replay_adds_the_casts_of_its_capture(stub):
    gen = _generator(HiFiGANConfig(**TINY_HG))
    mel = torch.randn(1, 8, 80)
    with torch.inference_mode(), compute_dtype(torch.bfloat16):
        eager = _counted(lambda: gen._forward(mel))[1]["precision.casts"]
        assert eager > 0
        _, first = _counted(lambda: gen(mel))
        _, later = _counted(lambda: (gen(mel), gen(mel)))
    assert first == {"graph.capture": 1, "precision.casts": eager}
    assert later == {"graph.replay": 2, "precision.casts": 2 * eager}
    # the forward's own ModuleList slices register nothing the cache watches
    assert gen.__dict__[graphs._ATTR].generation == graphs._generation
    # tracing off: a replay counts nothing, and leaves no tally open
    with torch.inference_mode(), compute_dtype(torch.bfloat16):
        gen(mel)
    assert profiling._tallies == 0 and not profiling.counting()


def test_a_tally_keeps_its_counts_from_the_spans():
    with profiling.tally() as outer:
        profiling.count("a")
        with profiling.tally() as inner:
            profiling.count("a", 2)
        profiling.count("b")
    assert outer == {"a": 1, "b": 1} and inner == {"a": 2}
    _, counts = _counted(lambda: profiling.count("c"))
    assert counts == {"c": 1}


def test_synthesize_on_the_cpu_meets_no_graph():
    fp, gen = _fastpitch(**TINY_FP), _generator(HiFiGANConfig(**TINY_HG))
    rng = np.random.default_rng(0)
    encoded = [rng.integers(1, 40, n).astype(np.int32) for n in (5, 9, 12)]
    out = list(fastpitch_infer.synthesize(fp, gen, encoded, device=CPU, batch_size=2,
                                          max_mel_len=64, text_bucket=8, frame_bucket=4,
                                          dtype=torch.bfloat16))
    assert len(out) == 3 and _n_graphs(fp) == 0 and _n_graphs(gen) == 0


# ------------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bypassed(monkeypatch, run):
    """``run()`` with the cache bypassed, as on the CPU."""
    with monkeypatch.context() as m:
        m.setattr(graphs, "_on_card", lambda t: False)
        return run()


DTYPES = [pytest.param(None, id="f32"), pytest.param(torch.bfloat16, id="bf16")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_fastpitch_replay_is_bit_equal_to_eager(card, monkeypatch, dtype):
    fp = _fastpitch().to(card)
    for width in (16, 64, 192):
        text = torch.randint(1, 148, (2, width), device=card)
        with torch.inference_mode(), compute_dtype(dtype):
            want = _bypassed(monkeypatch, lambda: fp.infer(text, max_mel_len=2048))
            first, counts = _counted(lambda: fp.infer(text, max_mel_len=2048))
            assert counts["graph.capture"] == 1
            replay, counts = _counted(lambda: fp.infer(text.int(), max_mel_len=2048))
            assert counts["graph.replay"] == 1
        _same(first, want)
        _same(replay, want)
        assert int(want[1].max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_generator_replay_is_bit_equal_to_eager(card, monkeypatch, dtype):
    gen = _generator(HiFiGANConfig.v1()).to(card)
    for frames in (128, 384, 1024):
        full = torch.randn(1, 2048, 80, device=card)
        mel = full[:, :frames]  # a strided slice, as the serving loop passes
        with torch.inference_mode(), compute_dtype(dtype):
            want = _bypassed(monkeypatch, lambda: gen(mel))
            first, counts = _counted(lambda: gen(mel))
            assert counts["graph.capture"] == 1
            replay, counts = _counted(lambda: gen(mel))
            assert counts["graph.replay"] == 1
        _same(first, want)
        _same(replay, want)


@pytest.mark.gpu
def test_cuda_two_replays_do_not_alias(card, monkeypatch):
    gen = _generator(HiFiGANConfig.v1()).to(card)
    x, y = torch.randn(2, 1, 128, 80, device=card)
    with torch.inference_mode(), compute_dtype(torch.bfloat16):
        gen(x)
        a, b = gen(x), gen(y)
        want_a, want_b = _bypassed(monkeypatch, lambda: (gen(x), gen(y)))
    assert a.data_ptr() != b.data_ptr()
    _same(a, want_a)
    _same(b, want_b)


@pytest.mark.gpu
@pytest.mark.parametrize("change", ["replace", "move"])
def test_cuda_a_replaced_parameter_never_replays_stale(card, monkeypatch, change):
    gen = _generator(HiFiGANConfig.v1()).to(card)
    mel = torch.randn(1, 128, 80, device=card)
    with torch.inference_mode():
        gen(mel), gen(mel)
    with torch.no_grad():
        if change == "replace":
            gen.conv_post.weight = torch.nn.Parameter(gen.conv_post.weight * 2.0)
        else:
            gen.cpu().to(card)
    with torch.inference_mode():
        want = _bypassed(monkeypatch, lambda: gen(mel))
        for _ in range(3):  # eager, capture, replay
            _same(gen(mel), want)
        with torch.no_grad():
            gen.conv_post.weight.mul_(0.5)  # in place: the graph reads it
        want = _bypassed(monkeypatch, lambda: gen(mel))
        out, counts = _counted(lambda: gen(mel))
    assert counts == {"graph.replay": 1}
    _same(out, want)


@pytest.mark.gpu
def test_cuda_a_cached_constant_outlives_its_cache(card, monkeypatch):
    fp = _fastpitch(**TINY_FP).to(card)
    text = torch.randint(1, 40, (1, 16), device=card)
    with torch.inference_mode():
        fp.infer(text, max_mel_len=256)
        want = _bypassed(monkeypatch, lambda: fp.infer(text, max_mel_len=256))
        transformer.positional_embedding.cache_clear()
        # blocks of the tables' sizes on both streams, so a freed table's block is taken
        junk = [torch.full((n, 32), float("nan"), device=card) for n in (16, 256) * 64]
        with torch.cuda.stream(_cards(fp)[card].stream):
            junk += [torch.full((n, 32), float("nan"), device=card) for n in (16, 256) * 64]
        out = fp.infer(text, max_mel_len=256)
    del junk
    _same(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("batch_size", [1, 8])
def test_cuda_synthesize_matches_the_bypassed_cache(card, monkeypatch, batch_size):
    fp, gen = _fastpitch().to(card), _generator(HiFiGANConfig.v1()).to(card)
    rng = np.random.default_rng(batch_size)
    encoded = [rng.integers(1, 148, n).astype(np.int32) for n in (12, 40, 70, 90, 33, 7, 120,
                                                                   60, 25)]

    def serve():
        return list(fastpitch_infer.synthesize(fp, gen, encoded, device=card,
                                               batch_size=batch_size,
                                               dtype=torch.bfloat16))

    want = _bypassed(monkeypatch, serve)
    first, again = serve(), serve()
    assert _n_graphs(fp) > 0 and _n_graphs(gen) > 0
    for got in (first, again):
        assert len(got) == len(want)
        for (j, mel, audio), (wj, wmel, waudio) in zip(got, want):
            assert j == wj
            np.testing.assert_array_equal(mel, wmel)
            np.testing.assert_array_equal(audio, waudio)
