"""The port's spans and counters (``utils/profiling.py``) on the CPU.

- Off (no ``torch.profiler`` recording) a span is the shared no-op and
  nothing is kept; the switch is the flag ``torch.profiler.profile`` sets.
- On, spans nest (parents, self times), counts land on the innermost span,
  and the host stamps lie on the clock of the profiler's own records.
- A trace's idle gap is named by the program span over it.
- The sites: every family's traced ``synthesize`` (``utils/serving.py::serve``)
  gives one ``serve.batch`` a batch with its stages and counts
  ``precision.casts`` as the layers' calls give them;
  a traced GAN step gives its five phases under ``gan.step`` and counts
  ``norms.weight_norm`` as the nets' normalised weights and passes give it.

No JAX here, so the file also runs on the card (``--noconftest``).
"""

import pathlib
import re
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig  # noqa: E402
from neuraltexttospeech_torch.nn import layers, precision  # noqa: E402
from neuraltexttospeech_torch.nn.norms import SpectralNorm, WeightNorm  # noqa: E402
from neuraltexttospeech_torch.utils import profiling  # noqa: E402
from test_torch_serving import _synthesize, models  # noqa: E402,F401  (a fixture)

CPU = torch.device("cpu")
TINY_HG = dict(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
               upsample_initial_channel=32, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16, win_size=64,
               num_mels=80)
TINY_GAN = dict(TINY_HG, num_mels=8, segment_size=256, fast_grouped_convs="gdot_pallas")
LENGTHS = (5, 9, 12, 3, 17, 7)  # 6 utterances at batch 4: two batches
SERVE_STAGES = ["serve.acoustic", "serve.wait", "serve.vocoder", "serve.to_host"]
GAN_PHASES = ["gan.mel", "gan.generator", "gan.disc", "gan.backward", "gan.optim"]
# the layers that cast through ``precision.promote``, and whether their input is cast too
PROMOTING = ((layers.Embedding, False), (layers.Linear, True), (layers.Conv1d, True),
             (layers.ConvTranspose1d, True), (layers.Conv2d, True),
             (layers.ConvTranspose2d, True))


@pytest.fixture(autouse=True)
def _fresh():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(prev)


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def casts_by_hand(modules, run):
    """The casts to the compute dtype that ``run()`` asks of the promoting
    layers of ``modules``, counted from their calls: at each call, each of
    its weight, bias and (but for an embedding's ids) input that is not
    already in the compute dtype."""
    total, hooks = [0], []

    def pre_hook(cast_input):
        def hook(module, args):
            dtype = precision.current()
            if dtype is None:
                return
            ts = ([args[0]] if cast_input else []) + [module.weight,
                                                       getattr(module, "bias", None)]
            total[0] += sum(t is not None and t.dtype != dtype for t in ts)
        return hook

    for root in modules:
        for m in root.modules():
            for cls, cast_input in PROMOTING:
                if isinstance(m, cls):  # subclasses too (``ConvNorm``)
                    hooks.append(m.register_forward_pre_hook(pre_hook(cast_input)))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def norms_in(net):
    """The weights ``net`` normalises (weight norm or spectral norm), each
    computed once a forward pass."""
    return sum(isinstance(m, (WeightNorm, SpectralNorm)) for m in net.modules())


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not profiling.tracing()
    a, b = profiling.span("x.a"), profiling.span("x.b", CPU)
    assert a is b  # one shared no-op, no allocation a call
    with a:
        profiling.count("x.n", 3)
        with precision.compute_dtype(torch.bfloat16):
            layers.Linear(4, 4)(torch.ones(2, 4))
    assert profiling.spans() == []


def test_the_switch_is_the_flag_the_profiler_sets():
    from torch.autograd import profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    with _profile():
        assert autograd_profiler._is_profiler_enabled is True and profiling.tracing()
        with profiling.span("x.on"):
            pass
    assert autograd_profiler._is_profiler_enabled is False and not profiling.tracing()
    assert [r.name for r in profiling.spans()] == ["x.on"]


def test_nesting_gives_parents_and_self_times():
    with _profile():
        with profiling.span("x.outer") as outer:
            time.sleep(0.002)
            with profiling.span("x.first"):
                time.sleep(0.004)
            with profiling.span("x.second") as second:
                with profiling.span("x.inner"):
                    time.sleep(0.003)
    recs = {r.name: r for r in profiling.spans()}
    assert [r.name for r in profiling.spans()] == ["x.first", "x.inner", "x.second", "x.outer"]
    assert recs["x.outer"].parent is None
    assert recs["x.first"].parent == recs["x.second"].parent == outer.id
    assert recs["x.inner"].parent == second.id
    assert len({r.id for r in recs.values()}) == 4 and len({r.thread for r in recs.values()}) == 1
    assert all(r.replica is None and r.device_ms is None for r in recs.values())
    kids = recs["x.first"].host_ms + recs["x.second"].host_ms
    assert recs["x.outer"].self_ms == pytest.approx(recs["x.outer"].host_ms - kids)
    assert recs["x.second"].self_ms == pytest.approx(
        recs["x.second"].host_ms - recs["x.inner"].host_ms)
    assert 2.0 <= recs["x.outer"].self_ms < recs["x.outer"].host_ms
    assert recs["x.inner"].self_ms == recs["x.inner"].host_ms >= 3.0


def test_counts_land_on_the_innermost_span():
    profiling.count("x.n")  # off: not kept
    with _profile():
        profiling.count("x.n", 5)  # outside every span: not kept
        with profiling.span("x.outer"):
            profiling.count("x.n")
            with profiling.span("x.inner"):
                profiling.count("x.n", 2)
                profiling.count("x.m")
            profiling.count("x.n")
    recs = {r.name: r for r in profiling.spans()}
    assert recs["x.outer"].counts == {"x.n": 2}
    assert recs["x.inner"].counts == {"x.n": 2, "x.m": 1}


def test_stamps_lie_on_the_clock_of_the_profilers_records():
    """A span stamps its start just after its ``record_function`` range
    opens and its end just before the range closes, so on one clock each
    span lies inside its range, by the few µs the range's own calls take
    (a loaded host stretches a few of them, never the median)."""
    with _profile() as prof:
        for _ in range(3):  # the first ranges of a profile set up its recorder
            with profiling.span("x.warm"):
                (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        for i in range(20):
            with profiling.span(f"x.s{i}"):
                (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    ours = {r.name: r for r in profiling.spans() if r.name != "x.warm"}
    theirs = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ours and e.is_user_annotation()}
    assert set(theirs) == set(ours) and len(ours) == 20
    slack = []
    for name, r in ours.items():
        e = theirs[name]
        assert e.start_ns() - 10_000 <= r.start_ns < r.end_ns <= e.end_ns() + 10_000, name
        slack += [r.start_ns - e.start_ns(), e.end_ns() - r.end_ns]
    assert np.median(slack) < 50_000


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


def test_an_idle_gap_is_named_by_the_span_over_it():
    """Kernels at 0-10, 50-60, 63-70, 140-150 and 260-265 µs. The 40 µs gap
    lies in ``gan.optim`` (inside ``gan.step``; PyTorch's own
    ``Optimizer.step#Adam.step`` range is no program span) over a long
    ``aten::_foreach_add_``; the 70 µs one is named by the span of the op
    that fills its first part, though its middle lies past ``gan.optim``;
    the 3 µs one has no host op under it; the 110 µs one lies past every
    span."""
    trace = {"traceEvents": [
        _x("gan.step", "user_annotation", 0, 200),
        _x("gan.optim", "user_annotation", 8, 84),
        _x("Optimizer.step#Adam.step", "user_annotation", 9, 82),
        _x("aten::_foreach_add_", "cpu_op", 12, 36),
        _x("cudaLaunchKernel", "cuda_runtime", 49, 1),
        _x("aten::_foreach_sqrt", "cpu_op", 66, 22),
        _x("void at::native::elementwise_kernel<128, 4>", "kernel", 0, 10),
        _x("void at::native::elementwise_kernel<128, 4>", "kernel", 50, 10),
        _x("void at::native::reduce_kernel<512, 1>", "kernel", 63, 7),
        _x("void at::native::reduce_kernel<512, 1>", "kernel", 140, 10),
        _x("void at::native::reduce_kernel<512, 1>", "kernel", 260, 5),
        _x("gan.optim", "gpu_user_annotation", 8, 84),
    ]}
    b = profiling.chrome_breakdown(trace)
    assert b.gaps == [(pytest.approx(0.110), "", "host"),
                      (pytest.approx(0.070), "gan.optim", "aten::_foreach_sqrt"),
                      (pytest.approx(0.040), "gan.optim", "aten::_foreach_add_"),
                      (pytest.approx(0.003), "gan.optim", "host")]
    assert b.busy_ms == pytest.approx(0.042) and b.launches == 5
    table = b.table()
    assert "gan.optim / aten::_foreach_sqrt" in table and "(no span) / host" in table


FAMILIES = ["fastpitch", "fastspeech2", "talknet", "gradtts", "flowtron", "tacotron2"]


@pytest.mark.parametrize("n_replicas", [1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_traced_synthesize_gives_one_batch_span_a_batch(family, n_replicas, models):
    """Every family's ``synthesize`` (``utils/serving.py::serve``), bf16 at
    the tiny sizes of ``tests/test_torch_serving.py``."""
    def serve():
        for _ in _synthesize(family, models, [CPU] * n_replicas, 4, amp=True):
            assert not profiling._stack()  # every span of the batch closed before its yields

    with _profile():
        serve()
    recs = profiling.spans()
    by = _by_name(recs)
    batches = by["serve.batch"]
    assert len(batches) == 2
    assert all(r.replica is None for r in batches)
    for name in SERVE_STAGES:
        assert len(by[name]) == 2 * n_replicas, name
        assert sorted(r.replica for r in by[name]) == sorted(list(range(n_replicas)) * 2)
        assert all(r.device_ms is None for r in by[name])  # no card: no device time
    if n_replicas == 1:  # the replica runs on the caller's thread, inside its batch
        for b in batches:
            assert [r.name for r in recs if r.parent == b.id] == SERVE_STAGES
    casts = sum(r.counts.get("precision.casts", 0) for r in recs)
    assert casts > 0
    assert set(r.name for r in recs if r.counts) <= {"serve.acoustic", "serve.vocoder"}
    model = models[family]
    assert casts == casts_by_hand([*(model if family == "talknet" else [model]),
                                   models["vocoder"]], serve)


def test_traced_gan_step_gives_its_five_phases():
    from neuraltexttospeech_torch.models.hifigan_gan import HiFiGANTrainer

    torch.manual_seed(0)
    trainer = HiFiGANTrainer(HiFiGANConfig(**TINY_GAN), CPU, steps_per_epoch=10)
    audio = torch.randn(1, 256, 1) * 0.1
    trainer.train_step({"audio": audio})  # untraced: records nothing
    assert profiling.spans() == []
    with _profile():
        trainer.train_step({"audio": audio})
    recs = profiling.spans()
    (step,) = _by_name(recs)["gan.step"]
    assert step.parent is None
    phases = [r for r in recs if r.parent == step.id]
    assert [r.name for r in phases] == GAN_PHASES
    assert sum(r.host_ms for r in phases) <= step.host_ms
    # one generator pass; the MPD and MSD each run three passes a step
    gen, disc = norms_in(trainer.gen), 3 * (norms_in(trainer.mpd) + norms_in(trainer.msd))
    counts = {r.name: r.counts.get("norms.weight_norm", 0) for r in recs}
    assert (counts["gan.generator"], counts["gan.disc"]) == (gen, disc)
    assert sum(counts.values()) == gen + disc
    assert (gen, norms_in(trainer.mpd), norms_in(trainer.msd)) == (8, 30, 24)


def test_span_names_leave_host_op_prefixes_to_host_ops():
    """Trace readers take records named ``aten::…`` and ``cu…`` for host ops
    and ranges holding ``#`` for PyTorch's own."""
    names = set()
    for path in (ROOT / "neuraltexttospeech_torch").rglob("*.py"):
        names |= set(re.findall(r"\bspan\(\"([^\"]+)\"", path.read_text(encoding="utf-8")))
    assert {"text.encode", "serve.batch", "gan.step", *SERVE_STAGES, *GAN_PHASES} <= names
    for name in names:
        assert not name.startswith(("aten::", "cu")) and "#" not in name, name

