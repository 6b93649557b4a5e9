"""Serving cells: raw text → the program's front end → ``synthesize``
(FastPitch → HiFi-GAN) → f32 audio on the host, one client in a closed
loop.

A request is a list of raw sentences (``yardstick/traffic.py``). It is
issued with the text in hand when the last one has completed, and completes
when its last utterance's audio is on the host as numpy. The program is the
port's serving loop (``cli/fastpitch_infer.py::synthesize``) on one card,
with the configuration's compute type and the traffic's buckets. What the
check needs of each batch is read from the program as it serves: the padded
text width and the durations that FastPitch's ``infer`` returns (``infer``
is wrapped), the frames the vocoder is given (a forward pre-hook), and
which batch and row each yielded utterance came from.
"""

from __future__ import annotations

import functools
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from ..yardstick import traffic, weights
from ..yardstick.judge import judge_serving

__all__ = ["Serve", "Driver", "control"]

DTYPES = {"bf16": torch.bfloat16, "f32": None}


def init_weights(cfg: dict, leaves, seed: int, device, ref, texts) -> Dict[str, torch.Tensor]:
    """The acoustic model's and the vocoder's seeded weights, names prefixed
    ``fastpitch.`` and ``vocoder.``, with the configuration's duration head:
    its output weights scaled and its bias set so that, over the tokens of
    ``texts`` (the traffic's fixed calibration sentences), the reference's
    log-durations have the mean ``init.duration_bias`` and the standard
    deviation ``init.duration_log_std`` (a traffic file's
    ``duration_log_std`` stands in its place). So every seed serves the same
    lengths on the whole, and only which token gets which is drawn."""
    out = weights.make(leaves, seed, device, cfg["init"]["rule"])
    mean, std = ref.log_duration_stats(cfg, out, device, texts)
    scale = cfg["init"]["duration_log_std"] / std
    out["fastpitch.duration_predictor.fc.weight"].mul_(scale)
    out["fastpitch.duration_predictor.fc.bias"].fill_(cfg["init"]["duration_bias"] - scale * mean)
    return out


def split(prefixed: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in prefixed.items() if k.startswith(prefix)}


class Reservoir:
    """A uniform sample, drawn from the seed, of ``size`` completed requests
    (algorithm R), and the request that holds the longest utterance."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, np.random.default_rng([int(seed), 0x5A3B])
        self.kept: List[dict] = []
        self.longest, self.seen = None, 0

    def offer(self, req: dict):
        if self.longest is None or req["max_frames"] > self.longest["max_frames"]:
            self.longest = req
        if self.seen < self.size:
            self.kept.append(req)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = req
        self.seen += 1

    def sample(self) -> List[dict]:
        out = list(self.kept)
        if self.longest is not None and all(r is not self.longest for r in out):
            out.append(self.longest)
        return out


class Serve:
    def __init__(self, cell: dict, config: dict, mix: dict, device: torch.device, seed: int,
                 root):
        if "duration_log_std" in mix:  # the traffic sets the spread of the served durations
            config = {**config, "init": {**config["init"],
                                         "duration_log_std": mix["duration_log_std"]}}
        self.cell, self.cfg, self.mix = cell, config, mix
        self.device, self.seed, self.root = device, int(seed), root
        self.dtype = DTYPES[config["precision"]]
        self.bs = int(mix["batch_size"])
        self.extras: dict = {}
        from ..reference import load_reference

        self.ref = load_reference(root, cell["config"])
        texts = traffic.Sentences(mix, 0, root).middles()
        self.init_weights = functools.partial(init_weights, ref=self.ref, texts=texts)

    # ------------------------------------------------------------- set-up
    def setup(self):
        from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig
        from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
        from neuraltexttospeech_torch.text.processing import TextProcessing

        fp_cfg, voc = self.cfg["fastpitch"], self.cfg["vocoder"]
        self.fp = FastPitch(FastPitchConfig(**fp_cfg)).to(self.device).eval()
        self.gen = Generator(HiFiGANConfig(**_tuples(voc))).to(self.device).eval()
        leaves = ([("fastpitch." + n, s) for n, s in weights.spec(self.fp)]
                  + [("vocoder." + n, s) for n, s in weights.spec(self.gen)])
        self.leaves = leaves
        self.stream = traffic.Sentences(self.mix, self.seed, self.root)
        w = self.init_weights(self.cfg, leaves, self.seed, self.device)
        weights.load(self.fp, split(w, "fastpitch."))
        weights.load(self.gen, split(w, "vocoder."))
        del w
        self.front = TextProcessing(self.cfg["symbol_set"], self.cfg["text_cleaners"],
                                    p_arpabet=0.0)
        # one entry a batch of the request being served: its text width,
        # durations and vocoder frames
        self.batches: List[dict] = []
        infer = self.fp.infer

        def kept_infer(text, *args, **kwargs):
            out = infer(text, *args, **kwargs)
            self.batches.append({"width": int(text.shape[1]), "durations": out[2], "frames": 0})
            return out

        def kept_frames(module, args):
            if self.batches:
                self.batches[-1]["frames"] = int(args[0].shape[1])

        self.fp.infer = kept_infer
        self.gen.register_forward_pre_hook(kept_frames)
        self._warm()

    def _warm(self):
        """Every shape this cell's traffic reaches: each text bucket of the
        corpus through ``infer`` and each vocoder bucket through the
        generator, at the cell's batch; then one request end to end."""
        from neuraltexttospeech_torch.nn.precision import compute_dtype

        longest = max(len(self.front.encode_text(l)) for l in self.stream.lines)
        max_mel = int(self.mix["max_mel_len"])
        bucket, frame_bucket = int(self.mix["text_bucket"]), int(self.mix["vocoder_bucket"])
        with torch.inference_mode(), compute_dtype(self.dtype):
            for width in range(bucket, traffic.round_up(longest, bucket) + 1, bucket):
                ids = torch.ones(self.bs, width, dtype=torch.long, device=self.device)
                self.fp.infer(ids, pace=1.0, max_mel_len=max_mel)
            for frames in range(frame_bucket, max_mel + 1, frame_bucket):
                mel = torch.zeros(self.bs, frames, self.cfg["vocoder"]["num_mels"],
                                  device=self.device)
                self.gen(mel)
        warm = traffic.Sentences(self.mix, self.seed ^ 0x77AA, self.root)
        self._serve(warm.request(0))
        _sync(self.device)

    def _serve(self, texts):
        """Serve one request; returns its ids, the yielded ``(index, mel,
        audio)``, each one's ``(batch, row)`` and the front end's seconds."""
        from neuraltexttospeech_torch.cli.fastpitch_infer import synthesize

        self.batches = []
        t0 = time.perf_counter()
        ids = [np.asarray(self.front.encode_text(t), np.int32) for t in texts]
        t1 = time.perf_counter()
        out, place, rows = [], [], {}
        # the loop is lazy: an utterance is yielded before the next batch is run
        for item in synthesize(self.fp, self.gen, ids, device=self.device, batch_size=self.bs,
                               max_mel_len=int(self.mix["max_mel_len"]),
                               text_bucket=int(self.mix["text_bucket"]),
                               frame_bucket=int(self.mix["vocoder_bucket"]), dtype=self.dtype):
            b = len(self.batches) - 1
            rows[b] = rows.get(b, -1) + 1
            out.append(item)
            place.append((b, rows[b]))
        return ids, out, place, t1 - t0

    # ------------------------------------------------------------- window
    def window(self, seconds: float, profile_units: int = 0):
        """Serve for ``seconds``, the next request issued when the last one
        completes; with ``profile_units`` the profiler records the first that
        many requests (and the generator's CUDA-event time a batch is taken).
        Returns the run's records."""
        hop = self.cfg["vocoder"]["hop_size"]
        sr = self.cfg["vocoder"]["sampling_rate"]
        keep = Reservoir(int(self.mix["check_requests"]), self.seed)
        records, failed = [], 0
        events: List[tuple] = []
        hooks = []
        if profile_units:
            hooks = [self.gen.register_forward_pre_hook(lambda m, a: events.append(_event())),
                     self.gen.register_forward_hook(lambda m, a, o: events.append(_event()))]
        prof = _Profiler(self.device) if profile_units else None
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            start = time.perf_counter()
            texts = self.stream.request(k)
            try:
                ids, out, place, encode_s = self._serve(texts)
            except Exception as exc:  # a failed request counts, adds no audio, and is shown
                print(f"request {k} failed: {exc!r}", flush=True)
                failed += 1
                k += 1
                continue
            done = time.perf_counter()
            frames = [len(mel) for _, mel, _ in out]
            records.append({"latency_s": done - start, "encode_s": encode_s,
                            "audio_s": sum(frames) * hop / sr, "done": done,
                            "tokens": [len(i) for i in ids], "frames": frames})
            keep.offer({"texts": texts, "ids": ids, "out": out, "place": place,
                        "max_frames": max(frames, default=0), "batches": self.batches})
            k += 1
            if prof is not None and k == profile_units:
                prof.stop()
        t_close = max((r["done"] for r in records), default=time.perf_counter())
        for h in hooks:
            h.remove()
        if prof is not None and prof.running:
            prof.stop()
        _sync(self.device)
        lat = np.array([r["latency_s"] for r in records]) * 1e3
        notes = []
        if len(lat):
            worst = np.argsort(lat)[-5:][::-1]
            notes.append("latency ms p50 %.2f p90 %.2f p95 %.2f p99 %.2f max %.2f; slowest "
                         "(request, issued s, ms): %s" % (
                             *np.percentile(lat, [50, 90, 95, 99]), lat.max(),
                             [(int(i), round(records[i]["done"] - t0 - records[i]["latency_s"], 3),
                               round(float(lat[i]), 1)) for i in worst]))
        self.extras.update(
            notes=notes, window_s=t_close - t0, attempted=k, failed=failed, records=records,
            sample=keep.sample(), trace=prof.trace() if prof else None,
            trace_units=min(profile_units, k),
            vocoder_ms=[a.elapsed_time(b) for a, b in zip(events[::2], events[1::2])]
            if events and events[0] is not None else [])
        return self.extras

    # ----------------------------------------------------------- metrics
    def end_to_end(self) -> dict:
        recs, w = self.extras["records"], self.extras["window_s"]
        out = {"serve_audio_s_per_s": sum(r["audio_s"] for r in recs) / w}
        lat = [r["latency_s"] for r in recs]
        if lat:
            out["serve_p95_ms"] = 1e3 * float(np.quantile(lat, 0.95, method="higher"))
        return out

    # ------------------------------------------------------------- check
    def free(self):
        """Drop the program's state before the reference runs."""
        self.fp = self.gen = None
        self.batches = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict):
        """Each sampled request's utterances, each with what its batch was
        given and returned; an utterance the program never yielded has no
        mel, which the comparison counts."""
        utterances = []
        for req in self.extras["sample"]:
            served = {j: (mel, audio, b, r)
                      for (j, mel, audio), (b, r) in zip(req["out"], req["place"])}
            for j, (text, ids) in enumerate(zip(req["texts"], req["ids"])):
                u = {"text": text, "ids": np.asarray(ids), "mel": None}
                if j in served:
                    mel, audio, b, r = served[j]
                    batch = req["batches"][b]
                    u.update(width=batch["width"], vocoder_frames=batch["frames"], mel=mel,
                             audio=audio,
                             durations=batch["durations"][r, :len(ids)].float().cpu().numpy())
                utterances.append(u)
        self.free()
        return judge_serving(self.ref, self.cfg, self.mix, self.seed, self.device, utterances,
                             limits, self.init_weights, self.leaves)


def _tuples(d: dict) -> dict:
    out = dict(d)
    for k, v in d.items():
        if isinstance(v, list):
            out[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
    return out


def _event():
    if not torch.cuda.is_available():
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Profiler:
    """``torch.profiler`` over the host and the card for a stretch of the
    window, timed by the host's clock between two synchronisations."""

    def __init__(self, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # the first profile in a process starts the tracer, which takes seconds
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device=device).add_(1)
        _sync(device)
        self.device, self.prof = device, torch.profiler.profile(activities=acts)
        self.running, self.span = False, 0.0

    def start(self):
        _sync(self.device)
        self.prof.__enter__()
        self.running, self.t0 = True, time.perf_counter()

    def stop(self):
        _sync(self.device)
        self.span = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.running = False

    def trace(self):
        from ..yardstick.breakdown import read

        return read(self.prof, self.span)


def control(cell, seed: int, device):
    """The control of the serving cells, for ``calibrate.py``: the reference
    served in the program's place one precision below the configuration's,
    on the requests the seed's run would check first (``check_requests`` of
    them), judged against the f32 reference. It serves each utterance alone:
    its text padded to its own ``text_bucket`` multiple, its mel to its own
    ``vocoder_bucket`` multiple. Returns ``(numbers, {})``."""
    from ..reference.nets import Arith, round_durations
    from ..yardstick.judge import reference_nets, serving_numbers

    serve = Serve(cell.cell, cell.config, cell.mix, device, seed, cell.root)
    cfg, mix, ref = serve.cfg, serve.mix, serve.ref
    nets = reference_nets(ref, cfg, seed, device, serve.init_weights)
    low = Arith("fp8" if cfg["precision"] == "bf16" else "tf32")
    stream = traffic.Sentences(mix, seed, cell.root)
    bucket, max_len = int(mix["text_bucket"]), int(mix["max_mel_len"])
    utterances = []
    for k in range(int(mix["check_requests"])):
        for text in stream.request(k):
            ids = np.asarray(ref.encode(cfg, text), np.int64)
            width = traffic.round_up(len(ids), bucket)
            enc, dur = ref.durations(nets, low, torch.as_tensor(ids, device=device), width)
            mel = ref.decode(nets, low, enc, round_durations(dur), max_len)
            frames = min(traffic.round_up(len(mel), int(mix["vocoder_bucket"])), max_len)
            utterances.append({"text": text, "ids": ids, "width": width,
                               "vocoder_frames": frames, "durations": dur.cpu().numpy(),
                               "mel": mel.cpu().numpy(),
                               "audio": ref.vocode(nets, low, mel, frames).cpu().numpy()})
    return serving_numbers(ref, nets, cfg, mix, utterances, device), {}


Driver = Serve
