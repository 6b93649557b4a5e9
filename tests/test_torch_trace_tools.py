"""The port's trace and audio tools on the CPU.

- ``tools/torch_trace_breakdown.py`` (``utils/profiling.py::chrome_breakdown``)
  on a Chrome trace written here: the categories, the ms a step, the busy
  time as the union of overlapping kernels, the idle share of the window;
  ``utils/profiling.py::breakdown`` on a real (CPU) profile reads the same
  host records as the Chrome trace it exports.
- ``tools/torch_trace_capture.py`` builds and traces a case on the CPU.
- ``tools/torch_audio_compare.py``: the plain log-mel path and B1's twin on
  a synthetic wav within the 1e-3 budget of the float64 oracle, and the
  loaders agree.
"""

import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from neuraltexttospeech_torch.utils import profiling  # noqa: E402
from tools import torch_audio_compare, torch_trace_breakdown, torch_trace_capture  # noqa: E402


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


# Two steps' worth, in µs: two GEMMs that overlap (20-60 and 40-80: 60 µs
# busy, 80 µs summed), B2 bf16 twice, B1 once, a conv, a copy, a memset;
# host records that are not device time; a GPU annotation that is a range.
TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python"}},
    _x("aten::mm", "cpu_op", 0, 10),
    _x("aten::conv1d", "cpu_op", 5, 5),
    _x("cudaLaunchKernel", "cuda_runtime", 6, 2),
    _x("cudaLaunchKernel", "cuda_runtime", 9, 2),
    _x("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x16", "kernel", 20, 40),
    _x("nvjet_tst_64x8_64x16_2x1_v_bz_TNN", "kernel", 40, 40),
    _x("void window_taps_bf16_kernel<2, 2>(WinArgs)", "kernel", 100, 30),
    _x("void window_taps_bf16_kernel<2, 2>(WinArgs)", "kernel", 140, 30),
    _x("void logmel_fft_kernel<1024>(float const*)", "kernel", 180, 10),
    _x("void cudnn::engines_precompiled::conv2d_grouped_direct_kernel", "kernel", 200, 20),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 230, 5),
    _x("Memset (Device)", "gpu_memset", 240, 1),
    _x("Optimizer.step#Adam.step", "gpu_user_annotation", 0, 400),
    _x("python_step", "python_function", 0, 300),
]}


def test_chrome_breakdown_of_a_written_trace(tmp_path, capsys):
    path = tmp_path / "trace_1.json"
    path.write_text(json.dumps(TRACE))
    b = torch_trace_breakdown.main([str(tmp_path), "--steps", "2", "--top", "3"])
    out = capsys.readouterr().out
    assert b.steps == 2
    assert b.busy_ms == pytest.approx((60 + 30 + 30 + 10 + 20 + 5 + 1) / 1e3)
    assert b.kernel_sum_ms == pytest.approx((40 + 40 + 30 + 30 + 10 + 20 + 5 + 1) / 1e3)
    assert b.window_ms == pytest.approx(300 / 1e3)  # 0 .. 300, the annotation left out
    assert b.idle_share == pytest.approx(1 - 156 / 300)
    assert b.launches == 8 and b.ops == {"aten::mm": 1, "aten::conv1d": 1}
    assert b.runtime == {"cudaLaunchKernel": (2, pytest.approx(4 / 1e3))}
    cats = b.by_category()
    assert list(cats) == list(profiling.CATEGORIES)
    assert cats["GEMM"] == (pytest.approx(0.08), 2)
    assert cats["B2 bf16"] == (pytest.approx(0.06), 2) and cats["B1"] == (pytest.approx(0.01), 1)
    assert cats["cuDNN conv"] == (pytest.approx(0.02), 1)
    assert cats["copy/memset"] == (pytest.approx(0.006), 2)
    assert cats["B2 f32"] == cats["MAS"] == cats["other"] == (0.0, 0)
    assert "card busy 0.078 ms/step of a 0.150 ms/step window (idle share 0.480)" in out
    assert "GEMM               0.040" in out  # ms a step
    assert len([line for line in out.splitlines() if "(GEMM)" in line]) == 2
    # the file itself, too
    assert torch_trace_breakdown.summarize(str(path), 2).busy_ms == b.busy_ms


@pytest.mark.parametrize("name,cat", [
    ("void logmel_fft_kernel<256>(float const*, float2 const*)", "B1"),
    ("void tap_dots_tc_kernel<Tf32x3, 2, 128>(TapArgs)", "B2 f32"),
    ("void pack_weights_kernel<Tf32x3>(float const*, float*, int)", "B2 f32"),
    ("void sum_splits_kernel<float>(float4 const*, float*, int, unsigned long)", "B2 f32"),
    ("void sum_splits_kernel<__nv_bfloat16>(float4 const*, __nv_bfloat16*, int)", "B2 bf16"),
    ("void pack_weights_kernel_bf16(uint4 const*, uint4*, int, int)", "B2 bf16"),
    ("void mas_kernel<4, false>(MasArgs)", "MAS"),
    ("cutlass_80_simt_sgemm_128x128_8x4_nn_align1", "GEMM"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc", "cuDNN conv"),
    ("void at::native::conv_depthwise2d_forward_kernel<float>", "cuDNN conv"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "reduction"),
    ("void at::native::vectorized_layer_norm_kernel<float, float>", "reduction"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>", "copy/memset"),
    ("RNN_blockPersist_fp_LSTM<float, float, float>", "other"),
])
def test_category(name, cat):
    assert profiling.category(name) == cat


def test_breakdown_reads_the_profile_the_chrome_trace_holds(tmp_path):
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(2):
            (x @ x).relu().sum()
    b = profiling.breakdown(prof, steps=2)
    c = profiling.chrome_breakdown(profiling.load_chrome_trace(str(tmp_path)), steps=2)
    assert b.ops == c.ops and b.ops["aten::mm"] == 2
    assert b.busy_ms == c.busy_ms == 0.0 and b.idle_share == 1.0  # no card here
    assert 0 < b.window_ms <= c.window_ms


def test_trace_capture_runs_a_case_on_the_cpu(tmp_path, capsys):
    b = torch_trace_capture.main(["fastpitch_infer", "--device", "cpu", "--batch", "1",
                                  "--steps", "1", "--top", "2", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert b.steps == 1 and b.ops["aten::linear"] > 0
    assert "FastPitch.infer, 1 x 128 tokens, max_mel_len 1024, f32 (TF32 off)" in out
    assert list(tmp_path.glob("trace_*.json"))


def test_audio_compare_holds_the_plain_path_to_float64(tmp_path, capsys):
    wav = torch_audio_compare.synthetic_wav(tmp_path / "s.wav", 2.0, seed=3)
    res = torch_audio_compare.compare(str(wav), device="cpu")
    out = capsys.readouterr().out
    assert res["frames"] == 1 + (2 * 22050 - 1024) // 256
    assert res["loaders"]["wave"] == res["loaders"]["port load_wav"] == 0.0
    for pair in (("plain", "float64"), ("B1", "float64")):
        l1, linf = res["pairs"][pair]
        assert l1 <= linf <= 1e-3
    assert "parity plain vs float64" in out and "FAIL" not in out


def test_audio_compare_fails_past_its_budget(tmp_path, monkeypatch):
    wav = torch_audio_compare.synthetic_wav(tmp_path / "s.wav", 1.0, seed=4)
    monkeypatch.setattr(torch_audio_compare, "BUDGET", 1e-9)
    with pytest.raises(RuntimeError, match="past the 1e-09 budget"):
        torch_audio_compare.compare(str(wav), device="cpu")


def test_tools_without_a_device_need_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_trace_capture.capture("fastpitch_infer", str(tmp_path))
    wav = torch_audio_compare.synthetic_wav(tmp_path / "s.wav", 0.5, seed=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_audio_compare.compare(str(wav))
