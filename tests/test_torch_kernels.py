"""The port's CUDA kernels against their plain PyTorch twins.

The tests marked ``gpu`` need the card and skip without one. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.) The
others check, on the CPU, the host side that the kernel relies on.
"""

import numpy as np
import pytest
import torch

from neuraltexttospeech_torch.audio.stft import STFTConfig, windowed_frames
from neuraltexttospeech_torch.ops import gouter_kernel, mas, mas_kernel, mel_kernel

CONFIGS = {
    "default": dict(),
    "small": dict(filter_length=64, frame_length=64, frame_step=16, n_mel_channels=8),
}
TOL = dict(atol=1e-3, rtol=1e-4)  # the log-mel budget of tests/test_audio.py


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n_fft", [64, 1024])
def test_dft_constants_give_the_rfft(n_fft):
    x = np.random.default_rng(0).standard_normal((5, n_fft))
    dr, di = mel_kernel._dft_constants(n_fft)
    spec = np.fft.rfft(x, axis=-1)
    np.testing.assert_allclose(x @ dr, spec.real, atol=1e-3)
    np.testing.assert_allclose(x @ di, spec.imag, atol=1e-3)


FFT_LENGTHS = [64, 256, 1024]


@pytest.mark.parametrize("n_fft", FFT_LENGTHS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_csr_mel_basis_reproduces_the_filterbank(name, n_fft):
    """The kernel's sparse basis, expanded, is the dense filterbank exactly;
    each mel's range starts and ends on a nonzero (or is empty)."""
    cfg = STFTConfig(**dict(CONFIGS[name], filter_length=n_fft, frame_length=n_fft))
    dense = cfg.mel_basis()
    lo, ptr, w = mel_kernel._csr_mel_basis(dense)
    assert lo.dtype == ptr.dtype == np.int32 and w.dtype == np.float32
    assert ptr[0] == 0 and ptr[-1] == w.size == np.count_nonzero(dense)
    rebuilt = np.zeros_like(dense)
    for m in range(cfg.n_mel_channels):
        rebuilt[lo[m]:lo[m] + ptr[m + 1] - ptr[m], m] = w[ptr[m]:ptr[m + 1]]
        if ptr[m + 1] > ptr[m]:
            assert w[ptr[m]] != 0 and w[ptr[m + 1] - 1] != 0
    np.testing.assert_array_equal(rebuilt, dense)


@pytest.mark.parametrize("n_fft", FFT_LENGTHS)
def test_twiddles_match_the_exponential(n_fft):
    tw = mel_kernel._twiddles(n_fft)
    k = np.arange(n_fft // 2 + 1)
    want = np.exp(-2j * np.pi * k / n_fft)
    assert tw.dtype == np.float32 and tw.shape == (n_fft // 2 + 1, 2)
    np.testing.assert_allclose(tw[:, 0], want.real, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tw[:, 1], want.imag, rtol=0, atol=1e-7)


def _kernel_fft_steps(frames, n_fft):
    """The kernel's index arithmetic in numpy: the frame read as complex,
    radix-2 Stockham stages with the f32 table, then the split step."""
    h = n_fft // 2
    tw = mel_kernel._twiddles(n_fft)
    w = tw[:, 0] + 1j * tw[:, 1]
    z = frames[:, 0::2] + 1j * frames[:, 1::2]
    s = 1
    while s < h:
        i = np.arange(h // 2)
        q = i & (s - 1)
        a, b = z[:, i], z[:, i + h // 2]
        y = np.empty_like(z)
        y[:, 2 * i - q] = a + b
        y[:, 2 * i - q + s] = (a - b) * w[2 * (i - q)]
        z, s = y, 2 * s
    k = np.arange(h + 1)
    zk, zc = z[:, k & (h - 1)], np.conj(z[:, (h - k) & (h - 1)])
    return (zk + zc) / 2 + w[k] * (zk - zc) / 2j


@pytest.mark.parametrize("n_fft", FFT_LENGTHS)
def test_kernel_fft_steps_give_the_rfft(n_fft):
    """The Stockham stages and split step as the kernel indexes them give
    the real FFT (1e-5 of the largest bin: the f32 twiddles' rounding)."""
    x = np.random.default_rng(n_fft).standard_normal((3, n_fft))
    got, want = _kernel_fft_steps(x, n_fft), np.fft.rfft(x, axis=-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


# n_fft -> mel channels, as the configs that use each length have them
MELS = {64: 8, 256: 16, 1024: 80}


@pytest.mark.gpu
@pytest.mark.parametrize("n_fft", FFT_LENGTHS)
@pytest.mark.parametrize("power", [0.5, 1.0, 2.0])
def test_cuda_kernel_matches_plain_twin(cuda_device, n_fft, power):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = STFTConfig(filter_length=n_fft, frame_length=n_fft, frame_step=n_fft // 4,
                     n_mel_channels=MELS[n_fft], magnitude_power=power)
    rng = np.random.default_rng(4)
    x = torch.as_tensor((rng.standard_normal((3, 200 * n_fft)) * 0.2).astype(np.float32),
                        device=cuda_device)
    frames = windowed_frames(x, cfg.frame_length, cfg.frame_step,
                             cfg.filter_length).reshape(-1, cfg.filter_length).contiguous()
    before = mel_kernel.fused_frames_to_mel.launches
    got = mel_kernel.fused_frames_to_mel(frames, cfg)
    assert mel_kernel.fused_frames_to_mel.launches == before + 1
    torch.testing.assert_close(got, mel_kernel.frames_to_mel_reference(frames, cfg), **TOL)
    # ragged frame counts: not a multiple of a block's frames, and one frame
    for n in (513, 33, 1):
        torch.testing.assert_close(mel_kernel.fused_frames_to_mel(frames[:n].contiguous(), cfg),
                                   mel_kernel.frames_to_mel_reference(frames[:n], cfg), **TOL)


@pytest.mark.gpu
def test_cuda_entry_points_take_the_kernel(cuda_device):
    from neuraltexttospeech_torch.audio.stft import mel_spectrogram

    cfg = STFTConfig()
    x = torch.randn(2, 22050, device=cuda_device) * 0.2
    before = mel_kernel.fused_frames_to_mel.launches
    mel = mel_spectrogram(x, cfg)
    assert mel_kernel.fused_frames_to_mel.launches == before + 1
    frames = windowed_frames(x, 1024, 256, 1024).reshape(-1, 1024)
    torch.testing.assert_close(mel.reshape(-1, 80),
                               mel_kernel.frames_to_mel_reference(frames, cfg), **TOL)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    cfg = STFTConfig()
    frames = torch.zeros(8, 1024, device=cuda_device)
    with pytest.raises(ValueError):
        mel_kernel.fused_frames_to_mel(frames.double(), cfg)
    with pytest.raises(ValueError):
        mel_kernel.fused_frames_to_mel(frames[:, :512], cfg)
    with pytest.raises(ValueError):
        mel_kernel.fused_frames_to_mel(torch.zeros(1024, 8, device=cuda_device).t(), cfg)
    with pytest.raises(ValueError):  # no instantiation for n_fft 512
        mel_kernel.fused_frames_to_mel(frames[:, :512].contiguous(),
                                       STFTConfig(filter_length=512, frame_length=512))
    assert mel_kernel.fused_frames_to_mel(frames[:0], cfg).shape == (0, 80)
    # the sparse basis takes any mel count
    cfg40 = STFTConfig(n_mel_channels=40)
    noise = torch.randn(8, 1024, device=cuda_device) * 0.2
    torch.testing.assert_close(mel_kernel.fused_frames_to_mel(noise, cfg40),
                               mel_kernel.frames_to_mel_reference(noise, cfg40), **TOL)


# ------------------------------------------------------- B1's backward, B2

@pytest.mark.gpu
@pytest.mark.parametrize("power", [0.5, 2.0])
def test_cuda_mel_loss_has_a_gradient_equal_to_the_twins(cuda_device, power):
    """A loss through the kernel keeps its ``grad_fn``, and the analytic
    backward equals autograd through the plain twin (scaled 1e-4, the
    budget of ``tests/test_audio.py``'s VJP test)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = STFTConfig(magnitude_power=power)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((2, 8192)).astype(np.float32)
                        * 0.2, device=cuda_device)
    frames = windowed_frames(x, 1024, 256, 1024).reshape(-1, 1024).contiguous()
    grads = []
    for fn in (mel_kernel.fused_frames_to_mel, mel_kernel.frames_to_mel_reference):
        f = frames.clone().requires_grad_()
        out = fn(f, cfg)
        assert out.grad_fn is not None
        torch.sum(torch.cos(out)).backward()
        grads.append(f.grad)
    scale = grads[1].abs().max()
    torch.testing.assert_close(grads[0] / scale, grads[1] / scale, atol=1e-4, rtol=0)


# (g, B, Qp, X, Y, kf, s, q): forward shapes of the v1 MSD's first scale and
# one dx shape, then a third-scale shape (q = 16) and a ragged q
B2_SHAPES = [
    (4, 16, 1030, 256, 128, 7, 1, 1024),
    (16, 16, 260, 128, 128, 5, 1, 256),
    (16, 16, 66, 512, 256, 3, 1, 64),
    (16, 16, 70, 256, 128, 7, 1, 64),
    (16, 16, 84, 128, 128, 21, 1, 64),
    (4, 16, 1038, 128, 256, 7, 1, 1032),
    (16, 16, 36, 128, 128, 21, 1, 16),
    (4, 3, 29, 128, 512, 5, 3, 17),
]
# every dx call of a v1 GAN step (batch 16 x 8192), whose q = Qp of the
# forward is never a multiple of 64: xp is the padded dy [g, B, Qp', Y] and
# the weights enter flipped and transposed (flip_t), so X and Y swap roles
B2_DX_SHAPES = [
    (4, 16, 1036, 128, 256, 7, 1, 1030), (16, 16, 264, 128, 128, 5, 1, 260),
    (16, 16, 68, 256, 512, 3, 1, 66), (16, 16, 76, 128, 256, 7, 1, 70),
    (16, 16, 104, 128, 128, 21, 1, 84), (4, 16, 524, 128, 256, 7, 1, 518),
    (16, 16, 136, 128, 128, 5, 1, 132), (16, 16, 36, 256, 512, 3, 1, 34),
    (16, 16, 44, 128, 256, 7, 1, 38), (16, 16, 72, 128, 128, 21, 1, 52),
    (4, 16, 268, 128, 256, 7, 1, 262), (16, 16, 72, 128, 128, 5, 1, 68),
    (16, 16, 20, 256, 512, 3, 1, 18), (16, 16, 28, 128, 256, 7, 1, 22),
    (16, 16, 56, 128, 128, 21, 1, 36),
]


def _tap_inputs(shape, flip_t, device, seed=0):
    g, b, qp, x_dim, y_dim, kf, s, q = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    xp = torch.randn(g, b, qp, x_dim, device=device, generator=gen)
    w_shape = (kf, g, y_dim, x_dim) if flip_t else (kf, g, x_dim, y_dim)
    wf = torch.randn(*w_shape, device=device, generator=gen) / (kf * x_dim) ** 0.5
    return xp, wf, s, q


def test_tf32_round_ties_away_and_clears_the_low_bits():
    one_ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2.0 ** -23,
                      1 + 3 * one_ulp / 2, 0.0, -3.5])
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp, 0.0, -3.5])
    got = gouter_kernel.tf32_round(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    r = gouter_kernel.tf32_round(torch.randn(4096))
    assert not (r.view(torch.int32) & 0x1FFF).any()


def test_tf32_split_keeps_22_bits():
    """hi + lo, each a TF32 value, is within 2^-22 of the f32 operand."""
    a = torch.randn(100000) * torch.exp(torch.randn(100000) * 4)
    hi = gouter_kernel.tf32_round(a)
    lo = gouter_kernel.tf32_round(a - hi)
    err = (a.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * a.double().abs()).all()


def _tap_dots_3xtf32(xp, wf, s, q, flip_t):
    """The kernel's arithmetic on the CPU: both operands split into TF32 hi
    and lo by bit masking, lo*hi + hi*lo + hi*hi per tap, products exact
    (float64)."""
    w = torch.flip(wf, (0,)).transpose(-1, -2) if flip_t else wf
    parts = []
    for t in (xp, w):
        hi = gouter_kernel.tf32_round(t)
        parts.append((hi.double(), gouter_kernel.tf32_round(t - hi).double()))
    (a_hi, a_lo), (b_hi, b_lo) = parts
    y = 0.0
    for mf in range(w.shape[0]):
        win = slice(mf * s, mf * s + q)
        bh, bl = b_hi[mf].unsqueeze(1), b_lo[mf].unsqueeze(1)
        y = y + a_lo[:, :, win] @ bh + a_hi[:, :, win] @ bl + a_hi[:, :, win] @ bh
    return y.float()


@pytest.mark.parametrize("shape, flip_t", [
    ((4, 2, 36, 128, 128, 21, 1, 16), False),   # third scale, q = 16, kf = 21
    ((4, 2, 76, 128, 256, 7, 1, 70), True),     # a ragged dx call (q = Qp = 70)
    ((4, 2, 70, 256, 128, 7, 1, 64), False),
    ((4, 3, 29, 128, 512, 5, 3, 17), False),    # strided taps
])
def test_3xtf32_tap_dots_match_plain_twin(shape, flip_t):
    """3xTF32 is inside the kernel's budget against the f32 twin (rtol 1e-5,
    atol 1e-5 of max |y|), at MSD-like widths and tap counts."""
    xp, wf, s, q = _tap_inputs(shape, flip_t, torch.device("cpu"))
    want = gouter_kernel.gouter_tap_dots_reference(xp, wf, s, q, flip_t)
    got = _tap_dots_3xtf32(xp, wf, s, q, flip_t)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("flip_t", [False, True])
def test_weight_split_twin_is_flip_transpose_of_wf(flip_t):
    """The prologue's twin, unswizzled: hi is TF32 and hi + lo is the
    K-major operand (wf transposed, or for flip_t flipped over the taps)."""
    wf = torch.randn(3, 4, 64, 96)
    wk = gouter_kernel.pack_weights_reference(wf, flip_t)
    two, kf, g, kb, n, _ = wk.shape
    assert (two, kf, g, kb * 32, n) == ((2, 3, 4, 96, 64) if flip_t else (2, 3, 4, 64, 96))
    hi, lo = gouter_kernel._swizzle_rows(wk).transpose(3, 4).reshape(2, kf, g, n, kb * 32)
    want = torch.flip(wf, (0,)) if flip_t else wf.transpose(-1, -2)
    torch.testing.assert_close(hi, gouter_kernel.tf32_round(want), rtol=0, atol=0)
    torch.testing.assert_close(hi + lo, want, rtol=2.0 ** -21, atol=0)
    # the swizzle moves whole 16-byte chunks within a row: row n = 1 swaps
    # chunks 0 and 1
    logical = torch.arange(2 * 32, dtype=torch.float32).reshape(1, 2, 32)
    sw = gouter_kernel._swizzle_rows(logical)
    assert sw[0, 0].tolist() == logical[0, 0].tolist()
    assert sw[0, 1, :4].tolist() == logical[0, 1, 4:8].tolist()


@pytest.mark.parametrize("shape", B2_SHAPES + B2_DX_SHAPES)
def test_tile_plan_fills_the_card(shape):
    """Every call launches at least one block per SM (132 on an H100): the
    128x128 tile where it can, else 64x64, else 64x64 with K split into
    non-empty runs of K blocks."""
    g, b, _, x_dim, y_dim, kf, _, q = shape
    n_kb = kf * x_dim // 32
    nwg, bn, splits = gouter_kernel.plan_tiles(g, b * q, y_dim, n_kb)
    blocks = -(-b * q // (64 * nwg)) * (y_dim // bn) * g * splits
    assert (nwg, bn) in ((2, 128), (1, 64)) and 1 <= splits <= n_kb
    assert blocks >= 132 or splits == n_kb
    if splits > 1:
        assert (nwg, bn) == (1, 64)
        per = -(-n_kb // splits)
        assert (splits - 1) * per < n_kb
    if (nwg, bn) == (1, 64):
        assert -(-b * q // 128) * (y_dim // 128) * g < 132


@pytest.mark.gpu
@pytest.mark.parametrize("shape, flip_t", [(s, False) for s in B2_SHAPES]
                         + [(s, True) for s in B2_DX_SHAPES])
def test_cuda_tap_dots_match_plain_twin(cuda_device, shape, flip_t):
    torch.backends.cuda.matmul.allow_tf32 = False
    xp, wf, s, q = _tap_inputs(shape, flip_t, cuda_device)
    before = gouter_kernel.gouter_tap_dots_kernel.launches
    got = gouter_kernel.gouter_tap_dots_kernel(xp, wf, s, q, flip_t)
    torch.cuda.synchronize()
    assert gouter_kernel.gouter_tap_dots_kernel.launches == before + 1
    want = gouter_kernel.gouter_tap_dots_reference(xp, wf, s, q, flip_t)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("flip_t", [False, True])
def test_cuda_weight_split_matches_twin(cuda_device, flip_t):
    wf = torch.randn(7, 16, 256, 128, device=cuda_device)
    got = gouter_kernel.pack_weights(wf, flip_t)
    torch.testing.assert_close(got, gouter_kernel.pack_weights_reference(wf, flip_t),
                               rtol=0, atol=0)


@pytest.mark.gpu
def test_cuda_tap_dots_autograd_matches_twin(cuda_device):
    """Forward and dx through the kernel (two launches), dw through einsum,
    against autograd through the per-tap loop."""
    from neuraltexttospeech_torch.nn.fastconv import gouter_tap_dots
    torch.backends.cuda.matmul.allow_tf32 = False
    g, b, q, x_dim, y_dim, kf, s = 16, 4, 40, 256, 128, 7, 2
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    xp = torch.randn(g, b, q + (kf - 1) * s, x_dim, device=cuda_device, generator=gen)
    wf = torch.randn(kf, g, x_dim, y_dim, device=cuda_device, generator=gen) * 0.03
    dy = torch.randn(g, b, q, y_dim, device=cuda_device, generator=gen)
    grads = []
    for fn in (gouter_tap_dots, gouter_kernel.gouter_tap_dots_reference):
        x, w = xp.clone().requires_grad_(), wf.clone().requires_grad_()
        before = gouter_kernel.gouter_tap_dots_kernel.launches
        (fn(x, w, s, q) * dy).sum().backward()
        grads.append((x.grad, w.grad, gouter_kernel.gouter_tap_dots_kernel.launches - before))
    assert grads[0][2] == 2 and grads[1][2] == 0
    for a, b_ in zip(grads[0][:2], grads[1][:2]):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5 * b_.abs().max().item())


# ------------------------------------------------------------- B2 in bf16

# every forward call of a v1 GAN step (batch 16 x 8192): the dx shapes'
# Qp' is the forward's Qp = q + (kf - 1)*s, and X and Y swap back
B2_FWD_SHAPES = [(g, b, q, x_dim, y_dim, kf, s, q - (kf - 1) * s)
                 for g, b, _, y_dim, x_dim, kf, s, q in B2_DX_SHAPES]


def excess_over_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> float:
    """The bf16 form's tolerance against its twin: both round an f32 sum
    once, taken in different orders, so where the two sums straddle a
    rounding boundary they differ by one bf16 ulp of ``want`` (2^-8 to 2^-7
    of it), plus the sums' own f32 error where y cancels to near zero
    (1e-5 of max |want|). Returns the largest excess over that (<= 0: all
    within)."""
    got, want = got.double(), want.double()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return ((got - want).abs() - ulp - 1e-5 * want.abs().max()).max().item()


def assert_within_one_bf16_ulp(got, want):
    """The bf16 form's tolerance (:func:`excess_over_one_bf16_ulp`)."""
    excess = excess_over_one_bf16_ulp(got.cpu(), want.cpu())
    assert excess <= 0, (f"off by more than one bf16 ulp, by {excess:.3e}; max |diff| "
                         f"{(got.float() - want.float()).abs().max().item():.3e}")


def test_one_bf16_ulp_tolerance_counts_ulps():
    """One bf16 ulp of the twin's value passes, two do not; an element that
    cancels to near zero gets 1e-5 of max |y|."""
    want = torch.tensor([1.0, 3.0, 100.0, 0.0])
    one = torch.tensor([1.0 + 2 ** -7, 3.0 - 2 ** -6, 100.0 + 0.5, 1e-4])
    two = torch.tensor([1.0 + 2 ** -6, 3.0, 100.0, 0.0])
    assert excess_over_one_bf16_ulp(one, want) <= 0
    assert excess_over_one_bf16_ulp(two, want) > 0


def test_bf16_twin_rounds_an_f32_sum_once():
    """The twin on bf16 operands is the f32 twin on the same (exact) values,
    rounded to bf16 once, as the Pallas body's f32 accumulator is."""
    xp, wf, s, q = _tap_inputs((4, 2, 36, 128, 128, 21, 1, 16), False, torch.device("cpu"))
    xb, wb = xp.bfloat16(), wf.bfloat16()
    got = gouter_kernel.gouter_tap_dots_reference(xb, wb, s, q)
    assert got.dtype == torch.bfloat16
    want = gouter_kernel.gouter_tap_dots_reference(xb.float(), wb.float(), s, q)
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("flip_t", [False, True])
def test_bf16_weight_pack_twin_is_flip_transpose_of_wf(flip_t):
    """The prologue's twin on bf16 weights, unswizzled: one part, K blocks of
    64, equal to the K-major operand bit for bit."""
    wf = torch.randn(3, 4, 128, 192).bfloat16()
    wk = gouter_kernel.pack_weights_reference(wf, flip_t)
    parts, kf, g, kb, n, width = wk.shape
    assert wk.dtype == torch.bfloat16 and (parts, width) == (1, 64)
    assert (kf, g, kb * 64, n) == ((3, 4, 192, 128) if flip_t else (3, 4, 128, 192))
    got = gouter_kernel._swizzle_rows(wk).transpose(3, 4).reshape(kf, g, n, kb * 64)
    want = torch.flip(wf, (0,)) if flip_t else wf.transpose(-1, -2)
    assert torch.equal(got, want)
    # a bf16 row's 16-byte chunks hold 8 values: row n = 1 swaps chunks 0, 1
    logical = torch.arange(2 * 64, dtype=torch.float32).reshape(1, 2, 64)
    sw = gouter_kernel._swizzle_rows(logical)
    assert sw[0, 1, :8].tolist() == logical[0, 1, 8:16].tolist()


@pytest.mark.parametrize("shape", B2_FWD_SHAPES + B2_DX_SHAPES)
def test_bf16_tile_plan_fills_the_card(shape):
    """With bf16's K blocks of 64, every call still launches at least one
    block per SM, or splits K as far as it goes."""
    g, b, _, x_dim, y_dim, kf, _, q = shape
    n_kb = kf * x_dim // gouter_kernel.k_block(torch.bfloat16)
    nwg, bn, splits = gouter_kernel.plan_tiles(g, b * q, y_dim, n_kb)
    blocks = -(-b * q // (64 * nwg)) * (y_dim // bn) * g * splits
    assert 1 <= splits <= n_kb and (blocks >= 132 or splits == n_kb)
    assert (splits - 1) * -(-n_kb // splits) < n_kb


@pytest.mark.gpu
@pytest.mark.parametrize("shape, flip_t", [(s, False) for s in B2_FWD_SHAPES + B2_SHAPES[-2:]]
                         + [(s, True) for s in B2_DX_SHAPES])
def test_cuda_bf16_tap_dots_match_plain_twin(cuda_device, shape, flip_t):
    """bf16 forward and dx at every v1 MSD shape (both tiles and the split-K
    path among them), against the bf16 twin."""
    torch.backends.cuda.matmul.allow_tf32 = False
    xp, wf, s, q = _tap_inputs(shape, flip_t, cuda_device)
    xp, wf = xp.bfloat16(), wf.bfloat16()
    before = (gouter_kernel.gouter_tap_dots_kernel.launches,
              gouter_kernel.gouter_tap_dots_kernel.bf16_launches)
    got = gouter_kernel.gouter_tap_dots_kernel(xp, wf, s, q, flip_t)
    torch.cuda.synchronize()
    assert (gouter_kernel.gouter_tap_dots_kernel.launches,
            gouter_kernel.gouter_tap_dots_kernel.bf16_launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16
    want = gouter_kernel.gouter_tap_dots_reference(xp, wf, s, q, flip_t)
    assert_within_one_bf16_ulp(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("flip_t", [False, True])
def test_cuda_bf16_weight_pack_matches_twin(cuda_device, flip_t):
    wf = torch.randn(7, 16, 256, 128, device=cuda_device).bfloat16()
    got = gouter_kernel.pack_weights(wf, flip_t)
    assert torch.equal(got, gouter_kernel.pack_weights_reference(wf, flip_t))


@pytest.mark.gpu
def test_cuda_bf16_tap_dots_autograd_stays_bf16(cuda_device, monkeypatch):
    """Forward and dx through the bf16 kernel (two bf16 launches, bf16
    gradients, no upcast), dw through a bf16 einsum, each within one bf16
    ulp of the f32 gradients through the twin rounded once (autograd through
    the twin on bf16 leaves would round each tap's dx before the sum)."""
    from neuraltexttospeech_torch.nn.fastconv import gouter_tap_dots
    torch.backends.cuda.matmul.allow_tf32 = False
    # dw is a bf16 einsum: cuBLAS sums it in f32 and rounds once
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    g, b, q, x_dim, y_dim, kf, s = 16, 4, 40, 256, 128, 7, 2
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    xp = torch.randn(g, b, q + (kf - 1) * s, x_dim, device=cuda_device, generator=gen).bfloat16()
    wf = (torch.randn(kf, g, x_dim, y_dim, device=cuda_device, generator=gen) * 0.03).bfloat16()
    dy = torch.randn(g, b, q, y_dim, device=cuda_device, generator=gen).bfloat16()
    x, w = xp.clone().requires_grad_(), wf.clone().requires_grad_()
    before = gouter_kernel.gouter_tap_dots_kernel.bf16_launches
    y = gouter_tap_dots(x, w, s, q)
    assert y.dtype == torch.bfloat16
    y.backward(dy)
    assert gouter_kernel.gouter_tap_dots_kernel.bf16_launches - before == 2
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    x32, w32 = xp.float().requires_grad_(), wf.float().requires_grad_()
    gouter_kernel.gouter_tap_dots_reference(x32, w32, s, q).backward(dy.float())
    assert_within_one_bf16_ulp(x.grad, x32.grad.bfloat16())
    assert_within_one_bf16_ulp(w.grad, w32.grad.bfloat16())


@pytest.mark.gpu
def test_cuda_tap_dots_refuse_what_the_kernel_does_not_take(cuda_device):
    xp = torch.zeros(4, 2, 20, 128, device=cuda_device)
    wf = torch.zeros(3, 4, 128, 128, device=cuda_device)
    for args in ((xp[..., :64].contiguous(), wf[:, :, :64].contiguous(), 1, 8),
                 (xp.double(), wf.double(), 1, 8), (xp.half(), wf.half(), 1, 8),
                 (xp.bfloat16(), wf, 1, 8), (xp, wf, 1, 19),
                 (xp, torch.zeros(3, 4, 128, 96, device=cuda_device), 1, 8),
                 (xp.transpose(2, 3), wf, 1, 8),
                 (xp, torch.zeros(3, 4, 128, 256, device=cuda_device), 1, 8, True)):
        with pytest.raises(ValueError):
            gouter_kernel.gouter_tap_dots_kernel(*args)


def _log_attn(shape, seed):
    """log-softmax rows, as the aligner gives MAS."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return torch.log_softmax(x, dim=-1)


def test_mas_twin_on_cpu_counts_no_launch_and_matches_the_oracle():
    la = _log_attn((1, 41, 13), 0)
    before = mas_kernel.maximum_path.launches
    got = mas.maximum_path(la, torch.tensor([13]), torch.tensor([41]))
    assert mas_kernel.maximum_path.launches == before
    np.testing.assert_array_equal(got[0].numpy(), mas.mas_width1_numpy(la[0].numpy()))


# (B, T_mel, T_text, in_lens, out_lens): one symbol, a full block of 1024
# threads, a width off the warp, mel lengths below and past T_mel, 0 frames
MAS_SHAPES = [
    (3, 50, 1, [1, 1, 1], [50, 20, 1]),
    (2, 1100, 1024, [1024, 700], [1100, 1050]),
    (4, 97, 45, [45, 30, 2, 45], [97, 60, 5, 120]),
    (16, 768, 128, [128] * 8 + [100] * 8, [768] * 8 + [700] * 8),
    (2, 870, 192, [192, 160], [870, 0]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(MAS_SHAPES)))
def test_cuda_mas_kernel_equals_twin_bit_for_bit(cuda_device, case):
    B, T_mel, T_text, in_lens, out_lens = MAS_SHAPES[case]
    la = _log_attn((B, T_mel, T_text), case).to(cuda_device)
    in_lens = torch.tensor(in_lens, device=cuda_device)
    out_lens = torch.tensor(out_lens, device=cuda_device)
    before = mas_kernel.maximum_path.launches
    got = mas_kernel.maximum_path(la, in_lens, out_lens)
    torch.cuda.synchronize()
    assert mas_kernel.maximum_path.launches == before + 1
    want = mas_kernel.maximum_path_reference(la, in_lens, out_lens)
    assert torch.equal(got, want)
    assert torch.equal(got.sum(dim=(1, 2)).long(), torch.clamp(out_lens, max=T_mel).long())


@pytest.mark.gpu
def test_cuda_mas_kernel_takes_the_masked_log_of_softmax(cuda_device):
    """Ties everywhere: log(0 + 1e-12) past the text length, equal rows."""
    soft = torch.zeros(2, 64, 32, device=cuda_device)
    soft[0, :, :20] = 0.05
    soft[1] = torch.rand(64, 32, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(0))
    la = torch.log(soft + 1e-12)
    lens = (torch.tensor([20, 32], device=cuda_device), torch.tensor([64, 50], device=cuda_device))
    assert torch.equal(mas_kernel.maximum_path(la, *lens),
                       mas_kernel.maximum_path_reference(la, *lens))


@pytest.mark.gpu
def test_cuda_mas_kernel_refuses_what_it_does_not_take(cuda_device):
    lens = torch.tensor([4, 4], device=cuda_device)
    one = torch.tensor([4], device=cuda_device)  # one length for a batch of two
    for la, ilens in ((torch.zeros(2, 8, 1025, device=cuda_device), lens),
                      (torch.zeros(2, 8, 4, device=cuda_device, dtype=torch.float64), lens),
                      (torch.zeros(2, 8, 4, device=cuda_device), one)):
        with pytest.raises(ValueError):
            mas_kernel.maximum_path(la, ilens, lens)


@pytest.mark.gpu
def test_vocoder_dataset_on_the_card_runs_b1_twice_a_batch(cuda_device, tmp_path):
    """``VocoderDataset(device=cuda)``, the DiffWave trainer's: both mels of
    each batch through B1 on the card, within B1's log-mel budget of the
    host's plain path."""
    from neuraltexttospeech_torch.data.filelist import save_wav
    from neuraltexttospeech_torch.data.mel_dataset import VocoderDataset

    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((2205, 1800, 700, 3000, 1500)):
        paths.append(str(tmp_path / f"utt{i}.wav"))
        save_wav(paths[-1], rng.standard_normal(n) * 0.1, 22050)
    filelist = tmp_path / "list.txt"
    filelist.write_text("\n".join(f"{p}|text" for p in paths) + "\n")
    kw = dict(segment_size=1024, hop_size=256, num_mels=80, seed=12)
    host = list(VocoderDataset(str(filelist), **kw).batches(2, seed=1))
    mel_kernel.fused_frames_to_mel.launches = 0
    card = list(VocoderDataset(str(filelist), device=cuda_device, **kw).batches(2, seed=1))
    assert mel_kernel.fused_frames_to_mel.launches == 2 * len(card) == 4
    for x, y in zip(host, card):
        assert all(v.is_cuda for v in y.values())
        np.testing.assert_array_equal(y["audio"].cpu().numpy(), x["audio"].numpy())
        for k in ("mel", "mel_loss"):
            np.testing.assert_allclose(y[k].cpu().numpy(), x[k].numpy(), **TOL)


@pytest.mark.gpu
def test_asr_dataset_on_the_card_runs_b1_once_an_utterance(cuda_device, tmp_path):
    """``ASRDataset(device=cuda)``, the TalkNet 2 ASR trainer's: each
    utterance's log-mel through B1 on the card (one launch each), at the
    per-utterance shapes of 1.5–3.5 s wavs, within B1's log-mel budget of
    its twin on the same frames and of the host's plain path; padding,
    labels and transcripts as the host's batches."""
    from neuraltexttospeech_torch.data.asr_dataset import ASRDataset
    from neuraltexttospeech_torch.data.filelist import load_wav, save_wav

    rng = np.random.default_rng(0)
    lines = []
    for i, seconds in enumerate((1.5, 2.2, 3.5, 2.9)):
        path = tmp_path / f"utt{i}.wav"
        save_wav(str(path), rng.standard_normal(int(seconds * 22050)) * 0.1, 22050)
        lines.append(f"{path}|hello number {i}")
    filelist = tmp_path / "asr.txt"
    filelist.write_text("\n".join(lines) + "\n")
    host = list(ASRDataset(str(filelist), "cpu").batches(2, seed=1))
    mel_kernel.fused_frames_to_mel.launches = 0
    card = list(ASRDataset(str(filelist), cuda_device).batches(2, seed=1))
    assert mel_kernel.fused_frames_to_mel.launches == len(lines)
    for x, y in zip(host, card):
        assert y["mel"].is_cuda and y["mel"].shape == x["mel"].shape
        np.testing.assert_allclose(y["mel"].cpu().numpy(), x["mel"].numpy(), **TOL)
        for k in ("mel_lens", "labels", "label_lens", "texts"):
            np.testing.assert_array_equal(y[k], x[k])
    cfg = STFTConfig()
    for line in lines:
        audio = torch.as_tensor(load_wav(line.split("|")[0], 22050)[0], device=cuda_device)
        frames = windowed_frames(audio, 1024, 256, 1024).contiguous()
        torch.testing.assert_close(mel_kernel.fused_frames_to_mel(frames, cfg),
                                   mel_kernel.frames_to_mel_reference(frames, cfg), **TOL)


def _gradtts_log_prior(device, b=16, t_mel=512, t_text=160, seed=0):
    """Grad-TTS's Gaussian log-prior of random mu and mels, as MAS takes it
    ([B, T_mel, T_text]); the Grad-TTS step's shape by default."""
    from neuraltexttospeech_torch.models.gradtts import gaussian_log_prior

    g = torch.Generator().manual_seed(seed)
    mu, y = torch.randn(b, t_text, 80, generator=g), torch.randn(b, t_mel, 80, generator=g)
    return gaussian_log_prior(mu.to(device), y.to(device)).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("full", [True, False])
def test_cuda_mas_kernel_at_the_gradtts_step_shape(cuda_device, full):
    """16 × 512 frames × 160 tokens (``bench.py:519``), bit for bit, at full
    lengths and at mixed ones."""
    la = _gradtts_log_prior(cuda_device)
    rng = np.random.default_rng(1)
    in_lens = torch.tensor([160] * 16 if full else rng.integers(40, 161, 16), device=cuda_device)
    out_lens = torch.tensor([512] * 16 if full else rng.integers(200, 513, 16),
                            device=cuda_device)
    before = mas_kernel.maximum_path.launches
    got = mas_kernel.maximum_path(la, in_lens, out_lens)
    torch.cuda.synchronize()
    assert mas_kernel.maximum_path.launches == before + 1
    assert torch.equal(got, mas_kernel.maximum_path_reference(la, in_lens, out_lens))
    assert torch.equal(got.sum(dim=(1, 2)).long(), out_lens.long())


@pytest.mark.gpu
def test_cuda_gradtts_loss_launches_mas_once(cuda_device):
    from neuraltexttospeech_torch.models.gradtts import GradTTS, GradTTSConfig

    torch.manual_seed(0)
    model = GradTTS(GradTTSConfig(n_enc_channels=32, filter_channels=64, filter_channels_dp=32,
                                  n_enc_layers=1, dec_dim=8)).to(cuda_device)
    x = torch.randint(1, 148, (2, 16), device=cuda_device)
    y = torch.randn(2, 64, 80, device=cuda_device)
    lens = (torch.tensor([16, 9], device=cuda_device), torch.tensor([64, 40], device=cuda_device))
    before = mas_kernel.maximum_path.launches
    losses = model.compute_loss(x, lens[0], y, lens[1], out_size=32,
                                generator=torch.Generator(device=cuda_device).manual_seed(1))
    torch.cuda.synchronize()
    assert mas_kernel.maximum_path.launches == before + 1
    assert all(torch.isfinite(v) for v in losses)


def _textgrid(intervals, xmax):
    items = "\n".join(f"        intervals [{i + 1}]:\n            xmin = {s}\n"
                      f"            xmax = {e}\n            text = \"{p}\""
                      for i, (s, e, p) in enumerate(intervals))
    return ("File type = \"ooTextFile\"\nObject class = \"TextGrid\"\n\nxmin = 0\n"
            f"xmax = {xmax}\ntiers? <exists>\nsize = 1\nitem []:\n    item [1]:\n"
            "        class = \"IntervalTier\"\n        name = \"phones\"\n        xmin = 0\n"
            f"        xmax = {xmax}\n        intervals: size = {len(intervals)}\n{items}\n")


@pytest.mark.gpu
def test_fs2_preprocessor_on_the_card_runs_b1_once_a_wav(cuda_device, tmp_path):
    """``FS2Preprocessor(device=cuda)``, FastSpeech 2's prep: one utterance's
    log-mel through B1 on the card, within B1's log-mel budget of the host's
    plain path; the same durations, and pitch and energy as the host's."""
    from neuraltexttospeech_torch.data.filelist import save_wav
    from neuraltexttospeech_torch.data.fs2_preprocess import FS2Preprocessor

    intervals = [(0.0, 0.2, "sil"), (0.2, 0.9, "HH"), (0.9, 1.6, "AY1"), (1.6, 2.3, "DH"),
                 (2.3, 3.1, "IY1"), (3.1, 3.3, "sp")]
    t = np.arange(int(22050 * 3.3)) / 22050
    save_wav(str(tmp_path / "u.wav"), 0.4 * np.sin(2 * np.pi * 180 * t)
             + 0.01 * np.random.default_rng(0).standard_normal(t.size), 22050)
    (tmp_path / "u.TextGrid").write_text(_textgrid(intervals, 3.3))
    args = ("u", "u", str(tmp_path / "u.wav"), str(tmp_path / "u.TextGrid"))
    host = FS2Preprocessor(str(tmp_path), str(tmp_path), str(tmp_path / "host"), device="cpu")
    card = FS2Preprocessor(str(tmp_path), str(tmp_path), str(tmp_path / "card"),
                           device=cuda_device)
    want = host.process_utterance(*args)
    mel_kernel.fused_frames_to_mel.launches = 0
    got = card.process_utterance(*args)
    assert mel_kernel.fused_frames_to_mel.launches == 1
    assert (got["phones"], got["n_frames"]) == (want["phones"], want["n_frames"])
    for kind in ("duration", "mel"):
        g, w = (np.load(tmp_path / d / f"u_{kind}.npy") for d in ("card", "host"))
        if kind == "duration":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_array_equal(got["pitch"], want["pitch"])  # from the wav, on the host
    np.testing.assert_allclose(got["energy"], want["energy"], atol=1e-3, rtol=0)
