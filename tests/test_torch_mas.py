"""Monotonic alignment search and the attention prior: the port against JAX.

- ``maximum_path`` (the CPU twin of the MAS kernel) equals JAX's
  ``maximum_path`` exactly on random batches with variable text and mel
  lengths, and equals the float64 numpy oracle ``mas_width1_numpy`` at full
  lengths (the paths are 0/1, so "exactly" is the only tolerance);
- the port's copy of ``mas_width1_numpy`` and ``b_mas`` agree with JAX's;
- ``ops/prior.py`` (f32 ``lgamma`` on the device) is within 2e-3 of the
  scipy pmf, as ``tests/test_misc.py`` holds JAX's, and within 1e-3 of JAX's
  own f32 version (two f32 ``lgamma`` implementations, seven terms that
  largely cancel: 1.4e-5 seen at 40 x 17, 4.4e-4 at 870 x 190);
  ``data/prior.py`` equals JAX's host prior exactly.

The kernel itself is held against the twin on the card in
``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraltexttospeech_torch.data import prior as port_host_prior
from neuraltexttospeech_torch.ops import mas as port_mas
from neuraltexttospeech_torch.ops.prior import beta_binomial_prior
from neuraltexttospeech_tpu.data import prior as jax_host_prior
from neuraltexttospeech_tpu.ops import mas as jax_mas
from neuraltexttospeech_tpu.ops.prior import beta_binomial_prior as jax_prior


def _report(what, got, want, rel=False):
    """Print the largest difference (``pytest -s`` shows it)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    if rel:
        d = d / np.maximum(np.abs(want), 1e-30)
    print(f"{what}: max {'relative ' if rel else ''}|port - reference| "
          f"{(d.max() if d.size else 0.0):.3e}")


def _log_attn(rng, shape):
    """log-softmax-like rows, as the aligner gives them."""
    x = rng.standard_normal(shape)
    return (x - np.log(np.exp(x).sum(axis=-1, keepdims=True))).astype(np.float32)


CASES = [  # (B, T_mel, T_text, in_lens, out_lens)
    (4, 53, 17, [17, 9, 13, 5], [53, 30, 41, 22]),
    (3, 40, 16, [16, 1, 7], [40, 40, 12]),      # a one-symbol text
    (2, 24, 24, [24, 20], [24, 21]),             # as many symbols as frames
    (3, 64, 32, [30, 32, 11], [70, 64, 0]),      # out_len past T_mel, and 0
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_maximum_path_twin_equals_jax(case):
    B, T_mel, T_text, in_lens, out_lens = CASES[case]
    la = _log_attn(np.random.default_rng(case), (B, T_mel, T_text))
    want = np.asarray(jax_mas.maximum_path(jnp.asarray(la), jnp.asarray(in_lens),
                                           jnp.asarray(out_lens)))
    got = port_mas.maximum_path(torch.as_tensor(la), torch.as_tensor(in_lens),
                                torch.as_tensor(out_lens))
    assert got.dtype == torch.float32 and got.shape == (B, T_mel, T_text)
    np.testing.assert_array_equal(got.numpy(), want)


def test_maximum_path_ties_and_masked_keys_equal_jax():
    """Rows of equal values (every comparison a tie) and the -1e9 of masked
    keys reaching the log as log(0 + 1e-12), as in the training forward."""
    soft = np.zeros((2, 20, 8), np.float32)
    soft[0, :, :5] = 0.2           # keys past in_len = 5 are exactly 0
    soft[1] = np.random.default_rng(3).uniform(0, 1, (20, 8)).astype(np.float32)
    la = np.log(soft + 1e-12).astype(np.float32)
    in_lens, out_lens = np.array([5, 8]), np.array([20, 17])
    want = np.asarray(jax_mas.maximum_path(jnp.asarray(la), jnp.asarray(in_lens),
                                           jnp.asarray(out_lens)))
    got = port_mas.maximum_path(torch.as_tensor(la), torch.as_tensor(in_lens),
                                torch.as_tensor(out_lens))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(37, 11), (64, 21), (10, 10), (90, 1)])
def test_maximum_path_matches_numpy_oracle_at_full_lengths(shape):
    la = _log_attn(np.random.default_rng(shape[0]), shape)
    want = jax_mas.mas_width1_numpy(la)
    np.testing.assert_array_equal(port_mas.mas_width1_numpy(la), want)
    got = port_mas.maximum_path(torch.as_tensor(la[None]), torch.tensor([shape[1]]),
                                torch.tensor([shape[0]]))[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_path_is_monotonic_and_complete():
    rng = np.random.default_rng(2)
    in_lens, out_lens = np.array([21, 10, 15]), np.array([64, 40, 50])
    la = _log_attn(rng, (3, 64, 21))
    path = port_mas.b_mas(torch.as_tensor(la[:, None]), torch.as_tensor(in_lens),
                          torch.as_tensor(out_lens))
    assert path.shape == (3, 1, 64, 21)
    want = np.asarray(jax_mas.b_mas(la[:, None], in_lens, out_lens))
    np.testing.assert_array_equal(path.numpy(), want)
    for b in range(3):
        p = path[b, 0, :out_lens[b], :in_lens[b]].numpy()
        assert (p.sum(axis=1) == 1).all()                     # one symbol per frame
        assert p.sum() == out_lens[b]                          # durations sum to the mel length
        j = p.argmax(axis=1)
        assert j[0] == 0 and j[-1] == in_lens[b] - 1 and (np.diff(j) >= 0).all()
        assert (np.diff(j) <= 1).all() and (p.sum(axis=0) > 0).all()
        assert path[b, 0, out_lens[b]:].sum() == 0
    with pytest.raises(ValueError, match="width"):
        port_mas.b_mas(torch.as_tensor(la[:, None]), torch.as_tensor(in_lens),
                       torch.as_tensor(out_lens), width=2)


@pytest.mark.parametrize("mel_lens,text_lens", [([40, 25, 7], [17, 9, 3]),
                                                ([870, 300], [190, 60])])
def test_device_prior_matches_scipy_and_jax(mel_lens, text_lens):
    M, P = max(mel_lens) + 3, max(text_lens) + 5  # padding rows and columns
    got = beta_binomial_prior(torch.as_tensor(mel_lens), torch.as_tensor(text_lens), M, P)
    assert got.shape == (len(mel_lens), M, P) and got.dtype == torch.float32
    for b, (m, p) in enumerate(zip(mel_lens, text_lens)):
        exact = port_host_prior.beta_binomial_prior_distribution(p, m)
        _report(f"prior {m}x{p} vs scipy", got[b, :m, :p].numpy(), exact)
        np.testing.assert_allclose(got[b, :m, :p].numpy(), exact, atol=2e-3, rtol=0)
        assert got[b, m:].sum() == 0 and got[b, :, p:].sum() == 0
    want = np.asarray(jax.jit(jax_prior, static_argnums=(2, 3))(
        jnp.asarray(mel_lens), jnp.asarray(text_lens), M, P))
    _report(f"prior {M}x{P} vs JAX", got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_host_prior_and_interpolator_equal_jax():
    np.testing.assert_array_equal(port_host_prior.beta_binomial_prior_distribution(17, 40),
                                  jax_host_prior.beta_binomial_prior_distribution(17, 40))
    np.testing.assert_array_equal(port_host_prior.BetaBinomialInterpolator()(130, 37),
                                  jax_host_prior.BetaBinomialInterpolator()(130, 37))
