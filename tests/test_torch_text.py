"""The port's text front-end and batching match the JAX package's."""

import numpy as np
import pytest

from neuraltexttospeech_torch.text.processing import TextProcessing as PortTP
from neuraltexttospeech_torch.utils import serving as port_serving
from neuraltexttospeech_tpu.text.processing import TextProcessing as JaxTP
from neuraltexttospeech_tpu.utils import serving as jax_serving

PHRASES = [
    "The quick brown fox jumps over the lazy dog.",
    "Dr. Smith lives at 221B Baker St., London.",
    "It cost $12.50, or 1,234 yen in 2021!",
    "Mr. and Mrs. Jones arrived on the 3rd of May at 10 p.m.",
    "She said: \"Hello -- world?\" (twice)",
    "Numbers: 0, 7, 42, 1000000, 3.14159 and 1/2.",
    "The year 1865 ended the war; the 19th century went on.",
    "Café naïve résumé — with accents.",
    "{HH AH0 L OW1} world, in ARPAbet.",
    "ALL CAPS and MiXeD case; semi-colons; hyphen-ated words.",
    "Etc., e.g., i.e. and vs. abbreviations.",
    "",
]


@pytest.mark.parametrize("symbol_set", ["english_basic", "english_basic_lowercase"])
@pytest.mark.parametrize("cleaners", [["english_cleaners_v2"], ["basic_cleaners"]])
def test_encode_text_matches_jax(symbol_set, cleaners):
    port = PortTP(symbol_set, cleaners, p_arpabet=0.0)
    ref = JaxTP(symbol_set, cleaners, p_arpabet=0.0)
    for phrase in PHRASES:
        assert port.encode_text(phrase) == ref.encode_text(phrase), phrase
        assert port.clean_text(phrase) == ref.clean_text(phrase), phrase


def test_round_up_matches_jax():
    for n in range(0, 300, 7):
        for m in (1, 16, 32, 128):
            assert port_serving.round_up(n, m) == jax_serving.round_up(n, m)


@pytest.mark.parametrize("batch_size,bucket", [(1, 16), (3, 16), (8, 32)])
def test_text_batches_match_jax(batch_size, bucket):
    rng = np.random.default_rng(0)
    encoded = [rng.integers(1, 100, rng.integers(1, 70)).astype(np.int32)
               for _ in range(11)]
    ours = list(port_serving.text_batches(encoded, batch_size, bucket))
    theirs = list(jax_serving.text_batches(encoded, batch_size, bucket))
    assert len(ours) == len(theirs)
    for (i1, t1, l1), (i2, t2, l2) in zip(ours, theirs):
        assert i1 == i2
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(l1, l2)
