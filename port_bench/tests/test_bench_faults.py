"""Runs with the timed path broken underneath come out not correct: every
fault of ``faults.py`` that a cell can have, planted in the program, at a
small size on the CPU."""

import pytest

from port_bench.faults import FAULTS

from ._tiny import rehearse

CASES = [("fastpitch-lj.serve-doc", "altered_token"), ("fastpitch-lj.serve-doc", "altered_audio"),
         ("fastpitch-lj.serve-doc", "half_batch_vocoder"),
         ("fastpitch-lj.serve-single", "altered_token"),
         ("fastpitch-lj.serve-single", "altered_audio"),
         ("hifigan-v1.train", "state_unchanged"), ("hifigan-v1.train", "small_leaves_unchanged"),
         ("hifigan-v1.train", "half_batch_step"),
         ("fastpitch-lj.train", "lamb_state_unchanged"),
         ("fastpitch-lj.train", "lamb_without_trust_ratio"),
         ("fastpitch-lj.train", "mas_shifted"), ("fastpitch-lj.train", "dropout_skipped"),
         ("fastpitch-lj.train", "half_rows_loss"),
         ("fastpitch-lj.train", "accumulation_drops_half"),
         ("fastpitch-lj.train", "half_batch_train_step")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    with FAULTS[fault]():
        result, checks = rehearse(cell)
    assert result["correct"] is False, checks
