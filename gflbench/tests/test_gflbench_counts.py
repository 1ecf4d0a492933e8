"""The yardstick's counts against hand counts."""
import pytest

from gflbench import counts, peaks

D = 134_515_008


def test_fold_bytes():
    # gradients P L D, the parameters P D read once, psi P D written once
    assert counts.fold_bytes(10, 50, 2) == (1000 + 20 + 20) * 4
    assert counts.fold_bytes(4, 2, D) == (8 + 4 + 4) * D * 4 == 8_608_960_512


def test_combine_bytes():
    # A, then psi, the noise and the output
    assert counts.combine_bytes(10, 2) == 400 + 3 * 20 * 4
    assert counts.combine_bytes(4, D) == 64 + 3 * 4 * D * 4 == 6_456_720_448


def test_lm_flops_per_token():
    # 6 N and PaLM's 12 L d S at SmolLM-135M's full context
    assert counts.lm_flops_per_token(D, 30, 576, 2048) == (
        6 * D + 12 * 30 * 576 * 2048) == 1_231_763_328
    # a client pass of 2 x 2048 tokens is ~5.05 TFLOP
    assert counts.lm_flops_per_token(D, 30, 576, 2048) * 4096 == \
        pytest.approx(5.045e12, rel=1e-3)


def test_logistic_round_flops():
    # (P, L, B, M) = (10, 50, 10, 2): gradients 40,000 + 20,000 + 2,000;
    # clip 2,000 + 2,000; fold 4,000; combine 400 + 40
    assert counts.logistic_round_flops(10, 50, 10, 2) == 70_440


def test_peaks_are_the_data_sheets():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.F32_FLOPS_PER_S == 67e12
    assert peaks.BF16_FLOPS_PER_S == 989e12
