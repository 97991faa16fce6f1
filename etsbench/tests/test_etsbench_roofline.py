"""The roofline's work counts against calls worked out by hand."""
import numpy as np
import pytest

from etsbench.roofline import work


def test_tree_call_counts_each_live_page_once():
    # three live pages over two rows: page 0 shared by both, page 1 row
    # 0's, page 2 row 1's; a fourth, padded entry is not live
    mask = np.array([[1, 1], [1, 0], [0, 1], [0, 0]], np.int8)
    lens = np.array([16, 5, 7, 0], np.int32)
    H, K, hd, el = 8, 2, 64, 4
    nbytes, flops = work.tree_call(mask, lens, 3, H, K, hd, el)
    kv = (16 + 5 + 7) * K * hd * 2 * el
    q_out = 2 * 2 * H * hd * el
    meta = 3 * (4 + 4 + 2)
    assert nbytes == kv + q_out + meta
    # row 0 attends 16 + 5 tokens, row 1 16 + 7
    assert flops == 4 * H * hd * (21 + 23)


def test_tree_call_skips_rows_that_attend_nothing():
    mask = np.array([[1, 0, 0]], np.int8)
    nbytes, flops = work.tree_call(mask, np.array([3]), 1, 4, 4, 8, 2)
    assert nbytes == 3 * 4 * 8 * 2 * 2 + 2 * 1 * 4 * 8 * 2 + (4 + 4 + 3)
    assert flops == 4 * 4 * 8 * 3


def test_flash_call_counts_unpadded_causal_work():
    nbytes, flops = work.flash_call([3, 0, 2], 4, 2, 16, 2)
    assert nbytes == 5 * (2 * 4 + 2 * 2) * 16 * 2
    assert flops == 4 * 4 * 16 * (6 + 0 + 3)


def test_bound_takes_the_longer_of_bytes_and_operations():
    p = work.PEAKS
    assert work.bound_s(p["bytes_per_s"], 0, "float32") == pytest.approx(1.0)
    assert work.bound_s(0, p["flops_per_s"]["bfloat16"], "bfloat16") \
        == pytest.approx(1.0)
    assert work.bound_s(1.0, 67e12, "float32") == pytest.approx(1.0)
