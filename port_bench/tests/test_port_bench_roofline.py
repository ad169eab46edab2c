"""``roofline.py`` against counts worked by hand."""

import pytest

from port_bench import harness, roofline

CFG = harness.config("smer_flagship")


def test_rowvec_token_matches_the_kernel_tables_row_1a():
    # B = 3: 24 bf16 products (QKV 512x1536, three 512x512, 512x2048,
    # 2048x512 a layer) and the f32 logits 512x384, each with its rows
    nbytes, flops = roofline.rowvec_token(CFG, 3)
    per_layer = 2 * (512 * 1536 + 3 * 512 * 512 + 2 * 512 * 2048)
    acts = 4 * sum(3 * k + 3 * n + n for k, n in ((512, 1536), (512, 512), (512, 512), (512, 512),
                                                    (512, 2048), (2048, 512)))
    logits = 512 * 384 * 4 + 4 * (3 * 512 + 3 * 384 + 384)
    assert nbytes == 4 * (per_layer + acts) + logits == 30_740_480
    assert roofline.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.0092, abs=5e-5)


def test_attend_decode_by_hand():
    # one row live for 3 positions against 10 source keys: 1+2+3 self keys
    # and 3 x 10 cross keys a layer, 2 x 512 bf16 values a key
    nbytes, flops = roofline.attend_decode(CFG, [3], [10])
    assert nbytes == 4 * 36 * 1024 * 2 + 4 * 3 * 1024 * 4
    assert flops == 4 * 36 * 4 * 512


def test_train_step_near_three_teraflop_at_the_long_bucket():
    # the issue's ~2.9 TFLOP at 8 x 2048 + 512 padded
    assert roofline.train_flops(CFG, [2048] * 8, [512] * 8) == pytest.approx(2.9e12, rel=0.05)


def test_flash_train_pairs_by_hand():
    # one row, 4 source and 2 target tokens: 4 layers x 16 encoder pairs,
    # 4 x (3 causal + 8 cross) decoder pairs, 2 x 512 a pair, 7 products
    assert roofline.flash_train_step(CFG, [4], [2]) == 2 * 512 * (4 * 16 + 4 * 11) * 7
