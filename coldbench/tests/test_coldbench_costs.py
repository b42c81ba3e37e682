"""The frozen cost formulas reproduce rows of the bound column that the
program's own chip runs recorded (PERF.md's kernel table, in ms)."""

import pytest

import costs


def test_flash_bound_olmoe_served():
    ops, nbytes = costs.fwd_cost(1, 16, 16, 256, 256, 128, 2, causal=True, window=0,
                                 prefix_len=0)
    assert costs.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.00125, abs=5e-6)


def test_ssd_scan_bound_mamba2_l1024_bf16():
    ops, nbytes = costs.scan_cost(1, 1024, 48, 64, 128, 256, 2)
    assert costs.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.00444, abs=5e-6)


def test_patch_bound_faas_bench_embed_table():
    rows = costs.leaf_patch_rows(16384 * 384 * 4, 65536)
    assert costs.bound_s(0.0, costs.patch_bytes(rows, 65536)) * 1e3 == pytest.approx(
        0.0150, abs=5e-5)


def test_forward_flops_counts_every_layer_and_the_last_positions_head():
    cfg = {"family": "dense", "d_model": 8, "num_layers": 2, "num_heads": 2,
           "num_kv_heads": 2, "head_dim": 4, "d_ff": 16, "vocab_size": 10,
           "mlp_gated": True, "dtype": "bfloat16"}
    b, s = 3, 5
    proj = 2 * 8 * 6 * 4 + 2 * 8 * 8
    ffn = 3 * 2 * 8 * 16
    attn = 4 * b * 2 * (s * (s + 1) // 2) * 4
    expect = 2 * (b * s * (proj + ffn) + attn) + 2 * b * 8 * 10
    assert costs.forward_flops(cfg, b, s) == expect
