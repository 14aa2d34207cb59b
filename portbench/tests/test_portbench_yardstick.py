"""Operations and bytes at hand-worked shapes."""
import pytest

from portbench import spec, testing, yardstick

CFG = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 100,
       "intermediate_size": 128}
MOE = dict(CFG, num_experts=8, num_experts_per_tok=2,
           moe_intermediate_size=32)


def test_active_params():
    # attention 2*64*64 + 2*64*32 = 12288; SwiGLU 3*64*128 = 24576
    assert yardstick.active_params(CFG) == 2 * (12288 + 24576) + 64 * 100
    # MoE: two experts of 3*64*32 and the router 64*8
    assert yardstick.active_params(MOE) == 2 * (12288 + 2 * 6144 + 512) \
        + 6400


def test_step_flops():
    # two rows at contexts 10 and 30, W=3 with 6 ancestor pairs
    p = yardstick.active_params(CFG)
    attn = 4 * 4 * 16 * ((3 * 10 + 6) + (3 * 30 + 6)) * 2
    assert yardstick.step_flops(CFG, 3, 6, [10, 30]) == 2 * p * 3 * 2 + attn


def test_b2_bound_is_bytes_or_ops_per_layer():
    # two rows at contexts 100 and 0, W=8: per layer K+V 2*2*16*100 slots,
    # q and out 2*2*8*4*16, tree K/V 2*2*8*2*16, all bf16
    nbytes = 2 * (2 * 2 * 16 * 100 + 2 * 2 * 8 * 4 * 16 + 2 * 2 * 8 * 2 * 16)
    ops = 4 * 4 * 16 * (8 * 100 + 20 + 20)
    want = 2 * max(nbytes / yardstick.HBM_BYTES_PER_S,
                   ops / yardstick.PEAK_BF16_FLOPS)
    assert yardstick.b2_bound_s(CFG, 8, 20, [100, 0]) == pytest.approx(want)


def test_tree_nnz_and_the_cell_tree():
    mask = [[1, 0, 0], [1, 1, 0], [1, 0, 1]]
    assert yardstick.tree_nnz(mask) == 5
    from repro_torch.core.speculative import tree as T
    t = T.build_tree(T.default_accs(4, 10), 8)
    assert yardstick.tree_nnz(t.mask) == sum(int(d) + 1 for d in t.depth)


def test_dims_read_the_config_files():
    bench = testing.bench()
    m = yardstick.dims(spec.config_file(bench, "qwen3-moe-30b-a3b"))
    assert (m["f"], m["E"], m["K"], m["hd"]) == (768, 128, 8, 128)
    d = yardstick.dims(spec.config_file(bench, "mistral-7b"))
    assert (d["f"], d["E"], d["hd"], d["Hkv"]) == (14336, 0, 128, 8)
