"""The yardstick's counts against hand-worked shapes and against the
port's own analytic FLOPs (CPU)."""
import dataclasses

import pytest

from portbench import yardstick as ys


@dataclasses.dataclass(frozen=True)
class Cfg:
    """The fields of a decoder config the yardstick reads."""
    n_layers: int = 2
    d_model: int = 64
    vocab_size: int = 200
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 16
    d_ff: int = 96
    mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    sliding_window: int = 0
    tie_embeddings: bool = False
    ffn: tuple = ("dense", "dense")

    def pattern(self):
        return tuple(("attn", f) for f in self.ffn)


def test_causal_pairs():
    assert ys.causal_pairs(1) == 1
    assert ys.causal_pairs(4) == 10          # 1 + 2 + 3 + 4
    assert ys.causal_pairs(2048) == 2048 * 2049 // 2


def test_flash_least_time_gqa_by_hand():
    cfg = Cfg()
    B, S = 3, 8
    P = 36                                    # 8 * 9 / 2
    flops = 2 * B * 4 * P * (16 + 16)
    nbytes = 2 * B * S * (4 * 16 + 2 * 16 + 2 * 16 + 4 * 16)
    want = max(flops / 989e12, nbytes / 3.35e12)
    assert ys.flash_least_time(cfg, B, S) == pytest.approx(want, rel=1e-12)


def test_flash_least_time_mla_by_hand():
    cfg = Cfg(mla=True, qk_nope_head_dim=128, qk_rope_head_dim=64,
              v_head_dim=128, n_heads=16)
    B, S = 8, 2048
    flops = 2 * B * 16 * (2048 * 2049 // 2) * (192 + 128)
    nbytes = 2 * B * S * 16 * (192 + 192 + 128 + 128)
    assert ys.flash_least_time(cfg, B, S) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12), rel=1e-12)
    # deepseek's layer at 8 x 2048 is bound by its operations
    assert flops / 989e12 > nbytes / 3.35e12


def test_moe_gmm_counts_routed_entries_not_capacity():
    cfg = Cfg(n_experts=64, top_k=6, moe_d_ff=1408, d_model=2048)
    T = 16384
    R = T * 6                                  # not E * C = 64 * 1920
    flops = 6 * R * 2048 * 1408
    nbytes = 2 * 2 * R * 2048 + 4 * 3 * 64 * 2048 * 1408
    assert ys.moe_gmm_least_time(cfg, T) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12), rel=1e-12)
    # bf16 weights halve the weight bytes only
    nb16 = 2 * 2 * R * 2048 + 2 * 3 * 64 * 2048 * 1408
    assert ys.moe_gmm_least_time(cfg, 8, weight_bytes=2) == pytest.approx(
        max(6 * 48 * 2048 * 1408 / 989e12,
            (2 * 2 * 48 * 2048 + 2 * 3 * 64 * 2048 * 1408) / 3.35e12))
    assert nb16 < nbytes


def test_kernel_groups():
    g = ys.kernel_group
    assert g("void (anonymous namespace)::flash_fwd_wgmma_kernel<...>") \
        == "flash"
    assert g("void (anonymous namespace)::gmm_wgmma_kernel<true>") \
        == "moe_gmm"
    assert g("quantize_segments_kernel(Table)") == "int8"
    assert g("dequantize_segments_kernel(Table)") == "int8"
    assert g("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT") == "gemm"
    assert g("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert g("void at::native::elementwise_kernel<128, 4>") == "glue"
    assert g("void at::native::indexing_backward_kernel<c10::BFloat16>") \
        == "glue"


def _port_cfg(name):
    from repro_torch.configs import get_config, make_reduced
    return make_reduced(get_config(name), n_layers=3, d_model=256)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "deepseek-v2-lite-16b"])
def test_flop_copy_equals_the_ports(name):
    from repro_torch.utils import flops
    cfg = _port_cfg(name)
    for S in (16, 64):
        assert ys.transformer_unit_flops(cfg, S) == \
            flops.transformer_unit_flops(cfg, S)
        assert ys.head_flops(cfg, S) == flops.head_flops(cfg, S)
    assert ys.vocab_padded(cfg) == cfg.vocab_padded
    assert ys.qk_dim(cfg) == cfg.qk_head_dim


@pytest.mark.parametrize("name", ["internlm2-1.8b", "deepseek-v2-lite-16b"])
def test_mfu_numerator_against_the_ports_6nd(name):
    """The train numerator is the port's 6·N·D without the embedding
    table, plus the attention core; the body count matches the port's
    parameter count with the routed experts at top_k / E."""
    from repro_torch.models import SplitModel
    from repro_torch.utils import flops
    cfg = _port_cfg(name)
    m = SplitModel(cfg)
    counts = flops.segment_param_counts(m)
    embed = counts["embed"]
    n_seqs, S = 4, 16
    tokens = n_seqs * S
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    norms += cfg.n_layers * cfg.kv_lora_rank if cfg.mla else 0
    want = flops.model_flops_6nd(cfg, tokens) - 6.0 * (embed + norms) \
        * tokens + 3 * ys.attention_core_flops(cfg, n_seqs, S)
    assert ys.train_flops(cfg, n_seqs, S) == pytest.approx(want, rel=1e-12)
    pre = ys.prefill_flops(cfg, n_seqs, S)
    assert pre == pytest.approx(
        2 * ys.body_params(cfg) * tokens
        + ys.attention_core_flops(cfg, n_seqs, S)
        + 2 * n_seqs * cfg.d_model * cfg.vocab_padded, rel=1e-12)


def test_pct_refuses_non_finite():
    assert ys.pct(0.5) == 50.0
    with pytest.raises(ValueError):
        ys.pct(float("nan"))
