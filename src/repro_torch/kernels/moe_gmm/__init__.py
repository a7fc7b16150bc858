from repro_torch.kernels.moe_gmm.ops import expert_ffn, moe_gmm  # noqa: F401
