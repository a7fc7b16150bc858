"""moe_gmm's share of its roofline over the window, %: the least time of
each MoE layer's expert FFN over the routed entries R = T·top_k (6·R·d·F
at the bf16 peak, or the routed rows, the outputs and the f32 expert
weights once at the HBM peak) summed over the window's calls, over the
moe_gmm kernels' device time."""
from portbench import yardstick
from portbench.metrics_common import kernel_share


def read(run):
    ctx = run.context
    cfg = ctx.get("cfg")
    if ctx.get("kind") != "prefill" or not cfg.n_experts:
        return None
    wbytes = 4 if cfg.param_dtype == "float32" else 2
    least = yardstick.n_moe_layers(cfg) * yardstick.moe_gmm_least_time(
        cfg, ctx["batch"] * ctx["prompt_len"], weight_bytes=wbytes)
    return kernel_share(run, "moe_gmm", least)
