"""Flash attention's share of its roofline over the window, %: the least
time of each layer's causal attention call (2·B·H·P·(d_qk + d_v) at the
bf16 peak, or q, k, v and o once at the HBM peak) summed over the
window's calls, over the flash kernels' device time."""
from portbench import yardstick
from portbench.metrics_common import kernel_share


def read(run):
    ctx = run.context
    if ctx.get("kind") != "prefill":
        return None
    cfg = ctx["cfg"]
    least = cfg.n_layers * yardstick.flash_least_time(
        cfg, ctx["batch"], ctx["prompt_len"])
    return kernel_share(run, "flash", least)
