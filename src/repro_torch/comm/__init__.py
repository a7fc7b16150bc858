"""repro_torch.comm — pluggable transport for the cut-layer exchange:
codecs, link models and the metered CommChannel."""
from repro_torch.comm.channel import (  # noqa: F401
    AUX_BYTES, MESSAGES_PER_ROUND, CommChannel)
from repro_torch.comm.codecs import (  # noqa: F401
    Codec, get_codec, list_codecs)
from repro_torch.comm.links import (  # noqa: F401
    FluidLink, LatencySampler, LinkTrace, StaticLink, fluid_schedule,
    get_link, shared_link_finish_times)


def make_channel(ccfg=None) -> CommChannel:
    """Build a CommChannel from a configs.base.CommConfig (None -> the
    fp32/static default, which reproduces the seed's exact semantics)."""
    if ccfg is None:
        return CommChannel()
    if ccfg.link == "trace":
        if ccfg.trace_file:
            link = LinkTrace.from_file(
                ccfg.trace_file,
                per_device_phase=ccfg.trace_phase_per_device)
        else:
            link = LinkTrace(ccfg.trace_times, ccfg.trace_multipliers,
                             period=ccfg.trace_period,
                             per_device_phase=ccfg.trace_phase_per_device)
    else:
        link = get_link(ccfg.link)
    # the *_codec fields are the preferred names; codec/grad_codec are
    # the original storage fields they override when set
    codec = getattr(ccfg, "uplink_codec", "") or ccfg.codec
    grad = getattr(ccfg, "downlink_codec", "") or ccfg.grad_codec
    return CommChannel(codec=codec, grad_codec=grad, link=link,
                       dispatch_codec=getattr(ccfg, "dispatch_codec",
                                              "fp32"),
                       error_feedback=getattr(ccfg, "error_feedback",
                                              False),
                       topk_frac=getattr(ccfg, "topk_frac", None),
                       latency=getattr(ccfg, "latency", 0.0),
                       uplink_capacity=getattr(ccfg, "uplink_capacity",
                                               0.0),
                       downlink_capacity=getattr(ccfg,
                                                 "downlink_capacity", 0.0),
                       latency_dist=getattr(ccfg, "latency_dist",
                                            "constant"),
                       latency_jitter=getattr(ccfg, "latency_jitter",
                                              0.5),
                       latency_seed=getattr(ccfg, "latency_seed", 0))
