"""Share of the roofline reached by the member-stacked convs
(``conv1d_stripe_stacked``) of the flushes the profiled slice holds
whole: the least time of their convs from shapes (bytes over 3.35 TB/s
or flops over the TF32 rate, the larger, a conv) over the device time
of the kernels named here."""
from bench.counts.convs import flush_conv_bound_s

KERNELS = ("conv1d_stripe_direct_kernel", "conv1d_stripe_depthwise_kernel",
           "conv1d_stripe_tiled_kernel")


def _is_conv(name):
    return any(k in name for k in KERNELS)


def read(obs):
    t = obs.get("trace")
    if not t or not t["flushes"]:
        return None
    spent = sum(s for f in t["flushes"] for n, s in f["kernel_s"].items()
                if _is_conv(n))
    if spent <= 0:
        return None
    bound = sum(flush_conv_bound_s(obs["members"], f["ppad"])
                for f in t["flushes"])
    return 100.0 * bound / spent
