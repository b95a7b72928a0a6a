"""Share of the ESS sweep kernel's roofline: the probes the chains made
(n_ess x (1 + ``ess_u/n_shrink``) a chain and step), S n (n + 1) FLOPs
each, against the bytes a chain's sweep must move, over the device time of
``ess_sweep_kernel``."""

from portbench.tracing import seconds_matching
from portbench.yardstick import bound_s, ess_sweep_bytes, probe_flops


def read(ctx):
    dev_s = seconds_matching(ctx["trace"], "ess_sweep_kernel")
    if dev_s <= 0:
        return None
    n_ess, calls = ctx["n_ess"], ctx["chains"] * ctx["k"]
    probes = n_ess * calls + n_ess * ctx["work"]["ess_u/n_shrink"]
    least = bound_s(probes * probe_flops(ctx["s"], ctx["n"]),
                    calls * ess_sweep_bytes(ctx["s"], ctx["n"], n_ess))
    return 100.0 * least / dev_s
