"""Share of the factorisations' roofline: the factorisations the chains
needed (each ell probe's, counted in ``slice_theta/n_probe_chol``, and the
refresh of the carried factor, one a chain and step), each at the larger of
n^3/3 FLOPs and its bytes over the peaks, over the device time of the panel
kernel and of the driver's GEMMs."""

from portbench.tracing import seconds_matching
from portbench.yardstick import factor_bound_s


def read(ctx):
    tr = ctx["trace"]
    dev_s = seconds_matching(tr, "chol_panel_kernel") + sum(
        v for k, v in tr["device_s_by_name"].items() if "gemm" in k.lower())
    if dev_s <= 0:
        return None
    needed = ctx["work"]["slice_theta/n_probe_chol"] + ctx["chains"] * ctx["k"]
    return 100.0 * needed * factor_bound_s(ctx["n"]) / dev_s
