"""The whole step's share of the float32 peak: the FLOPs of the chains' own
probes (ESS probes and theta probes, S n (n + 1) each) and factorisations
(the ell probes' and one refresh, n^3/3 each), over the untraced wall time
of the same steps."""

from portbench.yardstick import PEAK_F32_FLOPS, factor_flops, probe_flops


def read(ctx):
    w, calls = ctx["work"], ctx["chains"] * ctx["k"]
    probes = (ctx["n_ess"] * (calls + w["ess_u/n_shrink"])
              + w["slice_theta/n_probe"])
    flops = (probes * probe_flops(ctx["s"], ctx["n"])
             + (w["slice_theta/n_probe_chol"] + calls) * factor_flops(ctx["n"]))
    return 100.0 * flops / (ctx["wall_s"] * PEAK_F32_FLOPS)
