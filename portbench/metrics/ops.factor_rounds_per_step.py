"""Blocked factorisations per step: the program's panel-kernel launches
(``auxpm_tpu_torch.ops.chol_hopper.launches``) over the panels of one
factorisation (the padded width over 128)."""


def read(ctx):
    if not ctx["chol_launches"]:
        return None
    return ctx["chol_launches"] / (ctx["n_pad"] // 128) / ctx["k"]
