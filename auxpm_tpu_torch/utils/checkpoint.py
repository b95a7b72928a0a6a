"""Checkpoint / resume for sampler state.

Counterpart of ``auxpm_tpu/utils/checkpoint.py``.  MCMC state is small
(theta, u, the carried factor and one PRNG key per chain), so checkpointing
every few windows is cheap, and because every chain's key is part of the
checkpoint, a restarted run continues BIT FOR BIT as the uninterrupted one.

Format: one ``.npz`` per rank, ``shard_<rank>.npz`` in one checkpoint
directory shared by the ranks, holding that rank's share of every tensor
(keys included), the step index, the params (their tensors as entries, their
numbers in the JSON metadata), the layout that wrote it with the rank's first
global chain and row, and a hash of the run's config that is checked on load
(``_config_hash``: sha256 of the sorted JSON, 16 hex characters, as in the
reference).  A chain's draws depend on its own key alone, so a checkpoint
loads onto ANY layout: a rank reads, from the shards that overlap it, its
chains (in global chain order) and its rows of u.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from auxpm_tpu_torch.core.state import ChainState

def _config_hash(config: dict) -> str:
    return hashlib.sha256(
        json.dumps(config, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def _layout(mesh):
    if mesh is None:
        return {"rank": 0, "n_chain_shards": 1, "n_particle_shards": 1,
                "chain_index": 0, "particle_index": 0}
    return {"rank": mesh.rank, "n_chain_shards": mesh.n_chain_shards,
            "n_particle_shards": mesh.n_particle_shards,
            "chain_index": mesh.chain_index,
            "particle_index": mesh.particle_index}


def _flatten(tree, prefix, out):
    """``{"a": {"b": t}}`` -> ``out[prefix + "a/b"] = t``; an empty dict is
    a leaf of its own."""
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat, prefix):
    tree = {}
    for name, v in flat.items():
        if not name.startswith(prefix):
            continue
        *path, leaf = name[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_checkpoint(path, states: ChainState, step: int, config: dict | None = None,
                    params: dict | None = None, mesh=None):
    """Save this rank's share of ``states``.  ``path`` is a directory (one
    for all ranks); ``mesh``: this rank's ``parallel.mesh.Mesh`` on a
    sharded run."""
    os.makedirs(path, exist_ok=True)
    layout = _layout(mesh)
    b_local, rows = states.u.shape[0], states.u.shape[1]
    flat_params = _flatten(params or {}, "params/", {})
    arrs = {
        "theta": states.theta, "u": states.u,
        "log_lik_hat": states.log_lik_hat, "key": states.key,
        **_flatten(states.extras, "extras/", {}),
        **{k: v for k, v in flat_params.items() if torch.is_tensor(v)},
    }
    arrs = {k: v.detach().cpu().numpy() for k, v in arrs.items()}
    meta = {
        "step": int(step),
        "config_hash": _config_hash(config or {}),
        "layout": layout,
        # global chain order: this share holds chains [chain0, chain0 +
        # b_local) and rows [row0, row0 + rows) of each u
        "n_chains": b_local * layout["n_chain_shards"],
        "n_rows": rows * layout["n_particle_shards"],
        "chain0": layout["chain_index"] * b_local,
        "row0": layout["particle_index"] * rows,
        # the params' numbers; their tensors are entries of the npz
        "params": {k: v for k, v in flat_params.items()
                   if not torch.is_tensor(v)},
    }
    np.savez(os.path.join(path, f"shard_{layout['rank']}.npz"),
             __meta__=json.dumps(meta), **arrs)


def _shard_file(path, rank):
    return os.path.join(path, f"shard_{rank}.npz")


def load_checkpoint(path, example_states: ChainState, config: dict | None = None,
                    mesh=None):
    """Load this rank's share, whatever layout wrote the checkpoint; returns
    ``(states, step, params)``.

    ``example_states``: a state of the run being resumed (as
    ``init_chain_states`` builds it) that gives the device and this rank's
    shapes; its own values are left as they are.  Raises on a config-hash
    mismatch and on a checkpoint of another shape (chains, rows, theta)."""
    layout = _layout(mesh)
    with np.load(_shard_file(path, 0), allow_pickle=False) as z:
        meta0 = json.loads(str(z["__meta__"]))
    if config is not None and meta0["config_hash"] != _config_hash(config):
        raise ValueError("checkpoint config hash mismatch")
    b_local, rows = example_states.u.shape[0], example_states.u.shape[1]
    n_chains = b_local * layout["n_chain_shards"]
    n_rows = rows * layout["n_particle_shards"]
    if (meta0["n_chains"], meta0["n_rows"]) != (n_chains, n_rows):
        raise ValueError(
            f"checkpoint of another shape: {meta0['n_chains']} chains x "
            f"{meta0['n_rows']} rows, the run {n_chains} x {n_rows}")
    w = meta0["layout"]
    bw = n_chains // w["n_chain_shards"]
    rw = n_rows // w["n_particle_shards"]
    c0, r0 = layout["chain_index"] * b_local, layout["particle_index"] * rows
    leaves, u_parts, params_arrs = {}, [], {}
    for cw in range(w["n_chain_shards"]):
        lo, hi = max(cw * bw, c0), min((cw + 1) * bw, c0 + b_local)
        if lo >= hi:
            continue
        row_parts = []
        for pw in range(w["n_particle_shards"]):
            rlo, rhi = max(pw * rw, r0), min((pw + 1) * rw, r0 + rows)
            if rlo >= rhi and pw:
                continue
            with np.load(_shard_file(path, cw * w["n_particle_shards"] + pw),
                         allow_pickle=False) as z:
                meta = json.loads(str(z["__meta__"]))
                if (meta["step"], meta["layout"]["n_chain_shards"],
                        meta["config_hash"]) != (
                        meta0["step"], w["n_chain_shards"],
                        meta0["config_hash"]):
                    raise ValueError(
                        f"shard_{cw * w['n_particle_shards'] + pw}.npz is of "
                        "another checkpoint than shard_0.npz")
                cut = slice(lo - cw * bw, hi - cw * bw)
                if pw == 0:   # the leaves replicated over a particle group
                    for k in z.files:
                        if k in ("__meta__", "u"):
                            continue
                        if k.startswith("params/"):
                            params_arrs[k] = z[k]
                        else:
                            leaves.setdefault(k, []).append(z[k][cut])
                if rlo < rhi:
                    row_parts.append(
                        z["u"][cut, rlo - pw * rw:rhi - pw * rw])
        u_parts.append(np.concatenate(row_parts, axis=1))
    arrs = {k: np.concatenate(v) for k, v in leaves.items()}
    arrs["u"] = np.concatenate(u_parts)
    dev = example_states.theta.device
    for name in ("theta", "u", "log_lik_hat", "key"):
        want = tuple(getattr(example_states, name).shape)
        if arrs[name].shape != want:
            raise ValueError(f"checkpoint {name} has shape "
                             f"{arrs[name].shape}, the state {want}")

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    extras = _unflatten({k: tensor(v) for k, v in arrs.items()
                         if k.startswith("extras/")}, "extras/")
    states = ChainState(
        theta=tensor(arrs["theta"]), u=tensor(arrs["u"]),
        log_lik_hat=tensor(arrs["log_lik_hat"]), key=tensor(arrs["key"]),
        extras=extras,
    )
    params = _unflatten({**meta0["params"],
                         **{k: tensor(v) for k, v in params_arrs.items()}},
                        "params/")
    return states, meta0["step"], params
