"""Checkpoint / resume for sampler state.

Counterpart of ``auxpm_tpu/utils/checkpoint.py``.  MCMC state is small
(theta, u, the carried factor and the generators per chain shard), so
checkpointing every few windows is cheap, and because every generator's
state is part of the checkpoint, a restarted run continues BIT FOR BIT as
the uninterrupted one: the replicated generator and the one per row block
(``core/state.make_generators``) are saved with ``get_state`` and restored
with ``set_state`` (a CUDA generator's state is its seed and Philox offset).

Format: one ``.npz`` per rank, ``shard_<rank>.npz`` in the checkpoint
directory, holding that rank's share of every tensor, the generators' states,
the step index, the params (their tensors as entries, their numbers in the
JSON metadata) and a hash of the run's config that is checked on
load (``_config_hash``: sha256 of the sorted JSON, 16 hex characters, as in
the reference).  A rank's share is a fixed function of the mesh layout (the
generators are seeded per chain shard, ROADMAP.md known difference 1), so a
checkpoint loads only onto the layout that wrote it.
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
        return {"rank": 0, "n_chain_shards": 1, "n_particle_shards": 1}
    return {"rank": mesh.rank, "n_chain_shards": mesh.n_chain_shards,
            "n_particle_shards": mesh.n_particle_shards}


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


def _generator_state(g):
    return g.get_state().cpu().numpy()


def save_checkpoint(path, states: ChainState, step: int, config: dict | None = None,
                    params: dict | None = None, mesh=None):
    """Save this rank's share of ``states``.  ``path`` is a directory;
    ``mesh``: this rank's ``parallel.mesh.Mesh`` on a sharded run."""
    os.makedirs(path, exist_ok=True)
    layout = _layout(mesh)
    flat_params = _flatten(params or {}, "params/", {})
    arrs = {
        "theta": states.theta, "u": states.u,
        "log_lik_hat": states.log_lik_hat,
        **_flatten(states.extras, "extras/", {}),
        **{k: v for k, v in flat_params.items() if torch.is_tensor(v)},
    }
    arrs = {k: v.detach().cpu().numpy() for k, v in arrs.items()}
    arrs["generator"] = _generator_state(states.generator)
    for i, g in enumerate(states.block_generators):
        arrs[f"block_generator/{i}"] = _generator_state(g)
    meta = {
        "step": int(step),
        "config_hash": _config_hash(config or {}),
        "layout": layout,
        "n_block_generators": len(states.block_generators),
        # the params' numbers; their tensors are entries of the npz
        "params": {k: v for k, v in flat_params.items()
                   if not torch.is_tensor(v)},
    }
    np.savez(os.path.join(path, f"shard_{layout['rank']}.npz"),
             __meta__=json.dumps(meta), **arrs)


def load_checkpoint(path, example_states: ChainState, config: dict | None = None,
                    mesh=None):
    """Load this rank's share; returns ``(states, step, params)``.

    ``example_states``: a state of the run being resumed (as
    ``init_chain_states`` builds it) that gives the device, the shapes and
    the number of block generators; its own values and generators are left
    as they are.  Raises on a config-hash mismatch, and on a checkpoint
    written by another mesh layout or for another shape."""
    layout = _layout(mesh)
    file = os.path.join(path, f"shard_{layout['rank']}.npz")
    with np.load(file, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if config is not None and meta["config_hash"] != _config_hash(config):
            raise ValueError("checkpoint config hash mismatch")
        if meta["layout"] != layout:
            raise ValueError(
                f"checkpoint written on the mesh layout {meta['layout']}, "
                f"loaded on {layout}: the generators are seeded per chain "
                "shard, so another layout would be another draw; resuming "
                "across layouts needs the counter-based PRNG of ROADMAP.md "
                "queue 1, item 8")
        if meta["n_block_generators"] != len(example_states.block_generators):
            raise ValueError(
                f"checkpoint holds {meta['n_block_generators']} block "
                f"generators, the state has "
                f"{len(example_states.block_generators)}")
        arrs = {k: z[k] for k in z.files if k != "__meta__"}
    dev = example_states.theta.device
    for name in ("theta", "u", "log_lik_hat"):
        want = tuple(getattr(example_states, name).shape)
        if arrs[name].shape != want:
            raise ValueError(f"checkpoint {name} has shape "
                             f"{arrs[name].shape}, the state {want}")

    def tensor(a):
        return torch.from_numpy(a).to(dev)

    def generator(a, like):
        g = torch.Generator(device=like.device)
        g.set_state(torch.from_numpy(a))
        return g

    extras = _unflatten({k: tensor(v) for k, v in arrs.items()
                         if k.startswith("extras/")}, "extras/")
    states = ChainState(
        theta=tensor(arrs["theta"]), u=tensor(arrs["u"]),
        log_lik_hat=tensor(arrs["log_lik_hat"]),
        generator=generator(arrs["generator"], example_states.generator),
        extras=extras,
        block_generators=tuple(
            generator(arrs[f"block_generator/{i}"], g)
            for i, g in enumerate(example_states.block_generators)),
    )
    params = _unflatten({**meta["params"],
                         **{k: tensor(v) for k, v in arrs.items()
                            if k.startswith("params/")}}, "params/")
    return states, meta["step"], params
