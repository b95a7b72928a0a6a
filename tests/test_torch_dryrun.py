"""The counterparts of ``__graft_entry__.py``'s mesh dry run and of
``scaling_bench.py``, on spawned gloo ranks on the CPU.

- ``utils/dryrun.dryrun_mesh(4)``: one ``aux_slice`` step on a 2 x 2 mesh
  (chains x particles), then the key-as-u sharded SMC on the toy over a
  chain-only mesh of the four ranks; what the reference asserts holds on
  every rank, and the ranks agree on the SMC's betas and logZ;
- ``utils/scaling`` on 2 ranks: the reference's JSON keys plus
  ``ranks_per_card``, which is null on the CPU; also as the ``rank_jobs``
  job ``scaling``;
- neither runs without a world: no world of one stands in for it.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from auxpm_tpu_torch.parallel.launch import spawn
from auxpm_tpu_torch.utils import dryrun, scaling

REPO = Path(__file__).resolve().parents[1]
SCALING_ARGV = ["--device", "cpu", "--chains-per-device", "4", "--steps",
                "2", "--warm", "1", "--subsample", "32", "--n-importance",
                "8"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_mesh_on_four_ranks():
    ranks = spawn(dryrun.dryrun_mesh, 4, 4, "cpu", timeout_s=300)
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["mesh"] == [2, 2] and r["backend"] == "gloo"
        assert r["step_theta_shape"] == [4, 1, 2]     # 2 x 2 chains, 1 step
        smc = r["smc"]
        assert smc["particles"] == 256 and smc["betas"][-1] == 1.0
        assert np.isfinite(smc["log_z"])
        assert smc["u_dtype"] == "torch.int64"
        assert smc["u_shape_per_rank"] == [64, 2]
        assert smc["betas"] == ranks[0]["smc"]["betas"]
        assert smc["log_z"] == ranks[0]["smc"]["log_z"]


def _reference_scaling_keys():
    """The keys of the JSON line ``scaling_bench.py`` prints."""
    tree = ast.parse((REPO / "scaling_bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "out" and \
                isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
    raise AssertionError("no out dict in scaling_bench.py")


def test_scaling_on_two_ranks(capsys):
    result = {}
    assert scaling.main(SCALING_ARGV, result=result) == 0
    out = result["out"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    assert set(out) == _reference_scaling_keys() | {"ranks_per_card"}
    assert out["metric"] == "chain_scaling_efficiency"
    assert out["n_devices"] == 2 and out["platform"] == "cpu"
    assert out["ranks_per_card"] is None
    assert out["tput_1dev"] > 0 and out["tput_ndev"] > 0
    # value is rounded to 1e-3 from the unrounded throughputs, which the
    # line holds rounded to 0.1 chain-steps/s
    ratio = out["tput_ndev"] / (2 * out["tput_1dev"])
    slack = 5e-4 + ratio * (0.05 / out["tput_ndev"] + 0.05 / out["tput_1dev"])
    assert abs(out["value"] - ratio) <= slack * (1 + 1e-9)


def test_scaling_as_a_rank_job():
    """``rank_jobs`` job ``scaling`` (how ``chip_smoke.py`` runs it, in the
    spawn of its two-rank phase): rank 0 gets the line, rank 1 None."""
    from auxpm_tpu_torch.parallel import rank_jobs

    (r0,), (r1,) = spawn(rank_jobs.run_all, 2,
                         [("scaling", SCALING_ARGV)], 1, "cpu",
                         timeout_s=300)
    assert r1 is None
    assert r0["n_devices"] == 2 and r0["tput_ndev"] > 0


def test_no_world_no_run(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        dryrun.main(["--device", "cpu"])
    with pytest.raises(RuntimeError, match="torchrun"):
        scaling.main(["--device", "cpu", "--multihost"])
