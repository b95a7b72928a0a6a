"""The port never imports JAX nor the JAX package (CPU).

Every module of ``auxpm_tpu_torch/`` (found by walking the package's files,
the tools under ``utils/`` included) is imported in a fresh process of its
own: one interpreter imports ``torch`` and ``numpy`` (which the port may
use), then forks one child per module; the child imports the module and
reports which of ``jax`` and ``auxpm_tpu`` are then in ``sys.modules``.  The
same test reads the module's source and fails on any ``import`` statement,
at any depth (imports inside functions included), that names either.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "auxpm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "auxpm_tpu")


def _module_name(path):
    parts = path.relative_to(ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = sorted((_module_name(p), p) for p in PKG.rglob("*.py"))

_CHILDREN = r"""
import importlib, json, os, sys
import numpy, torch
FORBIDDEN = {forbidden!r}
out = {{}}
for name in {names!r}:
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            importlib.import_module(name)
            got = sorted({{m.split(".")[0] for m in sys.modules}}
                         & set(FORBIDDEN))
            msg = json.dumps({{"leaked": got}})
        except BaseException as e:
            msg = json.dumps({{"error": f"{{type(e).__name__}}: {{e}}"}})
        os.write(w, msg.encode())
        os._exit(0)
    os.close(w)
    data = b""
    while chunk := os.read(r, 65536):
        data += chunk
    os.close(r)
    os.waitpid(pid, 0)
    out[name] = json.loads(data or b'{{"error": "no report"}}')
print(json.dumps(out))
"""


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


@pytest.fixture(scope="module")
def imported():
    code = _CHILDREN.format(forbidden=FORBIDDEN,
                            names=[m for m, _ in MODULES])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_walk_finds_the_tools_and_the_kernels_wrappers():
    names = {m for m, _ in MODULES}
    for m in ("auxpm_tpu_torch", "auxpm_tpu_torch.run",
              "auxpm_tpu_torch.ops.fused_estimator",
              "auxpm_tpu_torch.utils.tau_sweep",
              "auxpm_tpu_torch.utils.theta_bench",
              "auxpm_tpu_torch.utils.ess_sweep_bench"):
        assert m in names, m


@pytest.mark.parametrize("name,path", MODULES, ids=[m for m, _ in MODULES])
def test_module_imports_no_jax(imported, name, path):
    report = imported[name]
    assert "error" not in report, report
    assert report["leaked"] == [], f"importing {name} loads {report['leaked']}"
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            bad = [node.module] if node.level == 0 and node.module and \
                _forbidden(node.module) else []
        else:
            continue
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"
