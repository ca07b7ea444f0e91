"""Import hygiene of the port: ``tpuic_torch`` and ``chip_smoke.py`` import
neither JAX (``jax``, ``flax``, ``optax``) nor anything of ``tpuic``.

Checked two ways: every ``tpuic_torch`` module imported in a fresh
subprocess leaves none of those in ``sys.modules``, and an AST scan of
every port file finds no import statement naming them.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "tpuic_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpuic")

# The parents that must outlive a CUDA wedge of their children: the
# supervisors, the SLO arithmetic they and the rollout controller share, and
# the front tier (router, rollout, HTTP front end, load generator); and the
# bulk scorer's lease and commit layers and the membership file they read,
# which a launcher imports beside its workers, as ``tpuic``'s do.
STDLIB_ONLY = ("tpuic_torch.supervise", "tpuic_torch.runtime.gang",
               "tpuic_torch.telemetry.slo", "tpuic_torch.serve.router",
               "tpuic_torch.serve.rollout", "tpuic_torch.serve.http",
               "tpuic_torch.serve.loadgen", "tpuic_torch.runtime.membership",
               "tpuic_torch.score", "tpuic_torch.score.work",
               "tpuic_torch.score.commit")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _run(code: str) -> dict:
    env = subprocess_env(PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_importing_every_port_module_loads_no_jax_and_no_tpuic():
    got = _run(
        "import importlib, json, pkgutil, sys\n"
        "import tpuic_torch\n"
        "names = ['tpuic_torch'] + [m.name for m in pkgutil.walk_packages("
        "tpuic_torch.__path__, 'tpuic_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps({'names': names, 'bad': bad}))\n")
    assert got["bad"] == []
    assert "tpuic_torch.serve.engine" in got["names"]
    assert "tpuic_torch.kernels.conv_bn_relu" in got["names"]
    for name in ("tpuic_torch.native", "tpuic_torch.data.pack",
                 "tpuic_torch.data.device_prep", "tpuic_torch.models.moe",
                 "tpuic_torch.metrics.tensorboard",
                 "tpuic_torch.runtime.gang", "tpuic_torch.runtime.supervisor",
                 "tpuic_torch.runtime.preemption", "tpuic_torch.supervise",
                 "tpuic_torch.checkpoint.torch_ref",
                 "tpuic_torch.score.driver", "tpuic_torch.score.__main__",
                 *STDLIB_ONLY[3:]):
        assert name in got["names"]
    assert {f"tpuic_torch.telemetry.{m}" for m in (
        "events", "goodput", "memory", "profile", "prom", "slo",
        "steptime", "tracing", "wiring")} <= set(got["names"])


def test_package_import_is_light():
    """``import tpuic_torch`` (and the lazy serve and telemetry packages,
    and the telemetry's event bus) load no torch."""
    got = _run("import json, sys, tpuic_torch, tpuic_torch.serve\n"
               "import tpuic_torch.telemetry, tpuic_torch.telemetry.events\n"
               "print(json.dumps({'torch': 'torch' in sys.modules}))\n")
    assert got == {"torch": False}


def _stdlib_only(names) -> list:
    return _run("import importlib, json, sys\n"
                f"for n in {list(names)!r}: importlib.import_module(n)\n"
                "print(json.dumps(sorted(m for m in ('torch', 'numpy', "
                "'jax') if m in sys.modules)))\n")


def test_the_supervisors_import_only_the_stdlib():
    """``python -m tpuic_torch.supervise`` (one child or a gang), the SLO
    arithmetic, the router and the rollout controller never initialise CUDA:
    the parent imports neither torch nor numpy (nor jax)."""
    assert _stdlib_only(STDLIB_ONLY) == []


@pytest.mark.parametrize("name", STDLIB_ONLY)
def test_each_stdlib_only_module_alone(name):
    """Each of them alone, so a module that only loads torch after
    another's import cannot hide behind it."""
    assert _stdlib_only([name]) == []


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax_or_tpuic(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__", "importorskip")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _forbidden(node.args[0].value)):
            bad.append(node.args[0].value)
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"
