"""The port's package-level surface: every name that the reference's
``repro.tiering`` and ``repro.core`` re-export resolves on
``repro_torch.tiering`` / ``repro_torch.core``.

The reference's import lists are read as text, so that this file imports no
JAX.  ``repro.core.daemon`` (a deprecation shim) has no counterpart in the
port: its two names are served from ``repro_torch.tiering``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "src" / "repro"
SHIM = "repro.core.daemon"


def reference_exports(package: str) -> dict[str, str]:
    """{name: module} of the package's ``from repro.x import (...)`` lists,
    plus the names of its ``_TIERING_EXPORTS`` tuple (module "repro.tiering")."""
    tree = ast.parse((REFERENCE / package / "__init__.py").read_text())
    names = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module.startswith("repro."):
            names.update((a.asname or a.name, node.module) for a in node.names)
        elif (isinstance(node, ast.Assign)
              and [t.id for t in node.targets] == ["_TIERING_EXPORTS"]):
            names.update((e.value, "repro.tiering") for e in node.value.elts)
    return names


CASES = [(pkg, name, module) for pkg in ("tiering", "core")
         for name, module in sorted(reference_exports(pkg).items())]


def test_reference_lists_parsed():
    tiering, core = reference_exports("tiering"), reference_exports("core")
    assert len(tiering) >= 30 and len(core) >= 35
    assert {"NeoMemDaemon", "KVPagesResource", "hit_rate"} <= set(tiering)
    assert core["NeoMemDaemon"] == SHIM and core["TieredMemory"] == "repro.tiering"


@pytest.mark.parametrize("package,name,module", CASES,
                         ids=[f"{p}.{n}" for p, n, _ in CASES])
def test_reference_export_resolves_on_port(package, name, module):
    import importlib
    port = importlib.import_module(f"repro_torch.{package}")
    value = getattr(port, name)
    if module == SHIM:
        import repro_torch.tiering
        assert value is getattr(repro_torch.tiering, name)
    else:
        port_module = importlib.import_module(module.replace("repro", "repro_torch", 1))
        assert value is getattr(port_module, name)


_PROBE = """
import sys
import repro_torch.core, repro_torch.tiering
repro_torch.core.NeoMemDaemon, repro_torch.core.TieredResource
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("first", ["repro_torch.core", "repro_torch.tiering"])
def test_packages_import_without_jax_in_either_order(first):
    probe = f"import {first}\n" + _PROBE
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", probe], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
