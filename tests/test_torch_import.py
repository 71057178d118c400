"""The PyTorch port stands alone: importing it loads neither JAX nor the
reference package, and no source of it imports either."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TWINS = sorted((ROOT / "examples").glob("*_torch.py"))
PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + TWINS
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_import_all_submodules_loads_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 30, proc.stdout


def test_source_scan_covers_every_package():
    """The scan below reads every package of the port, the checkpoint
    manager's, the training path's (data, dist, optim, train) and the
    meshes' (launch) included."""
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").parts[0]
               for p in PORT_SOURCES if p.is_relative_to(ROOT / "src")}
    packages = {p.name for p in (ROOT / "src" / "repro_torch").iterdir()
                if (p / "__init__.py").exists()}
    assert {"ckpt", "data", "dist", "launch", "optim", "train"} <= packages
    assert packages <= scanned, packages - scanned


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_SOURCES])
def test_source_imports_no_jax_or_reference(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path}: {hits}"


_TRAIN_PROBE = """
import sys
import repro_torch.data.pipeline, repro_torch.dist.compression
import repro_torch.optim.optimizers, repro_torch.optim.zero1, repro_torch.train.step
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_training_path_imports_no_jax_or_reference():
    """The training packages alone (without the rest of the port) load
    neither JAX nor the reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _TRAIN_PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_DIST_PROBE = """
import sys
import torch
import repro_torch.dist, repro_torch.launch.mesh
from repro_torch.dist import collectives, compression, host_offload, pipeline, sharding
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad, torch.distributed.is_initialized(), torch.cuda.is_initialized())
sys.exit(1 if bad or torch.distributed.is_initialized() or torch.cuda.is_initialized() else 0)
"""


def test_distribution_layer_imports_touch_no_process_group_or_device():
    """``repro_torch.dist`` and ``repro_torch.launch`` load neither JAX nor
    the reference, and importing them initialises no process group and no
    CUDA context."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _DIST_PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_SHIM_PROBE = """
import importlib.util, sys
import repro_torch.core.adapters.base, repro_torch.core.adapters.kv_tier
import repro_torch.core.adapters.expert_cache, repro_torch.core.adapters.embed_cache
import repro_torch.core.daemon
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(path.rsplit("/", 1)[-1][:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_legacy_shims_and_example_twins_import_no_jax_or_reference():
    """The legacy shims (``core/daemon.py``, ``core/adapters/*``) and the four
    example twins load neither JAX nor the reference."""
    assert [p.name for p in TWINS] == [
        "profile_embeddings_torch.py", "quickstart_torch.py",
        "serve_longctx_torch.py", "train_tiered_moe_torch.py"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _SHIM_PROBE, *map(str, TWINS)],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
