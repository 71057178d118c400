"""The port's dry-run cells (``repro_torch.launch.specs``) against the
reference's (``repro.launch.specs``), and the dry-run CLI end to end.

* one module-scoped subprocess runs the reference's ``cell_specs`` on the
  production meshes of 512 forced host devices (16 x 16 and 2 x 16 x 16),
  every arch x shape and, on kimi-k2 and deepseek-v3, every variant, and
  dumps every leaf's path, global shape, dtype, PartitionSpec and
  ``sharding.shard_shape``; the port's ``cell_specs`` over the same
  ``MeshShape`` must give the same leaves (whisper-base x long_500k the
  same skip reason; kimi-k2's tiered_experts cells, whose 24 hot experts
  do not split 16 ways, raise on both sides);
* one more subprocess runs ``python -m repro_torch.launch.dryrun`` on
  llama3.2-3b train_4k single (a fake world of 256 ranks, meta tensors)
  and ``python -m repro_torch.roofline.analysis`` on its JSON;
* importing the port (every module) loads no fake process group.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import list_archs  # noqa: E402
from repro_torch.dist.sharding import tree_map_with_path  # noqa: E402
from repro_torch.launch.mesh import production_shape  # noqa: E402
from repro_torch.launch.specs import VARIANTS, cell_specs, shard_shape, spec_map  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_ARCHS = ("kimi-k2-1t-a32b", "deepseek-v3-671b")

REFERENCE_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from repro.configs.base import SHAPES
    from repro.configs.registry import list_archs
    from repro.dist.sharding import path_str
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import cell_specs

    def entry(e):
        if e is None or isinstance(e, str):
            return e
        e = tuple(e)
        return e[0] if len(e) == 1 else list(e)

    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in list_archs():
            moe = arch in %r
            for shape in SHAPES:
                for variant in (%r if moe else (None,)):
                    key = f"{arch}|{shape}|{'multi' if multi else 'single'}|{variant}"
                    with mesh:
                        spec = cell_specs(arch, shape, mesh, variant=variant)
                    if "skip" in spec:
                        out[key] = {"skip": spec["skip"]}
                        continue
                    leaves = {}
                    try:
                        for i, a in enumerate(spec["args"]):
                            flat, _ = jax.tree_util.tree_flatten_with_path(a)
                            for kp, l in flat:
                                sp = [entry(e) for e in l.sharding.spec]
                                sp += [None] * (len(l.shape) - len(sp))
                                leaves[f"{i}/{path_str(kp)}"] = [
                                    list(l.shape), str(l.dtype), sp,
                                    list(l.sharding.shard_shape(l.shape))]
                    except ValueError as e:      # a spec that does not divide
                        out[key] = {"error": str(e)[:300]}
                        continue
                    out[key] = {"leaves": leaves}
    json.dump(out, open(sys.argv[1], "w"))
""" % (MOE_ARCHS, VARIANTS))


@pytest.fixture(scope="module")
def runs():
    """The reference's dump and the CLI cell, both started at once."""
    tmp = tempfile.mkdtemp(prefix="dryrun-test-")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    ref_out = os.path.join(tmp, "reference.json")
    cli_out = os.path.join(tmp, "dryrun.json")
    cli = (f"{sys.executable} -m repro_torch.launch.dryrun --arch llama3.2-3b "
           f"--shape train_4k --mesh single --out {cli_out} && {sys.executable} -m "
           f"repro_torch.roofline.analysis --results {cli_out}")
    procs = {
        "reference": subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT, ref_out],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True),
        "cli": subprocess.Popen(["sh", "-c", cli], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=tmp),
    }
    done = {}

    def result(name):
        if name not in done:
            out, err = procs[name].communicate(timeout=900)
            assert procs[name].returncode == 0, (out + err)[-4000:]
            path = ref_out if name == "reference" else cli_out
            with open(path) as f:
                done[name] = (json.load(f), out)
        return done[name]
    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    return e[0] if len(e) == 1 else list(e)


def _port_leaves(cell, mesh) -> dict:
    out = {}
    for i, (glob, specs) in enumerate(zip(cell["global"], cell["specs"])):
        at = spec_map(specs)

        def leaf(p, x, i=i, at=at):
            sp = tuple(at[p]) + (None,) * (x.dim() - len(at[p]))
            out[f"{i}/{p}"] = [list(x.shape), str(x.dtype).replace("torch.", ""),
                               [_entry(e) for e in sp],
                               list(shard_shape(x.shape, sp, mesh))]
        tree_map_with_path(leaf, glob)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_cell_specs_match_reference(runs, arch):
    ref, _ = runs("reference")
    n = 0
    for key, want in ref.items():
        a, shape, mesh_name, variant = key.split("|")
        if a != arch:
            continue
        variant = None if variant == "None" else variant
        mesh = production_shape(multi_pod=mesh_name == "multi")
        n += 1
        if "error" in want:
            with pytest.raises(ValueError, match="does not divide"):
                cell_specs(arch, shape, mesh, variant=variant)
            continue
        cell = cell_specs(arch, shape, mesh, variant=variant)
        if "skip" in want:
            assert cell == {"skip": want["skip"]}, key
            continue
        assert cell["fn"] is None          # a MeshShape: the specs alone
        got = _port_leaves(cell, mesh)
        assert set(got) == set(want["leaves"]), (key, sorted(set(got) ^ set(want["leaves"]))[:8])
        for path, leaf in want["leaves"].items():
            assert got[path] == leaf, (key, path)
    variants = len(VARIANTS) if arch in MOE_ARCHS else 1
    assert n == 2 * len(SHAPES) * variants


def test_skips_and_shapes():
    assert SHAPES["long_500k"] == dict(kind="decode_paged", seq_len=524288, global_batch=1)
    assert cell_specs("whisper-base", "long_500k", production_shape())["skip"].startswith(
        "enc-dec audio model")
    with pytest.raises(ValueError, match="variant"):
        cell_specs("llama3.2-3b", "train_4k", production_shape(), variant="nope")


def test_dryrun_cli_runs_a_full_size_cell(runs):
    """llama3.2-3b train_4k on the 16 x 16 mesh: rank 0 of a fake world of
    256 ranks runs the train step once on meta tensors (8 microbatches of
    2 x 4,096 tokens, AdamW, remat) under the census."""
    res, out = runs("cli")
    rec = res["llama3.2-3b|train_4k|single"]
    assert rec["status"] == "ok", rec.get("error")
    c = rec["census"]
    mf = analysis.model_flops("llama3.2-3b", "train_4k")
    # every rank computes its share of its data rows' model (partitioned
    # over the 16 'model' ranks), with remat: at least model_flops / 256
    assert mf / 256 <= c["flops_per_device"] <= 2 * mf / 256
    assert c["collectives"]["all-gather"]["count"] > 0
    assert c["collective_bytes_by_ranks"].keys() <= {"16", "256"}
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert c["kernels"] == {}
    # the analysis reads the JSON and prints its row
    row = [ln for ln in out.splitlines() if ln.startswith("| llama3.2-3b | train_4k | single |")]
    assert len(row) == 1, out
    r = analysis.analyze(res)[0]
    assert r.dominant in row[0] and r.compute_s > 0 and r.memory_s > 0 and r.collective_s > 0


_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
print(sorted(n for n in sys.modules if "fake_pg" in n))
"""


def test_import_loads_no_fake_process_group():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
