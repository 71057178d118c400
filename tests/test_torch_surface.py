"""The port's public surface against the reference's, module by module.

Every module of ``src/repro/`` is read as text with ``ast``, so that this
file imports no JAX.  Its public names are the top-level ``def``s, classes
and assigned names not starting with ``_``, and each public class's public
methods, properties and annotated fields.  Each must resolve on the
counterpart module ``repro_torch.<same path>``, unless ``DIFFERENCES`` maps
it elsewhere (``"module:attr"`` under ``repro_torch``, or a bare name in the
counterpart module) or to ``None``, each with its reason.  A class mapped to
``None`` takes its members with it.  Parameter names are not compared:
explicit ``torch.Generator``s stand where the reference takes PRNG keys.

Also here: the engine's deprecated ``kv_tier`` (the "kv" handle when paged,
``None`` when dense), and ``init_params`` drawing bitwise what it drew
before ``layers.mlp_init`` and ``embed_init`` took over its MLPs and table.
"""
import ast
import dataclasses
import hashlib
import importlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "src" / "repro"
MODULES = sorted(str(p.relative_to(REFERENCE)) for p in REFERENCE.rglob("*.py"))

_PALLAS = "a Pallas grid's lane-segment width; the CUDA kernel's block size is fixed in"

# (reference module, public name) -> (port name or None, reason)
DIFFERENCES = {
    # the Pallas modules: the port's kernels are bound in each package's ops.py
    ("kernels/cms_hist/cms_hist.py", "hist_pallas"):
        ("kernels.cms_hist.ops:hist_kernel", "the CUDA kernel's wrapper"),
    ("kernels/cms_hist/cms_hist.py", "DEFAULT_SEG"):
        (None, f"{_PALLAS} csrc/cms_hist.cu"),
    ("kernels/neoprof_update/neoprof_update.py", "sketch_update_pallas"):
        ("kernels.neoprof_update.ops:sketch_update_kernel", "the CUDA kernel's wrapper"),
    ("kernels/neoprof_update/neoprof_update.py", "sketch_mark_hot_pallas"):
        ("kernels.neoprof_update.ops:sketch_mark_hot_kernel",
         "the CUDA kernel's wrapper"),
    ("kernels/neoprof_update/neoprof_update.py", "DEFAULT_SEG"):
        (None, f"{_PALLAS} csrc/neoprof_update.cu"),
    ("kernels/paged_attn/paged_attn.py", "paged_attention_raw"):
        ("kernels.paged_attn.ops:paged_attention_raw", "the CUDA kernel's wrapper"),
    ("kernels/paged_attn/paged_attn.py", "paged_attention"):
        ("kernels.paged_attn.ops:paged_attention", "beside its raw wrapper"),
    ("kernels/paged_attn/paged_attn.py", "page_mass"):
        ("kernels.paged_attn.ops:page_mass", "beside its raw wrapper"),
    ("kernels/paged_attn/paged_attn.py", "NEG_INF"):
        ("kernels.paged_attn.ref:NEG_INF", "the mask value of the plain version"),
    # the kernels' plain versions
    ("kernels/paged_attn/ref.py", "paged_attention_ref"):
        ("paged_attention_raw_ref", "one plain version of the raw stats: "
         "the output is acc / l"),
    ("kernels/paged_attn/ref.py", "softmax_denominator_ref"):
        ("paged_attention_raw_ref", "its m and l"),
    ("kernels/paged_attn/ref.py", "page_mass_ref"):
        ("kernels.paged_attn.ops:page_mass", "over paged_attention_raw_ref's stats"),
    ("kernels/neoprof_update/ref.py", "h3_ref"):
        ("core.sketch:h3_hash", "the sketch's own hash, the same function"),
    # models
    ("models/decode.py", "merge_cache"):
        (None, "the paged writes are masked by lane in place, and the dense "
         "cache has no lanes"),
    # the roofline: per-link rates, and a census taken at torch dispatch
    ("roofline/analysis.py", "LINK_BW"):
        ("link_bw", "NVLink inside a node, InfiniBand across, by ranks"),
    ("roofline/census.py", "parse_hlo"):
        (None, "parses HLO text; the port counts at torch dispatch (Census)"),
    ("roofline/census.py", "Instr"): (None, "an HLO instruction of parse_hlo"),
    ("roofline/census.py", "Computation"): (None, "an HLO computation of parse_hlo"),
    ("roofline/census.py", "COLLECTIVES"):
        (None, "HLO opcodes; the port names c10d's collective ops"),
    ("roofline/census.py", "DTYPE_BYTES"):
        (None, "HLO dtype names; a tensor's element_size() gives its bytes"),
    # JAX sharding: the port places tensors by spec over its own mesh
    ("optim/zero1.py", "flat_sharding"):
        (None, "a NamedSharding; each rank holds its range of the flat "
         "vectors, placed by train.step.state_specs"),
    ("optim/zero1.py", "FlatSpec.treedef"):
        ("FlatSpec.like", "a tree of the params' structure, not a JAX treedef"),
    ("dist/sharding.py", "path_str"):
        (None, "names a JAX key path; tree_map_with_path passes the "
         "'blocks/0/ffn/w_in' string itself"),
    ("dist/host_offload.py", "SLOW_KIND"):
        (None, "a JAX memory kind; the slow tier is pinned host memory "
         "(pinned_zeros)"),
    ("train/step.py", "state_shardings"):
        ("state_specs", "a tree of specs over the port's mesh"),
    ("train/step.py", "batch_shardings"):
        ("to_batch", "places a batch's rows over the data axes"),
    # the tiering plane
    ("tiering/memory.py", "InFlightEpoch.fast"):
        (None, "the epoch's promoted rows are staged on a side stream "
         "(rows, slots), not a whole next fast buffer"),
    ("core/neoprof.py", "NeoProfParams.use_kernel"):
        (None, "the wrappers choose by device: the kernel on the card, the "
         "plain version on the CPU"),
}


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _assigned(node) -> list[str]:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def reference_names(module: str) -> list[str]:
    """The module's public names; a class member as ``Class.member``."""
    names = []
    for node in ast.parse((REFERENCE / module).read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.append(node.name)
        elif isinstance(node, ast.ClassDef):
            names.append(node.name)
            if not _is_public(node.name):
                continue
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names.append(f"{node.name}.{item.name}")
                elif isinstance(item, ast.AnnAssign):
                    names += [f"{node.name}.{n}" for n in _assigned(item)]
        else:
            names += _assigned(node)
    return [n for n in names if all(map(_is_public, n.split(".")))]


def _port_module(module: str) -> str:
    parts = Path(module).with_suffix("").parts
    return ".".join(("repro_torch",) + parts[:-1 if parts[-1] == "__init__" else None])


def _has_member(cls, name: str) -> bool:
    if hasattr(cls, name):
        return True
    fields = (f.name for f in dataclasses.fields(cls)) \
        if dataclasses.is_dataclass(cls) else getattr(cls, "_fields", ())
    return name in fields or any(name in getattr(c, "__annotations__", {})
                                 for c in cls.__mro__)


def resolves(module, dotted: str) -> bool:
    obj = module
    for part in dotted.split("."):
        if isinstance(obj, type) and not hasattr(obj, part):
            return _has_member(obj, part)
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def _port_target(module: str, port_name: str):
    """(port module, dotted name) of a DIFFERENCES target."""
    if ":" in port_name:
        mod, name = port_name.split(":")
        return importlib.import_module(f"repro_torch.{mod}"), name
    return importlib.import_module(_port_module(module)), port_name


def test_census_reads_every_reference_module():
    """One case per module of the reference; the collector sees methods,
    properties, dataclass fields and module constants."""
    assert len(MODULES) >= 71
    daemon = reference_names("tiering/daemon.py")
    assert {"NeoMemDaemon", "NeoMemDaemon.hit_rates", "NeoMemDaemon.snapshot",
            "ResourceHandle.hit_rate"} <= set(daemon)
    assert "ServeEngine.kv_tier" in reference_names("serve/engine.py")
    assert {"mlp_init", "embed_init", "DTYPE"} <= set(reference_names("models/layers.py"))
    assert {"FlatSpec.treedef", "flat_sharding"} <= set(reference_names("optim/zero1.py"))
    assert not any(n.split(".")[-1].startswith("_")
                   for m in MODULES for n in reference_names(m))


@pytest.mark.parametrize("entry", sorted(DIFFERENCES),
                         ids=[f"{m}:{n}" for m, n in sorted(DIFFERENCES)])
def test_difference_is_a_reference_name_with_a_reason(entry):
    """No stale entry: each names a public member of its reference module,
    and says why it differs."""
    module, name = entry
    assert name in reference_names(module), entry
    _, reason = DIFFERENCES[entry]
    assert isinstance(reason, str) and len(reason) > 10, entry


@pytest.mark.parametrize("module", MODULES)
def test_reference_module_surface_resolves_on_port(module):
    names = reference_names(module)
    mapped = {n: DIFFERENCES[(module, n)][0] for n in names
              if (module, n) in DIFFERENCES}
    dropped = {n for n, target in mapped.items() if target is None}
    unmapped = [n for n in names if n not in mapped
                and n.split(".")[0] not in dropped]
    missing = []
    if unmapped:
        port = importlib.import_module(_port_module(module))
        missing = [n for n in unmapped if not resolves(port, n)]
    bad_targets = [f"{n} -> {t}" for n, t in mapped.items() if t is not None
                   and not resolves(*_port_target(module, t))]
    assert not missing, f"{module}: no counterpart in {_port_module(module)}: {missing}"
    assert not bad_targets, f"{module}: mapped names that do not resolve: {bad_targets}"


# -- the engine's deprecated kv_tier ------------------------------------------

def _engine(**scfg):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    cfg = get_smoke_config("llama3.2-3b")
    return ServeEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                       ServeConfig(max_seq=32, **scfg), device="cpu")


def test_kv_tier_is_the_kv_handle_when_paged():
    eng = _engine(paged=True, page_t=4, hot_slots=4)
    assert eng.kv_tier is eng.daemon["kv"]
    eng.generate(torch.arange(8, dtype=torch.int32).reshape(2, 4).numpy(), 2)
    assert eng.kv_tier.hit_rate() == eng.tier_stats()["kv"]["hit_rate"]


def test_kv_tier_is_none_when_dense():
    eng = _engine(resources=("embeddings",), embed_hot_slots=4,
                  embed_rows_per_page=8)
    assert "embeddings" in eng.daemon and eng.kv_tier is None
    assert _engine().kv_tier is None


# -- init_params draws what it drew before mlp_init / embed_init ---------------

# (leaves, sha256 over each leaf's "path dtype shape sha256(bytes)" line),
# init_params(smoke config, seed=0, device="cpu") before mlp_init/embed_init
INIT_DIGESTS = {
    "llama3.2-3b": (11, "e0728c38d060967d"),
    "kimi-k2-1t-a32b": (25, "b573009e10abad05"),
    "deepseek-v3-671b": (45, "f5b5f88025a68831"),
    "qwen1.5-4b": (14, "7c7aa792019529b9"),
    "stablelm-1.6b": (17, "1679730c6c6a1cba"),
    "gemma2-27b": (24, "0e6b67eb51c1c59e"),
    "zamba2-2.7b": (29, "ffcb6cfe412130f6"),
    "xlstm-1.3b": (20, "b41476ee14e34031"),
    "llama-3.2-vision-11b": (53, "bf77122723bf9476"),
    "whisper-base": (47, "6f3b3ecca50c0fcc"),
}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_init_digests_cover_every_registered_arch():
    from repro_torch.configs.registry import ARCHS
    assert sorted(INIT_DIGESTS) == sorted(ARCHS)


@pytest.mark.parametrize("arch", sorted(INIT_DIGESTS))
def test_init_params_bitwise_unchanged(arch):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.transformer import init_params
    params = init_params(get_smoke_config(arch), seed=0, device="cpu")
    h, n = hashlib.sha256(), 0
    for path, t in _leaves(params):
        t = t.detach().contiguous()
        leaf = hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()
        h.update(f"{path} {t.dtype} {tuple(t.shape)} {leaf}\n".encode())
        n += 1
    assert (n, h.hexdigest()[:16]) == INIT_DIGESTS[arch]
