"""The port's census and roofline (``repro_torch.roofline``) against the
reference's (``repro.roofline``).

* the census: the reference's ``tests/test_census.py`` cases (a 10-trip
  loop of 256^3 matmuls, nested 4 x 3 loops, one dot exactly, no collective
  bytes on one rank), the collective bytes of an all-gather and a
  reduce-scatter over a fake 8-rank group (one subprocess), and its FLOPs
  equal to ``FlopCounterMode``'s over a train step;
* the kernel wrappers' meta branch: meta inputs give meta outputs of the
  kernel's shapes and launch nothing, CPU inputs never take it (their plain
  versions' values), and a census counts each kernel by formula, the same
  on both;
* ``model_flops`` equal to the reference's for every arch x shape;
* a cell's census on meta tensors equal to the census of the same cell on
  real CPU tensors (llama3.2-3b, kimi-k2, zamba2 smoke: train and the
  paged decode, which reach the sketch and attention wrappers);
* the prefill census of two smoke archs within 2% of the reference's census
  of the compiled HLO (both count the same dots; they agree exactly).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.registry import list_archs  # noqa: E402
from repro.models import decode as j_dec  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.roofline import analysis as j_an  # noqa: E402
from repro.roofline import census as j_census  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.kernels.cms_hist import ops as hist_ops  # noqa: E402
from repro_torch.kernels.cms_hist.ref import hist_ref  # noqa: E402
from repro_torch.kernels.neoprof_update import ops as np_ops  # noqa: E402
from repro_torch.kernels.neoprof_update.ref import mark_hot_ref, update_ref  # noqa: E402
from repro_torch.kernels.paged_attn import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attn.ref import paged_attention_raw_ref  # noqa: E402
from repro_torch.launch.specs import cell_specs  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.roofline.census import census  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one census subprocess: a fake world of 8 ranks, then of 1
COLLECTIVES_SCRIPT = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.dist import collectives as col
    from repro_torch.roofline.census import census
    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    g = dist.group.WORLD
    x = torch.ones((4, 8), dtype=torch.float32)
    out["gather"] = census(lambda: col.all_gather(x, 0, g))[1]
    out["scatter"] = census(lambda: col.reduce_scatter(torch.ones((32, 8)), 0, g))[1]
    out["gather_meta"] = census(lambda: col.all_gather(x.to("meta"), 0, g))[1]
    dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    out["one"] = census(lambda: col.all_reduce(x.clone(), dist.group.WORLD))[1]
    dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def collectives_run():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", COLLECTIVES_SCRIPT], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()


# -- the reference's census cases ----------------------------------------------------

def _loop(x, w, n):
    for _ in range(n):
        x = x @ w
    return x


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_trip_multiplication(device):
    x = torch.ones((256, 256), device=device)
    _, c = census(_loop, x, x.clone(), 10)
    assert c["flops_per_device"] == 10 * 2 * 256 ** 3


def test_nested_loops():
    def f(x, w):
        for _ in range(4):
            x = _loop(x, w, 3)
        return x
    x = torch.ones((128, 128))
    _, c = census(f, x, x.clone())
    assert c["flops_per_device"] == 12 * 2 * 128 ** 3


def test_single_dot_exact():
    a, b = torch.ones((64, 32)), torch.ones((32, 16))
    _, c = census(torch.matmul, a, b)
    assert c["flops_per_device"] == 2 * 64 * 32 * 16
    # bytes: the dot's inputs and output; peak: the inputs and the output
    assert c["bytes_per_device"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert c["argument_bytes"] == 4 * (64 * 32 + 32 * 16)
    assert c["peak_bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)


def test_no_collectives_single_device():
    _, c = census(torch.matmul, torch.ones((64, 64)), torch.ones((64, 64)))
    assert c["collective_bytes_per_device"] == 0 and c["collectives"] == {}


def test_collectives_count_their_result_bytes(collectives_run):
    """An all-gather and a reduce-scatter over a fake 8-rank group count
    their results' bytes once each (the port has no all-to-all); a group of
    one rank counts nothing."""
    import json
    out, err = collectives_run.communicate(timeout=300)
    assert collectives_run.returncode == 0, err[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    assert got["gather"]["collectives"] == {"all-gather": {"count": 1, "bytes": 32 * 8 * 4}}
    assert got["gather"]["collective_bytes_by_ranks"] == {"8": 32 * 8 * 4}
    assert got["scatter"]["collectives"] == {"reduce-scatter": {"count": 1, "bytes": 4 * 8 * 4}}
    assert got["gather_meta"]["collectives"] == got["gather"]["collectives"]
    assert got["one"]["collective_bytes_per_device"] == 0 and got["one"]["collectives"] == {}


def test_flops_equal_flop_counter_mode():
    """The census applies FlopCounterMode's formulas in its own dispatch
    mode: over a smoke train step (remat, two microbatches) the counts are
    the same."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_smoke_config("kimi-k2-1t-a32b")
    cell = cell_specs("kimi-k2-1t-a32b", "train_4k", None, cfg=cfg, batch=4, seq=32)
    _, c = census(cell["fn"], *cell["args"])
    cell = cell_specs("kimi-k2-1t-a32b", "train_4k", None, cfg=cfg, batch=4, seq=32)
    with FlopCounterMode(display=False) as fc:
        cell["fn"](*cell["args"])
    assert c["flops_per_device"] == fc.get_total_flops() > 0


# -- the kernel wrappers' meta branch ------------------------------------------------

def _rng(seed):
    return np.random.default_rng(seed)


def _attn_inputs(device):
    r = _rng(3)
    b, h, hkv, p, t, d = 2, 8, 2, 4, 8, 16
    t_ = lambda a: torch.from_numpy(a).to(device)
    return (t_(r.normal(0, 1, (b, h, d)).astype(np.float32)),
            t_(r.normal(0, 1, (b, p, t, hkv, d)).astype(np.float32)),
            t_(r.normal(0, 1, (b, p, t, hkv, d)).astype(np.float32)),
            t_(r.integers(0, t + 1, (b, p)).astype(np.int32)))


def _sketch_inputs(device):
    r = _rng(4)
    d, w, s = 2, 64, 16
    t_ = lambda a: torch.from_numpy(a).to(device)
    return dict(counts=t_(r.integers(0, 5, (d, w)).astype(np.int32)),
                epochs=t_(r.integers(0, 2, (d, w)).astype(np.uint8)),
                hot=t_(r.integers(0, 2, (d, w)).astype(bool)),
                ids=t_(r.integers(-1, 200, (s,)).astype(np.int32)),
                seeds=t_(r.integers(0, w, (d, 30)).astype(np.int32)),
                cur=t_(np.array(1, np.uint8)), is_hot=t_(r.integers(0, 2, (s,)).astype(bool)))


def _launches():
    return (pa_ops.paged_attention_raw.launches, np_ops.sketch_update_kernel.launches,
            np_ops.sketch_mark_hot_kernel.launches, hist_ops.hist_kernel.launches)


def _calls(device):
    a, k = _attn_inputs(device), _sketch_inputs(device)
    edges = torch.arange(65, dtype=torch.int32, device=device)
    return {
        "paged_attn": lambda: pa_ops.paged_attention_raw(*a, return_page_stats=True),
        "neoprof_update": lambda: np_ops.sketch_update_kernel(
            k["counts"], k["epochs"], k["hot"], k["ids"], k["seeds"], k["cur"], 7),
        "neoprof_mark": lambda: np_ops.sketch_mark_hot_kernel(
            k["hot"], k["ids"], k["is_hot"], k["seeds"]),
        "cms_hist": lambda: hist_ops.hist_kernel(k["counts"][0], k["epochs"][0],
                                                 k["cur"], edges),
    }


def _refs():
    a, k = _attn_inputs("cpu"), _sketch_inputs("cpu")
    edges = torch.arange(65, dtype=torch.int32)
    return {
        "paged_attn": paged_attention_raw_ref(*a, scale=16 ** -0.5, softcap=0.0),
        "neoprof_update": update_ref(k["counts"], k["epochs"], k["hot"], k["ids"],
                                     k["seeds"], k["cur"], 7),
        "neoprof_mark": mark_hot_ref(k["hot"], k["ids"], k["is_hot"], k["seeds"]),
        "cms_hist": hist_ref(k["counts"][0], k["epochs"][0], k["cur"], edges),
    }


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", ["paged_attn", "neoprof_update", "neoprof_mark",
                                  "cms_hist"])
def test_kernel_wrappers_meta_branch(name):
    before = _launches()
    cpu = _as_tuple(_calls("cpu")[name]())
    meta = _as_tuple(_calls("meta")[name]())
    assert _launches() == before                    # neither branch launches
    # CPU inputs run the plain version (values), never the meta branch
    for got, want in zip(cpu, _as_tuple(_refs()[name])):
        assert got.device.type == "cpu"
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # meta inputs: meta outputs of the kernel's shapes and dtypes
    assert len(meta) == len(cpu)
    for m, c in zip(meta, cpu):
        assert m.device.type == "meta" and m.shape == c.shape and m.dtype == c.dtype
    # a census counts the kernel by formula, the same on both devices
    counts = [census(_calls(dev)[name])[1] for dev in ("cpu", "meta")]
    assert counts[0]["kernels"] == counts[1]["kernels"] == {name: 1}
    for key in ("flops_per_device", "bytes_per_device"):
        assert counts[0][key] == counts[1][key], key
    if name == "paged_attn":         # 2 B H P T (dk + dv)
        assert counts[0]["flops_per_device"] == 2 * 2 * 8 * 4 * 8 * (16 + 16)


def test_kernel_inputs_on_two_devices_raise():
    q, kp, vp, pl = _attn_inputs("cpu")
    with pytest.raises(ValueError, match="span devices"):
        pa_ops.paged_attention_raw(q.to("meta"), kp, vp, pl)


# -- model FLOPs ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_match_reference(arch):
    assert list(SHAPES) == list(J_SHAPES)
    for shape in SHAPES:
        want = j_an.model_flops(arch, shape)
        got = analysis.model_flops(arch, shape)
        assert abs(got - want) <= 1e-12 * want, (shape, got, want)


def test_roofline_row_terms():
    c = {"flops_per_device": 989e12, "bytes_per_device": 3.35e12,
         "collective_bytes_per_device": 5e10 + 4.5e11,
         "collective_bytes_by_ranks": {"16": 5e10, "8": 4.5e11}}
    r = analysis.row("llama3.2-3b", "train_4k", "single", c, peak_bytes=2e9)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 2.0)
    assert r.dominant == "collective" and r.hbm_gb_per_chip == 2.0
    assert r.useful_ratio == analysis.model_flops("llama3.2-3b", "train_4k") / (989e12 * 256)
    md = analysis.to_markdown(analysis.analyze({"k": {
        "status": "ok", "arch": "llama3.2-3b", "shape": "train_4k", "mesh": "single",
        "census": c, "memory": {"peak_bytes": 2e9}}}))
    assert "| llama3.2-3b | train_4k | single |" in md and "**collective**" in md


# -- a cell's census on meta against real CPU tensors -------------------------------------

def _real(x):
    """A CPU tensor of a meta leaf's shape and dtype: small positive floats
    (the moments' square roots stay real), zero integers."""
    if x.is_floating_point():
        return (torch.rand(x.shape, generator=torch.Generator().manual_seed(0)) * 0.02
                ).to(x.dtype)
    return torch.zeros(x.shape, dtype=x.dtype)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "kimi-k2-1t-a32b", "zamba2-2.7b"])
@pytest.mark.parametrize("shape", ["train_4k", "long_500k"])
def test_meta_census_equals_real_cpu_census(arch, shape, monkeypatch):
    """The card's path op for op: the CPU's float64 square root (an ulp
    fix for torch's vectorised CPU kernel, ``optim.optimizers.sqrt``) is
    the one CPU-only detour, so both runs take torch.sqrt."""
    from repro_torch.dist.sharding import tree_map_with_path
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers, "sqrt", torch.sqrt)
    cfg = get_smoke_config(arch)
    kw = dict(cfg=cfg, batch=4, seq=32) if shape == "train_4k" else dict(cfg=cfg)
    meta = cell_specs(arch, shape, None, **kw)
    _, want = census(meta["fn"], *meta["args"])
    real = cell_specs(arch, shape, None, **kw)
    args = tree_map_with_path(lambda _, x: _real(x), list(real["args"]))
    _, got = census(real["fn"], *args)
    assert got == want
    assert want["flops_per_device"] > 0
    if arch == "kimi-k2-1t-a32b" and shape == "train_4k":
        assert want["kernels"] == {"neoprof_mark": 1, "neoprof_update": 1}
    if shape == "long_500k" and arch != "zamba2-2.7b":
        assert want["kernels"]["paged_attn"] == cfg.n_layers


# -- against the reference's HLO census ------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-3b", "kimi-k2-1t-a32b"])
def test_prefill_census_matches_reference_hlo_census(arch):
    """The same prefill (2 x 64 tokens, the smoke config): the reference
    counts the dots of its compiled HLO, the port the matmuls its eager run
    dispatches.  Within 2%; both count 2 * numel(result) * contraction of
    the same products, and they agree exactly (no dot is fused away, the
    attention is the plain float32 one on both sides)."""
    jc = j_smoke(arch)
    params = jax.eval_shape(lambda: j_tr.init_params(jc, jax.random.PRNGKey(0)))
    tokens = jax.ShapeDtypeStruct((2, 64), jnp.int32)
    txt = jax.jit(lambda p, t: j_dec.prefill(jc, p, t)[0]).lower(params, tokens) \
        .compile().as_text()
    want = j_census.census(txt)["flops_per_device"]
    cell = cell_specs(arch, "prefill_32k", None, cfg=get_smoke_config(arch), batch=2,
                      seq=64)
    _, got = census(cell["fn"], *cell["args"])
    assert abs(got["flops_per_device"] - want) <= 0.02 * want
    assert got["collectives"] == {}

