"""The port's distribution layer against the reference, on the CPU.

The multi-rank checks run in one gloo world of 8 ranks
(``tests/torch_dist_world.py``), started by a module fixture at this
file's first test and carrying the (2, 4) ``("data", "model")`` mesh, the
(4, 2) one and the (1, 8) one; the 4-rank checks run on the (2, 4) mesh's 'model' ranks.
Each is held to the reference's single-device function, run here on the
same numpy inputs (weights through ``convert.py``), and the port's
meshless path where it has one:

* placement specs (``param_pspecs`` with and without ``fsdp``,
  ``batch_pspec``, ``cache_pspecs`` full and paged) equal to the
  reference's as tuples, for every arch's smoke params and caches and, by
  shape, its full params, on (2, 4), (1, 8) and (2, 16, 16) meshes (shape
  stand-ins);
* ``shard`` / ``gather`` round trips bitwise; ``host_offload`` bitwise and
  the identity on the CPU;
* ``compress_psum`` over 4 ranks within 1e-6 |x| + 1e-7 of the
  reference's formula evaluated in one process, sum and residual;
* ``pipeline_apply`` (4 stages, 8 microbatches, a tree a stage) within
  1e-5 of the stages applied in turn, and its gradients (stage weights and
  input) within 1e-5 of ``jax.grad`` of them;
* ``combine_stats`` over 4 ranks' slots within 1e-5 + 1e-5 |ref| of the
  unsharded Pallas attention (interpret mode), the page mass within 1e-6;
* ``decode_step_paged(smesh=)``, 16 float32 steps of llama3.2-3b-smoke
  with the slots over the (2, 4) mesh's 4 'model' ranks, and of
  gemma2-27b-smoke (softcaps, post-norms) over the (4, 2) mesh's 2: ring
  integers bitwise the reference's unsharded decode, pages and logits
  within 1e-5, greedy ids bitwise, kv mass within 1e-6 (and the port's
  meshless decode the same; the first group's pages, which no attention
  output reaches, bitwise between the two); the ``layout`` arm computes
  its share over 'model' (llama's 4/2 heads do not divide 4, gemma2's
  divide 2); zamba2-2.7b-smoke on (2, 4) (Mamba2 mixers by heads, the
  shared attention block) and xlstm-1.3b-smoke on (1, 8) (mLSTM's 4 heads
  two ranks each, sLSTM by channels), every recurrent decode state within
  1e-5 max(1, max |ref|) of the reference's;
* the dry run's prefill and dense-cache decode cells on values, the same
  archs and meshes, partitioned over 'model', the dense cache's sequence
  split over 'model' and attended a rank's block at a time (every
  attention block's, none whole): logits and cache within 1e-5 of the
  meshless run and the reference's, greedy ids bitwise;
* each partitioned layer over 4 'model' ranks (attention, MLPs, the head
  and loss, MLA, the shared expert, and the recurrent mixers: Mamba2 by
  heads, mLSTM by heads and within a head, sLSTM by channels; cross
  attention by heads, query rows, head columns and whole, and the
  encoder's bidirectional attention by head columns) within 1e-5 of the
  reference's layer and its gradients (cross attention's ``kv_src``'s
  too); the dense-cache decode cores (GQA with gemma2's window and
  softcap, MLA) over each rank's block of the cache's sequence within
  1e-5 of the reference's over the whole cache, each rank's block after
  the write bitwise the meshless write's (the reference's slice but the
  written row, within 1e-5);
* ``moe_apply_ep`` on (2, 4) with capacity factor 8: ids bitwise the
  reference's ``moe_apply_ep(ep_axes=None)``, y and every gradient (x,
  router, the expert stacks, the shared expert) within 1e-5 of the
  reference's single-device autograd; the ``"residency"`` arm against the
  reference's ``_ep_resident_body`` without a mesh;
* ZeRO-1 over 8 shards: m, v, step and params bitwise the meshless update
  (the reference's); with ``compress_collective`` bitwise the reference's
  update with ``compress_delta(..., n_shards=8)``; ``offload_master``
  bitwise the resident arm.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.registry import ARCHS as J_ARCHS  # noqa: E402
from repro.configs.registry import get_config as j_config  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.dist import sharding as j_sh  # noqa: E402
from repro.kernels.paged_attn import ops as j_pa  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import decode as j_dec  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import mamba2 as j_mamba2  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro.optim import zero1 as j_z1  # noqa: E402
from repro.optim.optimizers import OptConfig as JOpt  # noqa: E402
from repro.tiering import codec as j_codec  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.dist import host_offload  # noqa: E402
from repro_torch.dist import sharding as t_sh  # noqa: E402
from repro_torch.launch.mesh import MeshShape, production_shape  # noqa: E402
from repro_torch.models import decode as t_dec  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402

import torch_dist_world as tw  # noqa: E402

LLAMA = "llama3.2-3b"
MESHES = {"2x4": MeshShape(("data", "model"), (2, 4)),
          "1x8": MeshShape(("data", "model"), (1, 8)),
          "pods": production_shape(multi_pod=True)}
SLOTS, PAGE_T, STEPS = 8, 4, 16
ZERO1_OPT = dict(lr=1e-2, weight_decay=0.1, warmup_steps=1, total_steps=6)
MOE = dict(d=32, e=8, f=64, k=2, shared=32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _f32_params(arch):
    """An arch's smoke params in float32 as numpy, both sides' weights (the
    port's draw from seed 0: the reference's own init takes seconds
    eagerly, and only the values' equality matters)."""
    p = t_tr.init_params(get_smoke_config(arch), 0, device="cpu")
    return t_sh.tree_map_with_path(lambda _, x: x.float().numpy(), p)


def _rng(seed):
    return np.random.default_rng(seed)


# -- the inputs both sides see --------------------------------------------------

def _compress_inputs():
    r = _rng(11)
    shapes = {"a": (6, 10), "b": (33,), "c": (4, 3, 5)}
    grads = [{k: r.normal(0, 1 + i, s).astype(np.float32) for k, s in shapes.items()}
             for i in range(4)]
    ef = {k: r.normal(0, 0.01, s).astype(np.float32) for k, s in shapes.items()}
    return grads, ef


def _pipeline_inputs():
    r = _rng(12)
    d = 16
    return (r.normal(0, d ** -0.5, (4, d, d)).astype(np.float32),
            r.normal(0, 0.1, (4, d)).astype(np.float32),
            r.normal(0, 1, (8, 3, d)).astype(np.float32),
            r.normal(0, 1, (8, 3, d)).astype(np.float32))


def _attention_inputs(softcap):
    r = _rng(13)
    b, h, hkv, p, t, d = 2, 8, 2, 8, 4, 16
    pl = r.integers(0, t + 1, (b, p)).astype(np.int32)
    pl[0, :3] = 0                                  # slots with no token
    return dict(q=r.normal(0, 1, (b, h, d)).astype(np.float32),
                k_pages=r.normal(0, 1, (b, p, t, hkv, d)).astype(np.float32),
                v_pages=r.normal(0, 1, (b, p, t, hkv, d)).astype(np.float32),
                page_lengths=pl, softcap=softcap)


# (arch, mesh) of the decode and serving-cell checks: llama's 4/2 heads do
# not divide the (2, 4) mesh's 4 'model' ranks, gemma2's divide the (4, 2)'s
# 2; deepseek-v3's MLA (4 heads, one a rank) and kimi-k2's GQA (4/2 heads:
# query rows) with their dense prologue and shared expert, experts
# expert-parallel
# the recurrent archs: zamba2's Mamba2 mixers (8 heads, in_proj's 296 columns
# in blocks of 74 across its segments) and shared attention block on 4
# ranks, xlstm's mLSTM (4 heads, two ranks a head) and sLSTM on (1, 8)'s 8
DECODE_CASES = [(LLAMA, "2x4"), ("gemma2-27b", "4x2"), ("deepseek-v3-671b", "2x4"),
                ("kimi-k2-1t-a32b", "2x4"), ("zamba2-2.7b", "2x4"), ("xlstm-1.3b", "1x8")]
DECODE_IDS = [f"{a}@{m}" for a, m in DECODE_CASES]


def _decode_tokens(arch=LLAMA):
    return _rng(14).integers(0, j_smoke(arch).vocab, (2, STEPS)).astype(np.int32)


def _cell_inputs(arch=LLAMA, mesh="2x4"):
    """The serving cells' decode columns (B rows, one a data rank of
    ``mesh``, over a 16-token dense cache) and prefill prompt (B, 8
    tokens)."""
    r = _rng(17)
    v, b = j_smoke(arch).vocab, int(mesh.split("x")[0])
    return dict(tokens=r.integers(0, v, (b, 16)).astype(np.int32),
                prompt=r.integers(0, v, (b, 8)).astype(np.int32))


# the partitioned layers over 4 'model' ranks: attention by heads (4/4
# heads), by query rows (4/2, 8 rows), whole on gathered q/k/v (6 rows do
# not divide 4); qwen's biases, gemma2's window and softcap; the three MLPs;
# the vocab-parallel embedding, head (softcapped) and loss (masked)
TP_CASES = {
    "attn-heads": ("attn", dict(h=4, hkv=4, dh=8, s=8, bias=True)),
    "attn-rows": ("attn", dict(h=4, hkv=2, dh=8, s=8, bias=False)),
    "attn-rows-window": ("attn", dict(h=4, hkv=2, dh=8, s=8, bias=True, window=3,
                                      softcap=5.0, scale=0.3)),
    "attn-whole": ("attn", dict(h=4, hkv=2, dh=8, s=6, bias=True)),
    "mlp-swiglu": ("mlp", dict(mlp="swiglu")),
    "mlp-geglu": ("mlp", dict(mlp="geglu")),
    "mlp-gelu": ("mlp", dict(mlp="gelu")),
    "head": ("head", dict(softcap=0.0)),
    "head-softcap": ("head", dict(softcap=3.0)),
    # MLA (4 heads, one a rank; wkv_a's 12 columns in blocks of 3, rank 2's
    # straddling the 8 | 4 latent | rope border), its dense-cache decode,
    # and a MoE layer's shared expert
    "mla": ("mla", dict(s=8)),
    "mla-decode": ("mla-decode", dict(s=1)),
    # the dense-cache decode cores over the rank's block of a 16-position
    # (MLA: 8) cache split over the 4 ranks, the softmax statistics merged:
    # GQA with biases, gemma2's window (5) and softcap at position 13, the
    # window crossing the border of the last two ranks' blocks; GQA at
    # position 2, three ranks' blocks wholly masked; MLA at position 5
    "attn-decode-split": ("attn-decode", dict(h=4, hkv=2, dh=8, bias=True, window=5,
                                              softcap=5.0, scale=0.3, pos=13)),
    "attn-decode-split-first": ("attn-decode", dict(h=4, hkv=2, dh=8, bias=False,
                                                    pos=2)),
    "mla-decode-split": ("mla-decode", dict(s=1, split=True)),
    "shared-expert": ("shared", dict()),
    # the recurrent mixers over two chunks of 4: Mamba2 by heads (4 heads in
    # 2 groups; in_proj's 84 columns in blocks of 21 across its z | x | B | C
    # | dt segments), mLSTM by heads (4 heads) and within a head (2 heads,
    # two ranks each: q . k and the normaliser summed over the head's
    # ranks), sLSTM by channels
    "mamba2": ("mamba2", dict(s=8)),
    "mlstm-heads": ("mlstm", dict(h=4, s=8)),
    "mlstm-within-head": ("mlstm", dict(h=2, s=8)),
    "slstm": ("slstm", dict(s=8)),
    # cross attention over 6 keys (no RoPE, every key visible) in each of its
    # forms: by heads (4/4), by query rows (4/2 heads, 8 rows), by head
    # columns (2 heads of 8 columns, two ranks a head, 6 rows), whole on
    # gathered q, k and v (4/2 heads at one query, a decode step's); and the
    # encoder's bidirectional GQA by head columns (6 frames do not divide 4)
    "cross-heads": ("cross", dict(h=4, hkv=4, dh=8, s=8, bias=True)),
    "cross-rows": ("cross", dict(h=4, hkv=2, dh=8, s=8, bias=False)),
    "cross-cols": ("cross", dict(h=2, hkv=2, dh=8, s=6, bias=True)),
    "cross-whole": ("cross", dict(h=4, hkv=2, dh=8, s=1, bias=True)),
    "attn-bidir-cols": ("attn", dict(h=2, hkv=2, dh=8, s=6, bias=True, causal=False)),
}
CROSS_KEYS = 6
MLA_DIMS = dict(h=4, q_lora=8, kv_lora=8, d_nope=4, d_rope=4, d_v=4)
MAMBA_DIMS = dict(headdim=8, n_groups=2, d_state=4, chunk=4)


def _tp_inputs(case):
    """(p, x, ct, kw for the port, kw for the reference) of a TP case."""
    kind, c = TP_CASES[case]
    r = _rng(18)
    d, b = 16, 2
    n = lambda *shape: r.normal(0, 0.5, shape).astype(np.float32)
    if kind == "head":
        v, s = 32, 5
        p = {"table": n(v, d)}
        labels = r.integers(0, v, (b, s)).astype(np.int32)
        ct = {"labels": labels, "tokens": r.integers(0, v, (b, s)).astype(np.int32),
              "mask": (r.random((b, s)) < 0.7).astype(np.float32)}
        return p, n(b, s, d), ct, dict(softcap=c["softcap"])
    if kind in ("mla", "mla-decode"):
        m = MLA_DIMS
        p = {"wq_a": n(d, m["q_lora"]),
             "q_norm": r.normal(1, 0.1, m["q_lora"]).astype(np.float32),
             "wq_b": n(m["q_lora"], m["h"] * (m["d_nope"] + m["d_rope"])),
             "wkv_a": n(d, m["kv_lora"] + m["d_rope"]),
             "kv_norm": r.normal(1, 0.1, m["kv_lora"]).astype(np.float32),
             "wkv_b": n(m["kv_lora"], m["h"] * (m["d_nope"] + m["d_v"])),
             "wo": n(m["h"] * m["d_v"], d)}
        if kind == "mla":
            return p, n(b, c["s"], d), n(b, c["s"], d), dict(m)
        smax = 8
        cache = {"c_kv": n(b, smax, m["kv_lora"]), "k_rope": n(b, smax, m["d_rope"]),
                 "pos": 5, "split": c.get("split", False)}
        return p, n(b, 1, d), cache, dict(m)
    if kind == "mamba2":
        m = MAMBA_DIMS
        d_inner, bc = 2 * d, 2 * m["n_groups"] * m["d_state"]
        heads = d_inner // m["headdim"]
        p = {"in_proj": n(d, 2 * d_inner + bc + heads),
             "conv_w": n(4, d_inner + bc), "conv_b": 0.2 * n(d_inner + bc),
             "A_log": np.log(np.linspace(1.0, 16.0, heads)).astype(np.float32),
             "D": 1 + 0.2 * n(heads), "dt_bias": 0.2 * n(heads),
             "norm": 1 + 0.2 * n(d_inner), "out_proj": n(d_inner, d)}
        return p, n(b, c["s"], d), n(b, c["s"], d), dict(m)
    if kind == "mlstm":
        h = c["h"]
        p = {k: n(d, d) for k in ("wq", "wk", "wv", "ogate", "wo")}
        p.update(wi=n(d, h), wf=n(d, h), f_bias=3 + n(h), norm=1 + 0.2 * n(d))
        return p, n(b, c["s"], d), n(b, c["s"], d), dict(n_heads=h, chunk=4)
    if kind == "slstm":
        p = {k: n(d, d) for k in ("wz", "wi", "wf", "wo_gate", "wo")}
        p.update(f_bias=3 + n(d), norm=1 + 0.2 * n(d))
        return p, n(b, c["s"], d), n(b, c["s"], d), {}
    if kind == "shared":
        f = 8
        return ({"sh_gate": n(d, f), "sh_in": n(d, f), "sh_out": n(f, d)},
                n(b, 5, d), n(b, 5, d), {})
    if kind == "mlp":
        f = 8
        p = {"w_in": n(d, f), "w_out": n(f, d)}
        if c["mlp"] == "gelu":
            p.update(b_in=n(f), b_out=n(d))
        else:
            p["w_gate"] = n(d, f)
        return p, n(b, 5, d), n(b, 5, d), dict(mlp=c["mlp"])
    h, hkv, dh, s = c["h"], c["hkv"], c["dh"], c.get("s", 1)
    p = {"wq": n(d, h * dh), "wk": n(d, hkv * dh), "wv": n(d, hkv * dh),
         "wo": n(h * dh, d)}
    if c["bias"]:
        p.update(bq=n(h * dh), bk=n(hkv * dh), bv=n(hkv * dh))
    if kind == "cross":                # kv_src rides in kw
        return p, n(b, s, d), n(b, s, d), dict(h=h, hkv=hkv, dh=dh,
                                               kv=n(b, CROSS_KEYS, d))
    if kind == "attn-decode":          # the dense cache rides in ct
        smax = 16
        cache = {"k": n(b, smax, hkv, dh), "v": n(b, smax, hkv, dh), "pos": c["pos"]}
        return p, n(b, 1, d), cache, dict(h=h, hkv=hkv, dh=dh, window=c.get("window", 0),
                                          softcap=c.get("softcap", 0.0),
                                          scale=c.get("scale"))
    kw = dict(h=h, hkv=hkv, dh=dh, window=c.get("window", 0),
              softcap=c.get("softcap", 0.0), scale=c.get("scale"),
              causal=c.get("causal", True))
    return p, n(b, s, d), n(b, s, d), kw


def _moe_inputs(bias):
    m = MOE
    p = _np_tree(j_moe.moe_init(jax.random.PRNGKey(0), m["d"], m["e"], m["f"],
                                shared_f=m["shared"], dtype=jnp.float32))
    r = _rng(15)
    x = r.normal(0, 1, (4, 16, m["d"])).astype(np.float32)
    ct = r.normal(0, 1, x.shape).astype(np.float32)
    b = r.normal(0, 0.05, m["e"]).astype(np.float32) if bias else None
    return p, x, ct, b


def _resident_inputs():
    p, x, _, b = _moe_inputs(True)
    hot, fetch = (5, 1, 3, 6), (0, 2, 4, 7)
    res = np.full(MOE["e"], -1, np.int32)
    res[list(hot)] = np.arange(len(hot), dtype=np.int32)
    rp = {k: v for k, v in p.items() if not k.startswith("w_")}
    for name, key in (("w_gate", "fetch_gate"), ("w_in", "fetch_in"),
                      ("w_out", "fetch_out")):
        rp[name] = p[name][list(hot)]
        rp[key] = p[name][list(fetch)]
    rp["residency"] = res
    rp["fetch_ids"] = np.asarray(fetch, np.int32)
    return rp, x[:2, :3], b


def _zero1_inputs():
    params = _f32_params(LLAMA)
    r = _rng(16)
    # a global norm below grad_clip: the clip's scale is exactly 1
    grads = [jax.tree.map(lambda a: r.normal(0, 1e-3, a.shape).astype(np.float32), params)
             for _ in range(3)]
    return params, grads


def _checks():
    grads, ef = _compress_inputs()
    w, b, x, ct = _pipeline_inputs()
    zp, zg = _zero1_inputs()
    out = [("shard_gather", "check_shard_gather",
            dict(full=_rng(10).normal(0, 1, (8, 16, 4)).astype(np.float32))),
           ("compress_psum", "check_compress_psum", dict(grads=grads, ef=ef)),
           ("pipeline", "check_pipeline", dict(w=w, b=b, x=x, ct=ct))]
    for softcap in (0.0, 5.0):
        out.append((f"combine_{softcap}", "check_combine_stats", _attention_inputs(softcap)))
    for arch, mesh in DECODE_CASES:
        out.append((f"decode_{arch}@{mesh}", "check_sharded_decode",
                    dict(params=_f32_params(arch), tokens=_decode_tokens(arch),
                         n_slots=SLOTS, page_t=PAGE_T, arch=arch, mesh=mesh)))
        out.append((f"cells_{arch}@{mesh}", "check_cell_serving",
                    dict(params=_f32_params(arch), arch=arch, mesh=mesh,
                         **_cell_inputs(arch, mesh))))
    for case in TP_CASES:
        p, x, ct, kw = _tp_inputs(case)
        out.append((f"tp_{case}", "check_partitioned_layers",
                    dict(kind=TP_CASES[case][0], p=p, x=x, ct=ct, kw=kw)))
    for bias in (False, True):
        p, x, ct, bb = _moe_inputs(bias)
        out.append((f"moe_{bias}", "check_moe_ep", dict(p=p, x=x, ct=ct, k=MOE["k"], bias=bb)))
    rp, rx, rb = _resident_inputs()
    out.append(("resident", "check_moe_resident", dict(rp=rp, x=rx, k=MOE["k"], bias=rb)))
    for compress, offload in ((False, False), (True, False), (True, True)):
        out.append((f"zero1_{compress}_{offload}", "check_zero1",
                    dict(params=zp, grads=zg, opt=ZERO1_OPT, compress=compress,
                         offload=offload)))
    return out


@pytest.fixture(scope="module", autouse=True)
def world():
    w = tw.World(_checks())
    try:
        yield w
    finally:
        w.close()


def _result(world, name, rank=0):
    res = world.results()[rank][name]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank}, check {name}:\n{res['error']}")
    return res


# -- placement specs --------------------------------------------------------------

def _ref_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {j_sh.path_str(kp): tuple(s) for kp, s in flat}


def _port_specs(tree):
    out = {}
    t_sh.tree_map_with_path(lambda p, s: out.__setitem__(p, tuple(s)), tree)
    return out


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_param_specs_match_reference(arch):
    """Smoke and full params (by shape), every mesh, with and without fsdp."""
    smoke, full = (jax.eval_shape(lambda c=c: j_tr.init_params(c, jax.random.PRNGKey(0)))
                   for c in (j_smoke(arch), j_config(arch)))
    ports = {"smoke": t_tr.init_params(get_smoke_config(arch), device="meta"),
             "full": t_tr.init_params(get_config(arch), device="meta")}
    for which, ref in (("smoke", smoke), ("full", full)):
        for mesh in MESHES.values():
            for fsdp in (False, True):
                want = _ref_specs(j_sh.param_pspecs(ref, mesh, fsdp=fsdp))
                got = _port_specs(t_sh.param_pspecs(ports[which], mesh, fsdp=fsdp))
                assert got == want, (which, mesh, fsdp)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_cache_and_batch_specs_match_reference(arch):
    jc, tc = j_smoke(arch), get_smoke_config(arch)
    caches = [(j_dec.init_cache(jc, 4, 32), t_dec.init_cache(tc, 4, 32, device="cpu"), None),
              (j_dec.init_paged_cache(jc, 4, SLOTS, PAGE_T),
               t_dec.init_paged_cache(tc, 4, SLOTS, PAGE_T, device="cpu"), ("model",))]
    for mesh in MESHES.values():
        assert tuple(j_sh.batch_pspec(mesh)) == t_sh.batch_pspec(mesh)
        for ref, port, slots in caches:
            want = _ref_specs(j_sh.cache_pspecs(ref, mesh, slot_axes=slots))
            got = _port_specs(t_sh.cache_pspecs(port, mesh, slot_axes=slots))
            assert got == want, (mesh, slots)


def test_host_offload_is_bitwise_and_logical_on_the_cpu():
    x = torch.from_numpy(_rng(17).normal(0, 1, (5, 7)).astype(np.float32))
    y = host_offload.to_slow_tier(x, None, (None, None))
    z = host_offload.to_fast_tier(y, None, (None, None))
    assert y is x and z is x
    assert host_offload.supports_memory_kinds("cpu") is False
    pre = host_offload.Prefetch({"m": x, "step": torch.zeros(())}, None)
    got = pre.wait()
    assert got["m"] is x and pre.start is None
    assert torch.equal(got["m"], torch.from_numpy(_rng(17).normal(0, 1, (5, 7))
                                                  .astype(np.float32)))


# -- the multi-rank checks --------------------------------------------------------

def test_shard_gather_round_trips(world):
    for rank in range(tw.WORLD):
        res = _result(world, "shard_gather", rank)
        assert all(ok for *_, ok in res), res


def test_compress_psum_matches_reference_formula(world):
    grads, ef = _compress_inputs()
    res = _result(world, "compress_psum")
    for i, k in enumerate(sorted(ef)):
        xs = [jnp.asarray(g[k]) + ef[k] for g in grads]
        qs = [j_codec.quantize_int8(x) for x in xs]
        applied = [j_codec.dequantize_int8(q, s, jnp.float32) for q, s in qs]
        total = functools.reduce(lambda a, b: a + b, applied)
        resid = functools.reduce(lambda a, b: a + b,
                                 [x - a for x, a in zip(xs, applied)]) / 4.0
        scale = max(float(jnp.abs(x).max()) for x in xs)
        assert np.abs(res["sum"][i] - np.asarray(total)).max() <= 1e-6 * scale + 1e-7
        assert np.abs(res["ef"][i] - np.asarray(resid)).max() <= 1e-6 * scale + 1e-7
    for rank in range(1, tw.WORLD):           # every rank holds the same sum
        other = _result(world, "compress_psum", rank)
        for a, b in zip(res["sum"], other["sum"]):
            np.testing.assert_array_equal(a, b)


def _sequential_stages(w, b, x):
    h = x
    for i in range(4):
        h = jnp.tanh(h @ w[i] + b[i])
    return h


def test_pipeline_matches_sequential_stages(world):
    w, b, x, _ = _pipeline_inputs()
    h = _sequential_stages(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    for rank in (0, 5):
        got = _result(world, "pipeline", rank)["y"]
        assert got.shape == x.shape
        assert np.abs(got - np.asarray(h)).max() < 1e-5


def test_pipeline_gradients_match_sequential_stages(world):
    """The pipeline's backward (the reverse ring, the identity through the
    final sum, the input's all-reduce) against ``jax.grad`` of the four
    stages applied one after another, on every rank of both 'model' rings."""
    w, b, x, ct = _pipeline_inputs()
    loss = lambda w_, b_, x_: jnp.sum(_sequential_stages(w_, b_, x_) * ct)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(w), jnp.asarray(b),
                                             jnp.asarray(x))
    for rank in range(tw.WORLD):
        got = _result(world, "pipeline", rank)
        for key, ref in zip(("w", "b", "x"), want):
            assert got[key].shape == ref.shape, key
            assert np.abs(got[key] - np.asarray(ref)).max() < 1e-5, (rank, key)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_combine_stats_match_unsharded_attention(world, softcap):
    inp = _attention_inputs(softcap)
    want, mass = j_pa.paged_attention(
        jnp.asarray(inp["q"]), jnp.asarray(inp["k_pages"]), jnp.asarray(inp["v_pages"]),
        jnp.asarray(inp["page_lengths"]), softcap=softcap, return_mass=True)
    want, mass = np.asarray(want), np.asarray(mass)
    res = _result(world, f"combine_{softcap}")
    for key in ("out", "out_mass"):
        assert np.all(np.abs(res[key] - want) <= 1e-5 + 1e-5 * np.abs(want)), key
    assert np.abs(res["mass"] - mass).max() <= 1e-6


@pytest.mark.parametrize("arch,mesh", DECODE_CASES, ids=DECODE_IDS)
def test_sharded_paged_decode_matches_reference(world, arch, mesh):
    cfg = j_smoke(arch)
    params = jax.tree.map(jnp.asarray, _f32_params(arch))
    tokens = _decode_tokens(arch)
    cache = j_dec.init_paged_cache(cfg, 2, SLOTS, PAGE_T, dtype=jnp.float32)
    step = jax.jit(lambda p, c, t: j_dec.decode_step_paged(
        cfg, p, c, t, page_t=PAGE_T, return_streams=True))
    logits, masses = [], []
    for t in range(STEPS):
        lg, cache, st = step(params, cache, jnp.asarray(tokens[:, t:t + 1]))
        logits.append(np.asarray(lg))
        masses.append(np.asarray(st["kv_mass"]))
    ring = tw._first_ring(cache["blocks"])
    res = _result(world, f"decode_{arch}@{mesh}")
    for arm in ("sharded", "layout", "meshless"):
        got = res[arm]
        np.testing.assert_array_equal(got["logits"].argmax(-1),
                                      np.stack(logits).argmax(-1))
        np.testing.assert_array_equal(got["pos"], np.asarray(cache["pos"]))
        assert np.abs(got["logits"] - np.stack(logits)).max() <= 1e-5
        states = {f"{i}/{k}": np.asarray(v) for i, b in enumerate(cache["blocks"])
                  if "k_pages" not in b for k, v in b.items()}
        assert set(got["states"]) == set(states)
        for key, want in states.items():       # the recurrent decode states
            assert np.abs(got["states"][key] - want).max() \
                <= 1e-5 * max(1.0, np.abs(want).max()), (arm, key)
        if ring is None:
            continue
        blk = cache["blocks"][ring]
        assert int(np.asarray(blk["cur_slot"]).max()) >= 2     # the ring advanced
        np.testing.assert_array_equal(got["page_len"], np.asarray(blk["page_len"]))
        np.testing.assert_array_equal(got["cur_slot"], np.asarray(blk["cur_slot"]))
        assert np.abs(got["k_pages"] - np.asarray(blk["k_pages"])).max() <= 1e-5
        assert np.abs(got["kv_mass"] - np.stack(masses)).max() <= 1e-6
    if ring is not None:
        for key in ("first_k", "first_v"):    # the first ring's rows see no attention
            np.testing.assert_array_equal(res["sharded"][key], res["meshless"][key])


@pytest.mark.parametrize("arch,mesh", DECODE_CASES, ids=DECODE_IDS)
def test_dry_run_serving_cells_match_meshless_and_reference(world, arch, mesh):
    """launch/specs.py's prefill_32k and decode_32k callables on values over
    the mesh (params gathered a group at a time and partitioned over
    'model', each block's core over the rank's block of the dense cache's
    'model'-split sequence, the softmax statistics merged over the ranks):
    every rank's logits and final cache equal to the meshless run's and to
    the reference's, greedy ids bitwise."""
    cfg = j_smoke(arch)
    params = jax.tree.map(jnp.asarray, _f32_params(arch))
    inp = _cell_inputs(arch, mesh)
    tokens = inp["tokens"]
    want_pre, _ = j_dec.prefill(cfg, params, jnp.asarray(inp["prompt"]))
    cache = j_dec.init_cache(cfg, tokens.shape[0], tokens.shape[1], dtype=jnp.float32)
    step = jax.jit(lambda p, c, t: j_dec.decode_step(cfg, p, c, t))
    logits = []
    for t in range(tokens.shape[1]):
        lg, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]))
        logits.append(np.asarray(lg))
    want = {"prefill": np.asarray(want_pre), "logits": np.stack(logits),
            **{k: np.asarray(v) for k, v in cache["blocks"][0].items()}}
    for rank in range(tw.WORLD):
        res = _result(world, f"cells_{arch}@{mesh}", rank)
        for key in ("prefill", "logits"):
            np.testing.assert_array_equal(res["mesh"][key].argmax(-1),
                                          want[key].argmax(-1))
        # the mesh arm's matmuls take a rank's row, the meshless arm's both:
        # float32 sums in another order, so the arms agree within 1e-5, not
        # bitwise
        for key, got in want.items():
            for arm in ("mesh", "meshless"):
                assert np.abs(res[arm][key] - got).max() <= 1e-5, (rank, arm, key)
            assert np.abs(res["mesh"][key] - res["meshless"][key]).max() <= 1e-5, \
                (rank, key)
        assert int(res["mesh"]["pos"]) == int(res["meshless"]["pos"]) \
            == int(np.asarray(cache["pos"])) == tokens.shape[1]


@pytest.mark.parametrize("arch,mesh", DECODE_CASES, ids=DECODE_IDS)
def test_dry_run_decode_cells_attend_the_split_cache(world, arch, mesh):
    """The decode_32k cell over the mesh attends every attention block's
    cache as the rank's block of its 'model'-split sequence (16 positions
    over 4 or 2 ranks), none whole: its leaves (2 a block: K and V, MLA's
    latent and rope key) counted once a step in every attention block
    (the dense prologue's too); xlstm has none."""
    cfg = j_smoke(arch)
    blocks = sum(k not in ("mamba", "mlstm", "slstm") for k in cfg.pattern) * cfg.n_groups
    blocks += cfg.moe.n_dense_prologue if cfg.moe else 0
    steps = _cell_inputs(arch, mesh)["tokens"].shape[1]
    for rank in range(tw.WORLD):
        got = _result(world, f"cells_{arch}@{mesh}", rank)["mesh"]["cache_leaves"]
        assert got == {"split": 2 * blocks * steps, "whole": 0}, (rank, got)


@pytest.mark.parametrize("case", list(TP_CASES))
def test_partitioned_layers_match_reference(world, case):
    """Each partitioned form over 4 'model' ranks against the reference's
    layer on the whole weights: the output and every gradient (the
    weights' blocks gathered, the replicated biases' and norms' and the
    input's as each rank holds them) within 1e-5 of ``jax.grad``, on every
    rank.  The dense-cache decodes (no gradient): the output within 1e-5 of
    the reference's over the whole cache; MLA's whole-cache form (the
    cache replicated) the latent and rope key it wrote within 1e-5; the
    split forms (each rank holding its block of the cache's sequence)
    every rank's block after the write bitwise the port's meshless
    ``gqa_decode`` / ``mla_decode``'s and that slice of the reference's new
    cache, but the written row, which is within 1e-5 of it (XLA's and
    torch's float32 projection and RoPE round apart by ulps)."""
    kind, _ = TP_CASES[case]
    p, x, ct, kw = _tp_inputs(case)
    jp, jx = jax.tree.map(jnp.asarray, p), jnp.asarray(x)
    if kind in ("mla-decode", "attn-decode"):
        keys = ("c_kv", "k_rope") if kind == "mla-decode" else ("k", "v")
        cache = {k: jnp.asarray(ct[k]) for k in keys}
        layer = j_attn.mla_decode if kind == "mla-decode" else j_attn.gqa_decode
        y, cache = layer(jp, jx, cache, ct["pos"], **kw)
        split = kind == "attn-decode" or ct["split"]
        for rank in range(tw.WORLD):
            res = _result(world, f"tp_{case}", rank)
            assert np.abs(res["y"] - np.asarray(y)).max() <= 1e-5, rank
            for key in keys:
                want = np.asarray(cache[key])
                if not split:
                    assert np.abs(res[key] - want).max() <= 1e-5, (rank, key)
                    continue
                block = np.split(want, 4, axis=1)[res["coord"]]
                at = ct["pos"] - res["coord"] * block.shape[1]
                rows = [i for i in range(block.shape[1]) if i != at]
                np.testing.assert_array_equal(res[key][:, rows], block[:, rows],
                                              err_msg=f"rank {rank} {key}")
                assert np.abs(res[key] - block).max() <= 1e-5, (rank, key)
                np.testing.assert_array_equal(res[key], res[f"{key}_meshless"],
                                              err_msg=f"rank {rank} {key}")
        return
    if kind == "head":
        def f(p, x):
            logits = j_layers.logits_apply(p, x, kw["softcap"])
            loss = j_layers.cross_entropy(logits, jnp.asarray(ct["labels"]),
                                          jnp.asarray(ct["mask"]))
            emb = j_layers.embed_apply(p, jnp.asarray(ct["tokens"]))
            return loss + jnp.sum(emb * x), (loss, logits)
    elif kind == "cross":              # the gradient of kv_src too
        kw = dict(kw)
        jx = (jx, jnp.asarray(kw.pop("kv")))

        def f(p, xs):
            y = j_attn.cross_apply(p, *xs, **kw)
            return jnp.sum(y * ct), (y, None)
    else:
        layer = {"attn": lambda p, x: j_attn.gqa_apply(p, x, **kw),
                 "mla": lambda p, x: j_attn.mla_apply(p, x, **kw),
                 "shared": j_moe._shared_expert,
                 "mamba2": lambda p, x: j_mamba2.mamba2_apply(p, x, **kw),
                 "mlstm": lambda p, x: j_xlstm.mlstm_apply(p, x, **kw),
                 "slstm": j_xlstm.slstm_apply,
                 "mlp": lambda p, x: j_layers.mlp_apply(p, x, kw["mlp"])}[kind]

        def f(p, x):
            y = layer(p, x)
            return jnp.sum(y * ct), (y, None)
    # compiled once: op by op the reference's scans and MLA take seconds each
    (_, (y, logits)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jp, jx)
    if kind == "cross":
        want = dict(_np_tree(gp), x=np.asarray(gx[0]), kv=np.asarray(gx[1]))
    else:
        want = dict(_np_tree(gp), x=np.asarray(gx))
    for rank in range(tw.WORLD):
        res = _result(world, f"tp_{case}", rank)
        assert np.abs(res["y"] - np.asarray(y)).max() <= 1e-5 * max(1.0, np.abs(y).max())
        if logits is not None:
            assert np.abs(res["logits"] - np.asarray(logits)).max() <= 1e-5
        assert set(res["grads"]) == set(want)
        for k, g in want.items():
            assert np.abs(res["grads"][k] - g).max() <= 1e-5 * max(1.0, np.abs(g).max()), \
                (rank, k)


@pytest.mark.parametrize("bias", [False, True])
def test_moe_apply_ep_matches_single_device(world, bias):
    p, x, ct, b = _moe_inputs(bias)
    jb = None if b is None else jnp.asarray(b)

    def loss(p, x):
        y, idx, _ = j_moe.moe_apply_ep(p, x, MOE["k"], bias=jb)
        return jnp.sum(y * ct), (y, idx)
    jp = jax.tree.map(jnp.asarray, p)
    (gp, gx), (y, idx) = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    res = _result(world, f"moe_{bias}")
    np.testing.assert_array_equal(res["idx"], np.asarray(idx))
    assert np.abs(res["y"] - np.asarray(y)).max() <= 1e-5
    want = dict(_np_tree(gp), x=np.asarray(gx))
    assert set(res["grads"]) == set(want)
    for k, g in want.items():
        assert np.abs(res["grads"][k] - g).max() <= 1e-5 * max(1.0, np.abs(g).max()), k


def test_moe_resident_arm_matches_reference(world):
    rp, x, b = _resident_inputs()
    y, idx, _ = jax.jit(lambda p, x, b: j_moe.moe_apply_ep(p, x, MOE["k"], bias=b))(
        jax.tree.map(jnp.asarray, rp), jnp.asarray(x), jnp.asarray(b))
    for rank in (0, 6):
        res = _result(world, "resident", rank)
        np.testing.assert_array_equal(res["idx"], np.asarray(idx))
        assert np.abs(res["y"] - np.asarray(y)).max() <= 1e-5


def _ref_zero1(compress):
    """The reference's ZeRO-1 over 8 shards, evaluated in one process."""
    params, grads = _zero1_inputs()
    params = jax.tree.map(jnp.asarray, params)
    n_shards = j_z1._n_shards
    j_z1._n_shards = lambda mesh: 8
    try:
        st, spec = j_z1.zero1_init(params, None, compress_collective=compress)
        for g in grads:
            params, st, om = j_z1.zero1_update(JOpt(**ZERO1_OPT), params,
                                               jax.tree.map(jnp.asarray, g), st, spec,
                                               None, compress_collective=compress)
    finally:
        j_z1._n_shards = n_shards
    return params, st, om, spec


@pytest.mark.parametrize("compress,offload", [(False, False), (True, False), (True, True)])
def test_zero1_over_eight_shards_matches_reference(world, compress, offload):
    params, st, om, spec = _ref_zero1(compress)
    res = _result(world, f"zero1_{compress}_{offload}")
    assert res["padded"] == spec.padded
    assert res["collective_bytes"] == om["collective_bytes"]
    assert res["step"] == int(st["step"])
    for k in ("m", "v") + (("ef",) if compress else ()):
        np.testing.assert_array_equal(res[k], np.asarray(st[k]), err_msg=k)
    for a, b in zip(res["params"], jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    if offload:
        resident = _result(world, "zero1_True_False")
        for k in ("m", "v", "ef"):
            np.testing.assert_array_equal(res[k], resident[k])
