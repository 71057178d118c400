"""Tensor parallelism over 'model' against the reference's partitioned
program: per-rank FLOPs of the same step on the same meshes.

The steps are at full width, cut in depth and vocab, with the default
``TrainConfig()`` (AdamW, one microbatch, remat): llama3.2-3b (2 layers, a
4,096-token vocab, a batch of (world size) x 512 tokens), kimi-k2 (GQA,
64/8 heads) and deepseek-v3 (MLA, 128 heads, MTP) with 2 layers (1 dense
prologue, 1 MoE) of 16 experts, the same vocab and a batch of (world size)
rows of 256 tokens (128 on 16 devices).  The subprocesses run at once:

* the reference, lowered and compiled by XLA over 8 and 16 forced host
  devices, a process an arch and device count (``make_host_mesh(model=m)``,
  ``state_shardings``, ``batch_shardings``, the jitted
  ``build_train_step``; the dense-cache
  ``decode_step`` over a 512-token cache with ``param_pspecs``,
  ``cache_pspecs`` and, a MoE arch, the dry run's ``EPContext``), each
  compiled program read by ``repro.roofline.census`` (FLOPs per device
  from the HLO);
* the port, as rank 0 of a fake world of 8 or 16 ranks on meta tensors,
  each step once under ``repro_torch.roofline.census``, with every
  ``torch.distributed`` collective it issues counted beside the census.

Held: the port's FLOPs a rank within 5% of the reference's a device on the
8 x 1, 2 x 4 and 1 x 16 meshes (equal on 8 x 1, where nothing is split;
before the partitioned forms llama's were 4.00x on 2 x 4 and 16.0x on
1 x 16, kimi-k2's 2.38x and 7.85x, deepseek-v3's 2.92x and 10.55x); every
collective the port issues over more than one rank is in its census, by
op, with its bytes.  The decode step's core attends over the rank's
block of the sequence-split cache, with q, k and v gathered whole, MLA's
with the absorbed query gathered over the heads (``models/attention.py``):
its per-rank FLOPs equal the reference's within 1e-3 of the core.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = 512                       # the decode cache
LLAMA, KIMI, DEEPSEEK = "llama3.2-3b", "kimi-k2-1t-a32b", "deepseek-v3-671b"
TRAIN_MESHES = ("8x1", "2x4", "1x16")
TRAIN_CELLS = [(arch, mesh) for arch in (LLAMA, KIMI, DEEPSEEK) for mesh in TRAIN_MESHES]
DECODE_CELLS = [(LLAMA, "8x1"), (LLAMA, "2x4"), (DEEPSEEK, "2x4")]

PRELUDE = """
import dataclasses, json, os, sys
CACHE = %d
CUT = dict(n_layers=2, vocab=4096)
MOE_CUT = dict(n_dense_prologue=1, n_experts=16)

def config(get_config, arch):
    base = get_config(arch)
    if base.moe is None:
        return dataclasses.replace(base, **CUT)
    return dataclasses.replace(base, moe=dataclasses.replace(base.moe, **MOE_CUT), **CUT)

def seq(cfg, world):
    # a batch row's tokens: llama's 512; the MoE archs' 256, 128 on 16 devices
    return 512 if cfg.moe is None else 256 if world <= 8 else 128
""" % CACHE

REFERENCE_BODY = textwrap.dedent("""
    n, jobs = int(sys.argv[1]), json.loads(sys.argv[2])
    # the census reads the HLO after XLA's passes; the backend's LLVM
    # optimisation only shapes machine code that never runs here (and takes
    # nearly half the compile's CPU)
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n} "
                               "--xla_backend_optimization_level=0")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.registry import get_config
    from repro.dist.sharding import batch_pspec, cache_pspecs, param_pspecs
    from repro.launch.mesh import make_host_mesh
    from repro.models import decode as dec
    from repro.models import transformer as tr
    from repro.roofline.census import census
    from repro.train import step as ts

    out = {}
    for arch, model, what in jobs:
        cfg = config(get_config, arch)
        mesh = make_host_mesh(model=model)
        if what == "train":
            tcfg = ts.TrainConfig()
            state = ts.make_state_shapes(cfg, tcfg)
            ssh = ts.state_shardings(state, mesh)
            batch = {k: jax.ShapeDtypeStruct((n, seq(cfg, n)), jnp.int32)
                     for k in ("tokens", "labels")}
            if cfg.n_aux_tokens:       # an image's patches, an utterance's frames
                batch["aux_embeds"] = jax.ShapeDtypeStruct(
                    (n, cfg.n_aux_tokens, cfg.d_model), jnp.bfloat16)
            fn = jax.jit(ts.build_train_step(cfg, mesh, tcfg),
                         in_shardings=(ssh, ts.batch_shardings(cfg, mesh,
                                                               bool(cfg.n_aux_tokens))),
                         out_shardings=(ssh, None))
            args = (state, batch)
        else:
            def placed(tree, specs):
                return jax.tree.map(
                    lambda s, p: jax.ShapeDtypeStruct(s.shape, s.dtype,
                                                      sharding=NamedSharding(mesh, p)),
                    tree, specs, is_leaf=lambda x: isinstance(x, P))
            params = jax.eval_shape(lambda: tr.init_params(cfg, jax.random.PRNGKey(0)))
            cache = jax.eval_shape(lambda: dec.init_cache(cfg, n, CACHE,
                                                          dtype=jnp.bfloat16))
            token = jax.ShapeDtypeStruct((n, 1), jnp.int32,
                                         sharding=NamedSharding(mesh, batch_pspec(mesh)))
            ep = ts._ep_context(cfg, mesh)      # the dry run's decode cell's
            fn = jax.jit(lambda p, c, t, *aux: dec.decode_step(
                cfg, p, c, t, ep_axes=ep, aux_embeds=aux[0] if aux else None)[0])
            args = (placed(params, param_pspecs(params, mesh)),
                    placed(cache, cache_pspecs(cache, mesh)), token)
            if cfg.n_aux_tokens:       # patches, or the encoder's output
                args += (jax.ShapeDtypeStruct(
                    (n, cfg.n_aux_tokens, cfg.d_model), jnp.bfloat16,
                    sharding=NamedSharding(mesh, P(batch_pspec(mesh)[0], None, None))),)
        with mesh:
            text = fn.lower(*args).compile().as_text()
        out[f"{arch}|{n // model}x{model}|{what}"] = census(text)
    json.dump(out, open(sys.argv[3], "w"))
""")

PORT_BODY = textwrap.dedent("""
    import torch
    import torch.distributed as dist

    issued = {}

    def counted(fn, op):
        def run(*args, **kwargs):
            group = kwargs.get("group")
            if dist.get_world_size(group) > 1:
                issued[op] = issued.get(op, 0) + 1
            return fn(*args, **kwargs)
        return run

    # before the port binds any of them
    for name, op in (("all_reduce", "all-reduce"),
                     ("all_gather_into_tensor", "all-gather"),
                     ("reduce_scatter_tensor", "reduce-scatter"),
                     ("reduce_scatter_single", "reduce-scatter"),
                     ("all_to_all_single", "all-to-all")):
        if hasattr(dist, name):
            setattr(dist, name, counted(getattr(dist, name), op))

    from repro_torch.configs.registry import get_config
    from repro_torch.dist.sharding import batch_pspec
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import cell_specs, local_args
    from repro_torch.roofline.census import census
    from repro_torch.train import step as ts

    out = {}
    for arch, name, what in json.loads(sys.argv[1]):
        cfg = config(get_config, arch)
        data, model = (int(x) for x in name.split("x"))
        n = data * model
        fake_world(n)
        mesh = make_mesh((data, model), ("data", "model"), "cpu")
        if what == "train":
            tcfg = ts.TrainConfig()
            state = ts.make_state_shapes(cfg, tcfg)
            batch = {k: torch.empty((n, seq(cfg, n)), dtype=torch.int32, device="meta")
                     for k in ("tokens", "labels")}
            bspecs = {k: batch_pspec(mesh) for k in batch}
            if cfg.n_aux_tokens:       # an image's patches, an utterance's frames
                batch["aux_embeds"] = torch.empty((n, cfg.n_aux_tokens, cfg.d_model),
                                                  dtype=torch.bfloat16, device="meta")
                bspecs["aux_embeds"] = (batch_pspec(mesh)[0], None, None)
            args = (local_args(state, ts.state_specs(state, mesh), mesh),
                    local_args(batch, bspecs, mesh))
            fn = ts.build_train_step(cfg, mesh, tcfg)
        else:
            cell = cell_specs(arch, "decode_32k", mesh, cfg=cfg, batch=n, seq=CACHE)
            fn, args = cell["fn"], cell["args"]
        issued.clear()
        _, counts = census(fn, *args)
        out[f"{arch}|{name}|{what}"] = dict(counts, issued=dict(issued))
    json.dump(out, open(sys.argv[2], "w"))
""")


REFERENCE = PRELUDE + REFERENCE_BODY
PORT = PRELUDE + PORT_BODY


def _jobs(world, train_cells, decode_cells):
    """The reference's (arch, model ranks, what) jobs over ``world`` devices."""
    cells = [(a, m, "train") for a, m in train_cells] + [(a, m, "decode")
                                                        for a, m in decode_cells]
    out = []
    for arch, mesh, what in cells:
        data, model = (int(x) for x in mesh.split("x"))
        if data * model == world:
            out.append([arch, model, what])
    return out


@pytest.fixture(scope="module")
def runs():
    yield from start_runs(REFERENCE, PORT, TRAIN_CELLS, DECODE_CELLS)


def start_runs(reference, port, train_cells, decode_cells):
    """The reference over 8 and 16 devices and the port, started at once;
    yields ``get(arch, mesh, what) -> (reference census, port census)``."""
    tmp = tempfile.mkdtemp(prefix="tp-test-")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jobs = {"port": [sys.executable, "-c", port,
                     json.dumps([[a, m, "train"] for a, m in train_cells]
                                + [[a, m, "decode"] for a, m in decode_cells])]}
    for world in (8, 16):              # the reference: a process an arch and world
        by_arch = {}
        for job in _jobs(world, train_cells, decode_cells):
            by_arch.setdefault(job[0], []).append(job)
        for arch, arch_jobs in by_arch.items():
            jobs[f"ref{world}|{arch}"] = [sys.executable, "-c", reference, str(world),
                                          json.dumps(arch_jobs)]
    procs, paths = {}, {}
    for name, cmd in jobs.items():
        paths[name] = os.path.join(tmp, f"{len(paths)}.json")
        procs[name] = subprocess.Popen(cmd + [paths[name]], env=env, text=True,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    done = {}

    def result(name):
        if name not in done:
            out, err = procs[name].communicate(timeout=600)
            assert procs[name].returncode == 0, (out + err)[-4000:]
            with open(paths[name]) as f:
                done[name] = json.load(f)
        return done[name]

    def get(arch, mesh, what):
        key = f"{arch}|{mesh}|{what}"
        ref = result(f"ref{16 if mesh == '1x16' else 8}|{arch}")[key]
        return ref, result("port")[key]
    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _ids(cells):
    return [f"{arch}@{mesh}" for arch, mesh in cells]


@pytest.mark.parametrize("arch,mesh", TRAIN_CELLS, ids=_ids(TRAIN_CELLS))
def test_train_flops_per_rank_match_the_partitioned_reference(runs, arch, mesh):
    ref, port = runs(arch, mesh, "train")
    want, got = ref["flops_per_device"], port["flops_per_device"]
    assert abs(got - want) <= 0.05 * want, (mesh, got / want)
    if mesh == "8x1":                  # nothing split: the same work exactly
        assert abs(got - want) <= 1e-6 * want, got / want


@pytest.mark.parametrize("arch,mesh", TRAIN_CELLS, ids=_ids(TRAIN_CELLS))
def test_every_collective_the_port_issues_is_in_its_census(runs, arch, mesh):
    """Every collective over more than one rank, by op: the census's count
    equals the calls the port made, with bytes; over 'model' the step
    sums the row-parallel parts (all-reduce) and, where the kv heads do
    not divide 16 (llama's 24/8, kimi-k2's 64/8), exchanges the
    attention's query rows (all-to-all)."""
    _, port = runs(arch, mesh, "train")
    coll, issued = port["collectives"], port["issued"]
    assert {op: rec["count"] for op, rec in coll.items()} == issued, (coll, issued)
    assert all(rec["bytes"] > 0 for rec in coll.values()), coll
    assert port["collective_bytes_per_device"] == sum(r["bytes"] for r in coll.values())
    if mesh != "8x1":
        assert coll["all-reduce"]["count"] > 0
    if mesh == "1x16":
        assert set(port["collective_bytes_by_ranks"]) == {"16"}
        if arch != DEEPSEEK:           # MLA splits by heads, 128 / 16
            assert coll["all-to-all"]["count"] > 0


def test_decode_core_is_replicated_over_model(runs):
    """(Named for the replicated core this test first pinned.) On 8 x 1 the
    decode step's FLOPs a rank equal the reference's; on
    2 x 4 too, within 1e-3 of the attention core: each 'model' rank's core
    attends over its block of the sequence-split cache (the projections,
    MLP and head split as the reference's).  Before, the core ran whole on
    every rank, over by its (n - 1) / n share (1.0857x the reference's)."""
    ref, port = runs(LLAMA, "8x1", "decode")
    assert abs(port["flops_per_device"] - ref["flops_per_device"]) \
        <= 1e-6 * ref["flops_per_device"]
    ref, port = runs(LLAMA, "2x4", "decode")
    rows, n, layers, width = 4, 4, 2, 24 * 128       # a data rank's rows
    core = layers * 2 * (2 * rows * CACHE * width)   # QK^T and PV over the cache
    extra = port["flops_per_device"] - ref["flops_per_device"]
    assert abs(extra) <= 1e-3 * core, (extra, core)
    print(f"decode step FLOPs a rank on 2 x 4: port {port['flops_per_device']:.6g}, "
          f"reference {ref['flops_per_device']:.6g}, ratio "
          f"{port['flops_per_device'] / ref['flops_per_device']:.6f}; the core "
          f"{core:.6g}, a rank's share {core / n:.6g}")


def test_mla_decode_core_is_replicated_over_model(runs):
    """(Named for the replicated core this test first pinned.)
    deepseek-v3's dense-cache decode on 2 x 4 (MLA, the experts
    expert-parallel as the dry run's cell): the port's FLOPs a rank equal
    the reference's within 1e-3 of the absorbed core (its latent scores,
    rope scores and latent output over the cache), each rank's core over
    its block of the sequence-split cache with every head; the rest (the
    projections, the heads' absorption, the shared expert, the experts,
    the head) split as the reference's."""
    ref, port = runs(DEEPSEEK, "2x4", "decode")
    rows, n, layers, heads = 4, 4, 2, 128
    kv_lora, d_rope = 512, 64
    core = layers * 2 * rows * heads * CACHE * (2 * kv_lora + d_rope)
    extra = port["flops_per_device"] - ref["flops_per_device"]
    assert abs(extra) <= 1e-3 * core, (extra, core)
    print(f"deepseek-v3 decode step FLOPs a rank on 2 x 4: port "
          f"{port['flops_per_device']:.6g}, reference {ref['flops_per_device']:.6g}, "
          f"ratio {port['flops_per_device'] / ref['flops_per_device']:.6f}; the core "
          f"{core:.6g}, a rank's share {core / n:.6g}")


@pytest.mark.parametrize("window", [0, 5])
def test_a_ranks_query_rows_attend_as_the_whole_sequence(window):
    """The row form's core: ``sdpa_chunked`` over one rank's query rows
    (``q_offset``), chunked, equals those rows of the reference's chunked
    attention over the whole sequence (float32, within 1e-5), for every
    rank of 4, with and without a sliding window and a softcap."""
    import jax.numpy as jnp
    import numpy as np
    from repro.models import attention as j_attn
    from repro_torch.models import attention as t_attn
    r = np.random.default_rng(19)
    b, s, h, hkv, dh, n, chunk = 2, 32, 4, 2, 8, 4, 4
    q, k, v = (r.normal(0, 1, (b, s, heads, dh)).astype(np.float32)
               for heads in (h, hkv, hkv))
    kw = dict(window=window, softcap=4.0, scale=0.4)
    want = np.asarray(j_attn.sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          chunk=chunk, **kw))
    rows = s // n
    for rank in range(n):
        got = t_attn.sdpa_chunked(torch.from_numpy(q[:, rank * rows:(rank + 1) * rows]),
                                  torch.from_numpy(k), torch.from_numpy(v), chunk=chunk,
                                  q_offset=rank * rows, **kw)
        mine = want[:, rank * rows:(rank + 1) * rows]
        assert np.abs(got.numpy() - mine).max() <= 1e-5, rank
