"""Tensor parallelism over 'model' against the reference's partitioned
program: per-rank FLOPs of the same step on the same meshes.

The step is llama3.2-3b at full width, cut to 2 layers and a 4,096-token
vocab, with the default ``TrainConfig()`` (AdamW, one microbatch, remat)
and a batch of (world size) x 512 tokens.  Three subprocesses run at once:

* the reference, lowered and compiled by XLA over 8 and 16 forced host
  devices (``make_host_mesh(model=m)``, ``state_shardings``,
  ``batch_shardings``, the jitted ``build_train_step``; the dense-cache
  ``decode_step`` over a 512-token cache with ``param_pspecs`` and
  ``cache_pspecs``), each compiled program read by
  ``repro.roofline.census`` (FLOPs per device from the HLO);
* the port, as rank 0 of a fake world of 8 or 16 ranks on meta tensors,
  each step once under ``repro_torch.roofline.census``, with every
  ``torch.distributed`` collective it issues counted beside the census.

Held: the port's FLOPs a rank within 5% of the reference's a device on the
8 x 1, 2 x 4 and 1 x 16 meshes (equal on 8 x 1, where nothing is split;
before the partitioned forms they were 4.00x on 2 x 4 and 16.0x on
1 x 16); every collective the port issues over more than one rank is in
its census, by op, with its bytes.  The decode step's core attends
replicated on gathered q, k and v (``models/attention.py``): its
per-rank FLOPs exceed the reference's by exactly the core's
(n - 1) / n share.
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
SEQ, CACHE = 512, 512             # a batch row's tokens; the decode cache
TRAIN_MESHES = ("8x1", "2x4", "1x16")
DECODE_MESHES = ("8x1", "2x4")

PRELUDE = """
import dataclasses, json, os, sys
CFG = dict(n_layers=2, vocab=4096)
SEQ, CACHE = %d, %d
""" % (SEQ, CACHE)

REFERENCE = PRELUDE + textwrap.dedent("""
    n, jobs = int(sys.argv[1]), json.loads(sys.argv[2])
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
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

    cfg = dataclasses.replace(get_config("llama3.2-3b"), **CFG)
    out = {}
    for model, what in jobs:
        mesh = make_host_mesh(model=model)
        if what == "train":
            tcfg = ts.TrainConfig()
            state = ts.make_state_shapes(cfg, tcfg)
            ssh = ts.state_shardings(state, mesh)
            batch = {k: jax.ShapeDtypeStruct((n, SEQ), jnp.int32)
                     for k in ("tokens", "labels")}
            fn = jax.jit(ts.build_train_step(cfg, mesh, tcfg),
                         in_shardings=(ssh, ts.batch_shardings(cfg, mesh, False)),
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
            fn = jax.jit(lambda p, c, t: dec.decode_step(cfg, p, c, t)[0])
            args = (placed(params, param_pspecs(params, mesh)),
                    placed(cache, cache_pspecs(cache, mesh)), token)
        with mesh:
            text = fn.lower(*args).compile().as_text()
        out[f"{n // model}x{model}|{what}"] = census(text)
    json.dump(out, open(sys.argv[3], "w"))
""")

PORT = PRELUDE + textwrap.dedent("""
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

    cfg = dataclasses.replace(get_config("llama3.2-3b"), **CFG)
    out = {}
    for name, what in json.loads(sys.argv[1]):
        data, model = (int(x) for x in name.split("x"))
        n = data * model
        fake_world(n)
        mesh = make_mesh((data, model), ("data", "model"), "cpu")
        if what == "train":
            tcfg = ts.TrainConfig()
            state = ts.make_state_shapes(cfg, tcfg)
            batch = {k: torch.empty((n, SEQ), dtype=torch.int32, device="meta")
                     for k in ("tokens", "labels")}
            args = (local_args(state, ts.state_specs(state, mesh), mesh),
                    local_args(batch, {k: batch_pspec(mesh) for k in batch}, mesh))
            fn = ts.build_train_step(cfg, mesh, tcfg)
        else:
            cell = cell_specs("llama3.2-3b", "decode_32k", mesh, cfg=cfg, batch=n,
                              seq=CACHE)
            fn, args = cell["fn"], cell["args"]
        issued.clear()
        _, counts = census(fn, *args)
        out[f"{name}|{what}"] = dict(counts, issued=dict(issued))
    json.dump(out, open(sys.argv[2], "w"))
""")


@pytest.fixture(scope="module")
def runs():
    """The reference over 8 and 16 devices and the port, started at once."""
    tmp = tempfile.mkdtemp(prefix="tp-test-")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jobs = {
        "ref8": [sys.executable, "-c", REFERENCE, "8",
                 json.dumps([[1, "train"], [4, "train"], [1, "decode"], [4, "decode"]])],
        "ref16": [sys.executable, "-c", REFERENCE, "16", json.dumps([[16, "train"]])],
        "port": [sys.executable, "-c", PORT,
                 json.dumps([[m, "train"] for m in TRAIN_MESHES]
                            + [[m, "decode"] for m in DECODE_MESHES])],
    }
    procs, paths = {}, {}
    for name, cmd in jobs.items():
        paths[name] = os.path.join(tmp, f"{name}.json")
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

    def get(mesh, what):
        key = f"{mesh}|{what}"
        ref = result("ref16" if mesh == "1x16" else "ref8")[key]
        return ref, result("port")[key]
    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_train_flops_per_rank_match_the_partitioned_reference(runs, mesh):
    ref, port = runs(mesh, "train")
    want, got = ref["flops_per_device"], port["flops_per_device"]
    assert abs(got - want) <= 0.05 * want, (mesh, got / want)
    if mesh == "8x1":                  # nothing split: the same work exactly
        assert abs(got - want) <= 1e-6 * want, got / want


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_every_collective_the_port_issues_is_in_its_census(runs, mesh):
    """Every collective over more than one rank, by op: the census's count
    equals the calls the port made, with bytes; over 'model' the step
    sums the row-parallel parts (all-reduce) and, where llama's 24/8 heads
    do not divide 16, exchanges the attention's query rows (all-to-all)."""
    _, port = runs(mesh, "train")
    coll, issued = port["collectives"], port["issued"]
    assert {op: rec["count"] for op, rec in coll.items()} == issued, (coll, issued)
    assert all(rec["bytes"] > 0 for rec in coll.values()), coll
    assert port["collective_bytes_per_device"] == sum(r["bytes"] for r in coll.values())
    if mesh != "8x1":
        assert coll["all-reduce"]["count"] > 0
    if mesh == "1x16":
        assert coll["all-to-all"]["count"] > 0
        assert set(port["collective_bytes_by_ranks"]) == {"16"}


def test_decode_core_is_replicated_over_model(runs):
    """On 8 x 1 the decode step's FLOPs a rank equal the reference's; on
    2 x 4 the port's exceed them by the attention core's (n - 1) / n share
    (the core runs whole on every 'model' rank, the projections, MLP and
    head split as the reference's)."""
    ref, port = runs("8x1", "decode")
    assert abs(port["flops_per_device"] - ref["flops_per_device"]) \
        <= 1e-6 * ref["flops_per_device"]
    ref, port = runs("2x4", "decode")
    rows, n, layers, width = 4, 4, 2, 24 * 128       # a data rank's rows
    core = layers * 2 * (2 * rows * CACHE * width)   # QK^T and PV over the cache
    extra = port["flops_per_device"] - ref["flops_per_device"]
    assert abs(extra - core * (n - 1) / n) <= 1e-3 * core, (extra, core)
    print(f"decode step FLOPs a rank on 2 x 4: port {port['flops_per_device']:.6g}, "
          f"reference {ref['flops_per_device']:.6g}, ratio "
          f"{port['flops_per_device'] / ref['flops_per_device']:.4f}; the core "
          f"{core:.6g} a rank against {core / n:.6g} ({n:.1f}x)")


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
