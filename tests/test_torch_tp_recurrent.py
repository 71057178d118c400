"""Tensor parallelism over 'model' for the recurrent archs against the
reference's partitioned program: per-rank FLOPs of the same step on the
same meshes (``tests/test_torch_tp.py``'s method, in a file of its own so
that the suite's workers can run the two at once).

zamba2-2.7b (Mamba2 blocks and its shared attention block) and xlstm-1.3b
(mLSTM and sLSTM blocks) at full width, one pattern deep (6 and 8 layers),
a 4,096-token vocab, the default ``TrainConfig()``, a batch of (world
size) rows of 256 tokens (two 128-token chunks of the recurrent scans).
The subprocesses run at once: the reference lowered and compiled by XLA
over 8 and 16 forced host devices (a process an arch and device count),
each compiled program read by
``repro.roofline.census``, and the port as rank 0 of a fake world of 8 or
16 ranks on meta tensors under ``repro_torch.roofline.census``, with every
``torch.distributed`` collective it issues counted beside the census.

Held: the train step's FLOPs a rank within 5% of the reference's a device
on 2 x 4 and 1 x 16 (before the partitioned recurrent forms zamba2's were
4.000x and 16.000x, xlstm's 4.001x and 15.981x), within 1e-4 on 8 x 1,
where the reference's exceed the port's by exactly one dot a Mamba2 or
mLSTM layer in its backward;
every collective the port issues over more than one rank in its census;
the dense-cache decode (a 512-token cache) within 5% on 2 x 4, zamba2's
shared attention core over the rank's block of the sequence-split cache,
as the reference's partitioned core.
"""
import textwrap

import pytest

torch = pytest.importorskip("torch")

from test_torch_tp import CACHE, PORT_BODY, REFERENCE_BODY, start_runs  # noqa: E402

ZAMBA, XLSTM = "zamba2-2.7b", "xlstm-1.3b"
TRAIN_CELLS = [(arch, mesh) for arch in (ZAMBA, XLSTM) for mesh in ("8x1", "2x4", "1x16")]
DECODE_CELLS = [(arch, mesh) for arch in (ZAMBA, XLSTM) for mesh in ("8x1", "2x4")]

PRELUDE = textwrap.dedent("""
    import dataclasses, json, os, sys
    CACHE = %d

    def config(get_config, arch):
        # one pattern deep, the vocab cut
        base = get_config(arch)
        return dataclasses.replace(base, n_layers=len(base.pattern), vocab=4096)

    def seq(cfg, world):
        return 256
""" % CACHE)


@pytest.fixture(scope="module")
def runs():
    yield from start_runs(PRELUDE + REFERENCE_BODY, PRELUDE + PORT_BODY,
                          TRAIN_CELLS, DECODE_CELLS)


def _ids(cells):
    return [f"{arch}@{mesh}" for arch, mesh in cells]


@pytest.mark.parametrize("arch,mesh", TRAIN_CELLS, ids=_ids(TRAIN_CELLS))
def test_train_flops_per_rank_match_the_partitioned_reference(runs, arch, mesh):
    ref, port = runs(arch, mesh, "train")
    want, got = ref["flops_per_device"], port["flops_per_device"]
    print(f"{arch} train on {mesh}: port {got:.6g}, reference {want:.6g} FLOP a rank "
          f"({got / want:.6f})")
    assert abs(got - want) <= 0.05 * want, (mesh, got / want)
    if mesh == "8x1":                  # nothing split: the same work
        assert abs(got - want) <= 1e-4 * want, got / want
        # but for one dot a layer in the reference's backward: its chunk
        # states are a three-operand einsum, and XLA contracts the gradient
        # of the per-position factor (Mamba2's decay * dt, mLSTM's to_end)
        # over the state dim, 2 * S * width; the port multiplies the factor
        # in first, so its gradient is a product and a sum (no matmul)
        layers, width = (5, 2 * 2560) if arch == ZAMBA else (7, 2048)
        assert want - got == layers * 2 * 256 * width, want - got


@pytest.mark.parametrize("arch,mesh", TRAIN_CELLS, ids=_ids(TRAIN_CELLS))
def test_every_collective_the_port_issues_is_in_its_census(runs, arch, mesh):
    """Every collective over more than one rank, by op: the census's count
    equals the calls the port made, with bytes; over 'model' the step
    sums the row-parallel parts and the norms' squares (all-reduce) and
    gathers Mamba2's ``in_proj`` and B | C columns or, on 16 ranks, the
    keys and queries of mLSTM's head (all-gather)."""
    _, port = runs(arch, mesh, "train")
    coll, issued = port["collectives"], port["issued"]
    assert {op: rec["count"] for op, rec in coll.items()} == issued, (coll, issued)
    assert all(rec["bytes"] > 0 for rec in coll.values()), coll
    assert port["collective_bytes_per_device"] == sum(r["bytes"] for r in coll.values())
    if mesh != "8x1":
        assert coll["all-reduce"]["count"] > 0
    if arch == ZAMBA and mesh != "8x1" or mesh == "1x16":
        assert coll["all-gather"]["count"] > 0
    if mesh == "1x16":                 # 4 ranks share each of mLSTM's 4 heads
        assert set(port["collective_bytes_by_ranks"]) == ({"16"} if arch == ZAMBA
                                                           else {"4", "16"})


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_decode_flops_per_rank_match_the_partitioned_reference(runs, arch):
    """The dense-cache decode step: equal on 8 x 1; on 2 x 4 within 5% of
    the reference's FLOPs a device, zamba2's shared attention core (one
    block, QK^T and PV for a data rank's rows) over the rank's quarter of
    the cache's sequence, as the reference's: equal within 1e-3 of the
    core."""
    ref, port = runs(arch, "8x1", "decode")
    assert abs(port["flops_per_device"] - ref["flops_per_device"]) \
        <= 1e-4 * ref["flops_per_device"]
    ref, port = runs(arch, "2x4", "decode")
    want, got = ref["flops_per_device"], port["flops_per_device"]
    rows, n, width = 4, 4, 32 * 80
    core = 2 * (2 * rows * CACHE * width) if arch == ZAMBA else 0
    print(f"{arch} decode on 2 x 4: port {got:.6g}, reference {want:.6g} FLOP a rank "
          f"({got / want:.6f}); the whole core {core:.6g}, the rank's share "
          f"{core / n:.6g}")
    assert abs(got - want) <= 0.05 * want, (got, want)
    if arch == ZAMBA:
        assert abs(got - want) <= 1e-3 * core, (got - want, core)
