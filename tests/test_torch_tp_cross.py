"""Tensor parallelism over 'model' for the cross-attention archs against the
reference's partitioned program: per-rank FLOPs of the same step on the
same meshes (``tests/test_torch_tp.py``'s method, in a file of its own so
that the suite's workers can run the two at once).

llama-3.2-vision-11b (4 ``attn`` blocks and a gated ``cross`` block over
1,601 patch embeddings) and whisper-base (2 encoder layers over 1,500
frames, then one ``dec`` group) at full width, a 4,096-token vocab, the
default ``TrainConfig()``, a batch of (world size) rows of 256 tokens and
their ``aux_embeds`` (bf16, split over the data axes as the reference's
``batch_shardings(cfg, mesh, True)``).  whisper keeps a ``dec`` group: with
none, nothing reads the encoder's output, the loss takes no gradient
through the encoder, and the reference's program drops the encoder's
backward.  The subprocesses run at once: the reference lowered and
compiled by XLA over 8 and 16 forced host devices, each compiled program
read by ``repro.roofline.census``, and the port as rank 0 of a fake world
of 8 or 16 ranks on meta tensors under ``repro_torch.roofline.census``,
with every ``torch.distributed`` collective it issues counted beside the
census.

Held: the train step's FLOPs a rank within 1e-4 of the reference's a
device on 8 x 1 and within 5% on 2 x 4 and 1 x 16 (before the partitioned
cross and encoder forms both archs' were 4.000x and 16.000x); every
collective the port issues over more than one rank in its census; the
dense-cache decode with ``aux_embeds`` (a 512-token cache) on 2 x 4 equal
to the reference's within 1e-3 of the self-attention cores: each core
attends over the rank's block of the sequence-split cache, as the
reference's partitioned core (the cross step's core splits by heads
there).
"""
import textwrap

import pytest

torch = pytest.importorskip("torch")

from test_torch_tp import CACHE, PORT_BODY, REFERENCE_BODY, start_runs  # noqa: E402

VISION, WHISPER = "llama-3.2-vision-11b", "whisper-base"
TRAIN_CELLS = [(arch, mesh) for arch in (VISION, WHISPER) for mesh in ("8x1", "2x4", "1x16")]
DECODE_CELLS = [(VISION, "2x4"), (WHISPER, "2x4")]

PRELUDE = textwrap.dedent("""
    import dataclasses, json, os, sys
    CACHE = %d

    def config(get_config, arch):
        # one pattern deep behind 2 encoder layers (whisper), the vocab cut
        base = get_config(arch)
        enc = min(base.encoder_layers, 2)
        return dataclasses.replace(base, n_layers=enc + len(base.pattern),
                                   encoder_layers=enc, vocab=4096)

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


@pytest.mark.parametrize("arch,mesh", TRAIN_CELLS, ids=_ids(TRAIN_CELLS))
def test_every_collective_the_port_issues_is_in_its_census(runs, arch, mesh):
    """Every collective over more than one rank, by op: the census's count
    equals the calls the port made, with bytes; over 'model' the step sums
    the row-parallel parts (all-reduce); on 16 ranks the attention cores
    whose heads do not divide exchange their query rows (all-to-all), and
    whisper's encoder, whose 1,500 frames do not divide either, sums each
    head's q . k over its two ranks (an all-reduce over 2)."""
    _, port = runs(arch, mesh, "train")
    coll, issued = port["collectives"], port["issued"]
    assert {op: rec["count"] for op, rec in coll.items()} == issued, (coll, issued)
    assert all(rec["bytes"] > 0 for rec in coll.values()), coll
    assert port["collective_bytes_per_device"] == sum(r["bytes"] for r in coll.values())
    if mesh != "8x1":
        assert coll["all-reduce"]["count"] > 0
    if mesh == "1x16":
        assert coll["all-to-all"]["count"] > 0
        assert set(port["collective_bytes_by_ranks"]) == ({"16"} if arch == VISION
                                                           else {"2", "16"})


@pytest.mark.parametrize("arch", [VISION, WHISPER])
def test_decode_flops_per_rank_match_the_partitioned_reference(runs, arch):
    """The dense-cache decode step over ``aux_embeds`` on 2 x 4: within 5%
    of the reference's FLOPs a device, and no more over it than 1e-3 of the
    self-attention cores (QK^T and PV over the cache for a data rank's rows
    in every block, a ``cross`` block's too): each rank attends over its
    block of the sequence-split cache; the cross step's projections of
    every ``aux_embeds`` position and its core split by heads as the
    reference's."""
    ref, port = runs(arch, "2x4", "decode")
    want, got = ref["flops_per_device"], port["flops_per_device"]
    rows, n = 4, 4
    layers, width = (5, 32 * 128) if arch == VISION else (1, 8 * 64)
    core = layers * 2 * (2 * rows * CACHE * width)
    extra = got - want
    print(f"{arch} decode on 2 x 4: port {got:.6g}, reference {want:.6g} FLOP a rank "
          f"({got / want:.6f}); over by {extra:.6g}, the self-attention cores "
          f"{core:.6g}, a rank's share {core / n:.6g}")
    assert abs(got - want) <= 0.05 * want, (got, want)
    assert abs(extra) <= 1e-3 * core, (extra, core)
