"""Roofline analysis: the dry run's JSON -> a three-term table (port of
``repro/roofline/analysis.py``).

Per (arch x shape x mesh) cell, from one rank's census
(:mod:`repro_torch.roofline.census`):

    compute    = census FLOPs per rank / peak FLOP/s            [s]
    memory     = census bytes per rank / HBM bytes/s            [s]
    collective = sum over group sizes of the collective bytes
                 over that size's link rate                     [s]

MODEL_FLOPS is the analytic useful-work count (the reference's formula,
copied as it is); its ratio to the census total exposes remat, the full
score matrices of the causal attention and, on the archs that compute
replicated over 'model' (all but the dense decoders and the MoE family),
that replication.  Every number here is analytic: a
census of meta tensors over a fake world, for meshes of H100s that no run
has had.  The hardware model is one NVIDIA H100 SXM a rank, with the
rates below (each with its source).
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak (no sparsity)
PEAK_FLOPS = 989e12
# NVIDIA H100 SXM data sheet: HBM3, 80 GB at 3.35 TB/s
HBM_BW = 3.35e12
# NVLink 4 (NVIDIA H100 SXM data sheet, 900 GB/s both directions): 450 GB/s
# a direction between the GPUs of one 8-GPU HGX node
NVLINK_BW = 450e9
# NDR InfiniBand, 400 Gb/s a GPU (ConnectX-7): 50 GB/s a direction, for a
# group wider than one 8-GPU node
IB_BW = 50e9
NODE_GPUS = 8


def chips(mesh_name: str) -> int:
    return 512 if mesh_name == "multi" else 256


def link_bw(ranks: int) -> float:
    """The rate a collective over a group of ``ranks`` crosses: NVLink
    within a node of 8, InfiniBand across nodes."""
    return NVLINK_BW if ranks <= NODE_GPUS else IB_BW


def model_flops(arch: str, shape_name: str, *, cfg=None, batch: int | None = None,
                seq: int | None = None) -> float:
    """Analytic useful FLOPs per step (whole program, all chips); ``cfg``,
    ``batch`` and ``seq`` stand in for the arch's config and the shape's
    global batch and sequence length."""
    cfg = cfg or get_config(arch)
    shp = SHAPES[shape_name]
    b, s = batch or shp["global_batch"], seq or shp["seq_len"]
    n_act = cfg.active_params()
    if shp["kind"] == "train":
        tokens = b * s
        flops = 6.0 * n_act * tokens
        # attention quadratic term: 12 * L_attn * d_head_total * S^2 * B / 2
        flops += _attn_flops(cfg, b, s, train=True)
        return flops
    if shp["kind"] == "prefill":
        tokens = b * s
        return 2.0 * n_act * tokens + _attn_flops(cfg, b, s, train=False)
    if shp["kind"] == "decode":
        # one token per sequence, attention over the full cache
        return 2.0 * n_act * b + _attn_decode_flops(cfg, b, s)
    # decode_paged: attention over resident hot pages only
    from repro_torch.launch.specs import HOT_SLOTS, PAGE_T
    resident = min(HOT_SLOTS * PAGE_T, s)
    return 2.0 * n_act * b + _attn_decode_flops(cfg, b, resident)


def _n_attn_layers(cfg) -> int:
    kinds = cfg.pattern * cfg.n_groups
    n = sum(1 for k in kinds if "attn" in k or k in ("moe", "cross", "dec"))
    if cfg.moe:
        n += cfg.moe.n_dense_prologue
    return n


def _attn_flops(cfg, b, s, train: bool) -> float:
    mult = 3.0 if train else 1.0   # fwd + 2x bwd
    dh_tot = cfg.n_heads * cfg.head_dim
    if cfg.mla:
        dh_tot = cfg.n_heads * (cfg.mla.d_nope + cfg.mla.d_rope)
    per_layer = 2.0 * 2.0 * b * s * s / 2 * dh_tot   # QK^T + PV, causal half
    return mult * _n_attn_layers(cfg) * per_layer


def _attn_decode_flops(cfg, b, cache_len) -> float:
    dh_tot = cfg.n_heads * cfg.head_dim
    if cfg.mla:
        dh_tot = cfg.n_heads * (cfg.mla.d_nope + cfg.mla.d_rope)
    return 2.0 * 2.0 * b * cache_len * dh_tot * _n_attn_layers(cfg)


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_total: float
    useful_ratio: float
    hbm_gb_per_chip: float
    note: str = ""
    n_chips: int = 0          # ranks, when not the mesh name's

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute-time / bound — how close the USEFUL work runs to
        the hardware bound if perfectly overlapped."""
        n = self.n_chips or chips(self.mesh)
        useful_t = self.model_flops / n / PEAK_FLOPS
        return useful_t / max(self.step_time_lower_bound, 1e-12)


def row(arch: str, shape: str, mesh: str, census: dict, *, n: int | None = None,
        mf: float | None = None, peak_bytes: float = 0.0, note: str = "") -> RooflineRow:
    """One cell's three terms from one rank's census; ``n`` ranks (default
    ``chips(mesh)``), ``mf`` the model FLOPs (default :func:`model_flops`)."""
    n = chips(mesh) if n is None else n
    flops_dev = census.get("flops_per_device", 0.0)
    compute = flops_dev / PEAK_FLOPS
    memory = census.get("bytes_per_device", 0.0) / HBM_BW
    by_ranks = census.get("collective_bytes_by_ranks")
    if by_ranks is None:       # no breakdown: every byte over the slower link
        by_ranks = {str(NODE_GPUS + 1): census.get("collective_bytes_per_device", 0.0)}
    collective = sum(b / link_bw(int(r)) for r, b in by_ranks.items())
    mf = model_flops(arch, shape) if mf is None else mf
    total = flops_dev * n
    terms = {"compute": compute, "memory": memory, "collective": collective}
    return RooflineRow(
        arch=arch, shape=shape, mesh=mesh, compute_s=compute, memory_s=memory,
        collective_s=collective, dominant=max(terms, key=terms.get),
        model_flops=mf, hlo_flops_total=total, useful_ratio=mf / max(total, 1.0),
        hbm_gb_per_chip=peak_bytes / 1e9, note=note, n_chips=n)


def analyze(results: dict) -> list[RooflineRow]:
    rows = []
    for key, rec in sorted(results.items()):
        if rec.get("status") != "ok":
            continue
        rows.append(row(rec["arch"], rec["shape"], rec["mesh"], rec.get("census", {}),
                        peak_bytes=rec.get("memory", {}).get("peak_bytes", 0),
                        note=rec.get("variant") or ""))
    return rows


def to_markdown(rows: list[RooflineRow]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | HBM GB/chip | useful/HLO | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    body = ""
    for r in rows:
        mesh = f"{r.mesh} ({r.note})" if r.note else r.mesh
        body += (f"| {r.arch} | {r.shape} | {mesh} | {r.compute_s:.3e} | "
                 f"{r.memory_s:.3e} | {r.collective_s:.3e} | **{r.dominant}** | "
                 f"{r.hbm_gb_per_chip:.1f} | {r.useful_ratio:.2f} | "
                 f"{r.roofline_fraction:.2f} |\n")
    return hdr + body


def main():
    import argparse
    ap = argparse.ArgumentParser(
        description="Three-term roofline table from a dry run's JSON "
                    "(analytic: meta tensors over a fake world of H100s)")
    ap.add_argument("--results", default="dryrun_results.json")
    ap.add_argument("--md", default=None)
    args = ap.parse_args()
    with open(args.results) as f:
        results = json.load(f)
    md = to_markdown(analyze(results))
    print(md)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md)


if __name__ == "__main__":
    main()
