"""Dry run: every (arch x shape x mesh) cell once, on meta tensors, as one
rank of a fake world of 256 or 512 ranks (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 512 placeholder host
devices and reads XLA's analyses.  Here one process plays rank 0 of the
production mesh: ``torch.distributed``'s fake process group (from
``torch.testing._internal.distributed.fake_pg``: every collective returns
at once and moves nothing) carries a world of 256 (``single``, 16 x 16) or
512 (``multi``, 2 x 16 x 16) ranks, the mesh is built over it on
``"cpu"`` (:func:`repro_torch.launch.mesh.make_production_mesh`), every
tensor of the cell is a meta tensor (shapes and dtypes, no storage), and
the cell's callable (:func:`repro_torch.launch.specs.cell_specs`) runs
once under a census (:mod:`repro_torch.roofline.census`).  Nothing touches
a device: the numbers are analytic, for meshes of H100s no run has had.

Per cell it records ``status``, the rank's argument bytes and peak live
bytes (``memory``), the census (FLOPs, bytes, collectives per op and per
group size, the kernels reached), and the wall seconds, in the
reference's JSON schema; :mod:`repro_torch.roofline.analysis` reads it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k --mesh single                                  # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out results.json
  PYTHONPATH=src python -m repro_torch.roofline.analysis --results results.json
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch.distributed as dist


def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake world of ``n`` ranks (a world of
    another size is torn down first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(arch: str, shape: str, mesh, mesh_name: str, out: dict,
             variant: str | None = None) -> None:
    """One cell over ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh` of
    the fake world) into ``out[key]``."""
    from repro_torch.launch.specs import cell_specs
    from repro_torch.roofline.census import census

    key = f"{arch}|{shape}|{mesh_name}" + (f"|{variant}" if variant else "")
    t0 = time.time()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "variant": variant}
    try:
        spec = cell_specs(arch, shape, mesh, variant=variant)
        if "skip" in spec:
            rec["status"] = "skipped"
            rec["reason"] = spec["skip"]
            out[key] = rec
            print(f"SKIP {key}: {spec['skip'][:60]}")
            return
        t_r = time.time()
        _, counts = census(spec["fn"], *spec["args"])
        rec["run_s"] = round(time.time() - t_r, 1)
        rec["memory"] = {"argument_bytes": counts.pop("argument_bytes"),
                         "peak_bytes": counts["peak_bytes"]}
        rec["collectives"] = counts["collectives"]
        rec["census"] = counts
        rec["status"] = "ok"
        rec["total_s"] = round(time.time() - t0, 1)
        print(f"OK   {key} (run {rec['run_s']}s, "
              f"{counts['flops_per_device']:.3e} FLOP/rank)")
    except Exception as e:  # noqa: BLE001 — record and continue
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"FAIL {key}: {rec['error'][:200]}")
    out[key] = rec


def main(argv=None) -> None:
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import list_archs
    from repro_torch.launch.mesh import make_production_mesh, production_shape
    from repro_torch.launch.specs import VARIANTS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--append", action="store_true",
                    help="merge into existing --out file")
    ap.add_argument("--variant", default=None, choices=VARIANTS,
                    help="perf-pass variant")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    out: dict = {}
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)

    t0 = time.time()
    for multi in meshes:
        fake_world(production_shape(multi_pod=multi).size)
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        for arch in archs:
            for shape in shapes:
                run_cell(arch, shape, mesh, "multi" if multi else "single", out,
                         variant=args.variant)
                with open(args.out, "w") as f:   # checkpoint after each cell
                    json.dump(out, f, indent=1)
    if dist.is_initialized():
        dist.destroy_process_group()

    n_ok = sum(1 for r in out.values() if r["status"] == "ok")
    n_skip = sum(1 for r in out.values() if r["status"] == "skipped")
    n_err = sum(1 for r in out.values() if r["status"] == "error")
    print(f"\ndry-run complete: {n_ok} ok / {n_skip} skipped / {n_err} failed "
          f"in {time.time() - t0:.1f} s -> {args.out}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
