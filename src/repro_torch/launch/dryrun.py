"""Dry run of every (arch x shape x mesh) cell: one rank's step counted on
the meta device, nothing allocated (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for a 512-device host
platform and reads the cost out of the HLO; the port runs the cell's
step once on meta stand-ins under ``launch.op_cost.OpCounter``
(``launch.steps.count_cell``) on a ``parallel.comm.DryMeshAxes`` of the
production mesh, (16,16) or (2,16,16), as its rank (0, 0[, 0]) sees it.
Each cell's JSON (under ``DRYRUN_DIR``, default ``experiments/dryrun_torch``)
records this rank's ``flops_per_device``, ``bytes_per_device`` (unfused
eager traffic: an upper bound), ``collective_bytes_per_device`` (by kind,
by axis and ``total``), the argument bytes (its shards of params,
optimizer moments and caches: exact), the live-bytes peak of the run,
``fits_hbm_80g``, ``model_flops`` and ``model_vs_counted_flops``, and the
roofline on H100 SXM constants; a decode cell also its
``memory_floor_s``.  A cell whose model the port cannot split over the
mesh's model axis (``parallel.sharding.check_model_axis``: a move of
``fit_spec`` the model code does not follow, ROADMAP queue 1 item 4g;
no registered arch's cell at (16,16) or (2,16,16)) is recorded as
``"refused"`` with the check's message; a run whose cells are all ok,
skipped or refused exits 0, one with an error 1.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-next-gdn \\
      --shape decode_32k --mesh single
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, as_completed
from types import SimpleNamespace

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.core import intensity
from repro_torch.launch import steps as steps_mod
from repro_torch.parallel import sharding as sharding_mod

RESULTS_DIR = os.environ.get("DRYRUN_DIR", "experiments/dryrun_torch")

# H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU datasheet): the roofline's
# denominators
PEAK_FLOPS = 989e12        # dense BF16 tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 B/s
HBM_BYTES = 80e9           # HBM3 capacity
NVLINK_BW = 450e9          # NVLink 4, B/s per direction (900 GB/s total)
NODE_CARDS = 8             # cards that one NVLink domain (an HGX node) joins
NET_BW = 50e9              # one 400 Gb/s NDR InfiniBand port per card, B/s


def production_mesh(multi_pod: bool) -> SimpleNamespace:
    """The reference's production mesh as a stand-in (``axis_names``,
    ``shape``): 16x16, or 2x16x16 with a leading pod axis."""
    if multi_pod:
        return SimpleNamespace(axis_names=("pod", "data", "model"),
                               shape={"pod": 2, "data": 16, "model": 16})
    return SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 16, "model": 16})


def link_bw(mesh, axis: str) -> float:
    """B/s of one mesh axis's collectives: NVLink where its ranks (devices
    in row-major mesh order, ``NODE_CARDS`` to a node) share a node, the
    card's network port where the axis spans nodes."""
    sizes = sharding_mod.mesh_sizes(mesh)
    names = list(sizes)
    stride = math.prod(sizes[n] for n in names[names.index(axis) + 1:])
    return NVLINK_BW if stride * sizes[axis] <= NODE_CARDS else NET_BW


def model_flops(cfg, shape) -> float:
    """Analytic 'useful' FLOPs for the cell (6*N*D train / 2*N_active per
    generated or prefilled token; MoE counts active params only)."""
    n_active = sharding_mod.estimate_params(cfg)
    if cfg.moe_experts:
        # replace full expert count with the active top-k experts
        expert = 3 * cfg.d_model * cfg.d_ff
        n_active -= cfg.n_layers * cfg.moe_experts * expert
        n_active += cfg.n_layers * cfg.moe_top_k * expert
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n_active * tokens


def memory_floor_s(cfg, shape: ShapeConfig, mesh, param_bytes: int
                   ) -> float:
    """A decode step's least HBM time on one device: the batch's rows on
    this device times the batch-1 decode profile's bytes
    (``intensity.arch_decode_profile`` at the cell's length), split over
    the model axis, plus this device's weights read once, over
    ``HBM_BW``."""
    sizes = {} if mesh is None else sharding_mod.mesh_sizes(mesh)
    dp = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
    rows = shape.global_batch // dp if shape.global_batch % dp == 0 \
        else shape.global_batch
    prof = intensity.arch_decode_profile(cfg, seq=shape.seq_len)
    return (rows * prof.total_bytes / sizes.get("model", 1)
            + param_bytes) / HBM_BW


def cell_result(cfg, shape: ShapeConfig, mesh, mesh_name: str) -> dict:
    """Count one applicable cell on one rank of ``mesh``."""
    n_chips = math.prod(sharding_mod.mesh_sizes(mesh).values())
    cost = steps_mod.count_cell(cfg, shape, mesh)
    flops, bytes_acc = cost["flops"], cost["bytes"]
    coll = dict(cost["collectives"])
    by_axis = cost["collectives_by_axis"]
    mflops = model_flops(cfg, shape)
    r = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_acc / HBM_BW,
         "collective_s": sum(b / link_bw(mesh, a)
                             for a, b in by_axis.items())}
    r["dominant"] = max(r, key=r.get)
    args = cost["argument_bytes"]
    result = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "n_chips": int(n_chips),
        "count_s": round(cost["seconds"], 1), "ops": cost["ops"],
        "microbatches": cost["microbatches"],
        "memory": {"argument_bytes": args, "peak_bytes": cost["peak_bytes"]},
        "fits_hbm_80g": bool(cost["peak_bytes"] < HBM_BYTES),
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "bytes_are": "unfused eager traffic (torch fuses nothing): an "
                     "upper bound",
        "collective_bytes_per_device": dict(coll, by_axis=by_axis),
        "model_flops": mflops,
        "model_vs_counted_flops": (mflops / (flops * n_chips)
                                   if flops else 0.0),
        "roofline": r,
    }
    if shape.kind == "decode":
        result["memory_floor_s"] = memory_floor_s(cfg, shape, mesh,
                                                  args["params"])
    return result


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    cfg = configs.get_arch(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        return dict(head, status="skipped", reason=why)
    mesh = production_mesh(multi_pod)
    try:
        steps_mod.check_cell(cfg, shape, mesh)
    except ValueError as e:
        return dict(head, status="refused", reason=str(e))
    return cell_result(cfg, shape, mesh, mesh_name)


def cell_path(arch, shape_name, multi_pod):
    mesh = "multi" if multi_pod else "single"
    return os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{mesh}.json")


def _run_and_save(arch: str, shape_name: str, multi_pod: bool) -> dict:
    tag = f"{arch} x {shape_name} x {'multi' if multi_pod else 'single'}"
    t0 = time.time()
    try:
        res = run_cell(arch, shape_name, multi_pod)
    except Exception as e:   # noqa: BLE001
        res = {"arch": arch, "shape": shape_name,
               "mesh": "multi" if multi_pod else "single",
               "status": "error", "error": str(e)[-4000:],
               "traceback": traceback.format_exc()[-6000:]}
    with open(cell_path(arch, shape_name, multi_pod), "w") as f:
        json.dump(res, f, indent=1)
    res["tag"], res["wall_s"] = tag, time.time() - t0
    return res


def _report(res: dict):
    tag = res["tag"]
    if res["status"] == "ok":
        r = res["roofline"]
        floor = (f" floor {res['memory_floor_s'] * 1e3:.3f}ms"
                 if "memory_floor_s" in res else "")
        print(f"[ok] {tag}: compute {r['compute_s'] * 1e3:.2f}ms memory "
              f"(unfused) {r['memory_s'] * 1e3:.2f}ms collective "
              f"{r['collective_s'] * 1e3:.2f}ms -> {r['dominant']}{floor}"
              f" (peak {res['memory']['peak_bytes'] / 1e9:.2f} GB, counted "
              f"in {res['wall_s']:.1f}s)", flush=True)
    elif res["status"] == "error":
        print(f"[FAIL] {tag}: {res['error'][-300:]}", flush=True)
    else:
        print(f"[{res['status']}] {tag}: {res['reason'][:160]}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, each in its own process")
    args = ap.parse_args()

    archs = sorted(configs.ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(RESULTS_DIR, exist_ok=True)
    todo = []
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                path = cell_path(arch, shape_name, multi_pod)
                if os.path.exists(path) and not args.force:
                    print(f"[skip cached] {path}")
                    continue
                todo.append((arch, shape_name, multi_pod))
    failures = 0
    if args.jobs > 1:
        # the longest cells first: train, then prefill, then decode
        todo.sort(key=lambda c: ("train", "prefill", "decode").index(
            SHAPES[c[1]].kind))
        with ProcessPoolExecutor(args.jobs) as pool:
            for fut in as_completed([pool.submit(_run_and_save, *c)
                                     for c in todo]):
                res = fut.result()
                failures += res["status"] == "error"
                _report(res)
    else:
        for cell in todo:
            print(f"[dryrun] {cell[0]} x {cell[1]} x "
                  f"{'multi' if cell[2] else 'single'} ...", flush=True)
            res = _run_and_save(*cell)
            failures += res["status"] == "error"
            _report(res)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
