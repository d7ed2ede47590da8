"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell.

The port's counterpart of the reference's ``launch/dryrun.py``. For each
cell it runs the step of one rank (rank 0) of a fake process group of 256
ranks, a (16, 16) ("data", "model") mesh, or 512, (2, 16, 16) ("pod",
"data", "model") (``torch.testing._internal.distributed.fake_pg``:
collectives return at once and move nothing), on that rank's pieces as
``meta`` tensors (fake CPU tensors under ``FakeTensorMode`` for the dehaze
step, which moves its inputs to the CPU): nothing is allocated, no card is
needed. That proves each rank's program is coherent: the shapes agree
and every collective is called on its group with the sizes the other
ranks use, the counterpart of "the SPMD partitioner accepts it". It
records the roofline inputs:

  - the per-rank argument bytes (params, moments, batch and cache shards)
    and the peak of live bytes during the step;
  - the op record (``opcost.OpRecorder``), saved gzipped beside the
    record so ``--reanalyze`` recomputes without rerunning, and from it
    (``opcost.cost_from_ops``) the FLOPs, HBM traffic and ring-derated
    collective bytes of a rank.

The roofline constants are the NVIDIA H100 SXM's datasheet figures (dense
bfloat16 tensor-core peak, HBM3 bandwidth, NVLink bandwidth a direction).
They make a model of the step, not a measurement of a card.

Each mesh size runs in a child process of its own (one fake group a
process), the two at once. Records go to ``results/dryrun_torch/`` (``--results-dir``
moves them).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--both-meshes] [--include-dehaze]
  python -m repro_torch.launch.dryrun --summary
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import gzip
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional

import torch

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# NVIDIA H100 SXM datasheet figures (per card).
PEAK_FLOPS = 989e12       # dense bfloat16 tensor-core FLOP/s
HBM_BW = 3.35e12          # HBM3 bytes/s
LINK_BW = 450e9           # NVLink bytes/s, one direction

ARG_NAMES = {"train": ("params", "moments", "batch"),
             "prefill": ("params", "tokens"),
             "decode": ("params", "cache", "tokens"),
             "sample": ("params", "inputs"),
             "serve": ("params", "images"),
             "dehaze": ("frames", "ids", "state")}


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def fake_production_mesh(multi_pod: bool = False, rank: int = 0):
    """The production mesh over a fake process group of 256 (512) ranks,
    this process being ``rank``; the group is made on the first call."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import production_mesh_spec
    shape, axes = production_mesh_spec(multi_pod)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


# The dehaze step moves its inputs to the mesh's device (the CPU here):
# its cells run on fake CPU tensors (FakeTensorMode), the others on meta
# tensors, which dispatch faster.
FAKE_CPU_KINDS = ("dehaze",)


def _local_args(arg, spec, sizes, device):
    """Data-free tensors of this rank's pieces of ``arg`` (meta tensors)
    placed by ``spec`` (its tree of spec tuples), on ``device`` (``"cpu"``
    under ``FakeTensorMode``)."""
    from repro_torch.models import common as cm
    if isinstance(arg, torch.Tensor):
        return torch.empty(cm.local_shape(arg.shape, spec, sizes),
                           dtype=arg.dtype, device=device)
    if dataclasses.is_dataclass(arg) and not isinstance(arg, type):
        return dataclasses.replace(arg, **{
            f.name: _local_args(getattr(arg, f.name), getattr(spec, f.name),
                                sizes, device) for f in dataclasses.fields(arg)})
    if isinstance(arg, dict):
        return {k: _local_args(v, spec[k], sizes, device) for k, v in arg.items()}
    if isinstance(arg, tuple) and hasattr(arg, "_fields"):
        return type(arg)(*(_local_args(v, s, sizes, device)
                           for v, s in zip(arg, spec)))
    raise TypeError(f"argument {type(arg)}")


def _tensor_leaves(tree):
    from repro_torch.launch.flops import map_tensors
    out = []
    map_tensors(out.append, tree)
    return out


def _analyze(rec: dict, ops) -> dict:
    """Fill the roofline fields of ``rec`` from the op record. Kept apart
    so --reanalyze can recompute them from the saved record."""
    from repro_torch.launch import opcost
    cost = opcost.cost_from_ops(ops)
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.traffic_bytes / HBM_BW
    collective_s = cost.collective_total / LINK_BW
    rec.update(
        hlo_flops_per_device=cost.flops,
        hlo_bytes_per_device=cost.traffic_bytes,
        collective_bytes_per_device=dict(cost.collective_bytes),
        collective_bytes_total=cost.collective_total,
        collective_calls=_count_calls(ops),
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=max((("compute", compute_s), ("memory", memory_s),
                        ("collective", collective_s)),
                       key=lambda kv: kv[1])[0],
    )
    return rec


def _count_calls(ops) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for op in ops:
        if len(op) > 3:
            out[op[3]] = out.get(op[3], 0) + 1
    return out


def _paths(results_dir, arch_id, shape_name, mesh_label):
    base = f"{arch_id}__{shape_name}__{mesh_label}"
    return (os.path.join(results_dir, base + ".json"),
            os.path.join(results_dir, "ops", base + ".json.gz"))


def _record_names(results_dir: str):
    """The cell records of ``results_dir`` (not the FLOPs cache)."""
    return [n for n in sorted(os.listdir(results_dir))
            if n.endswith(".json") and n != "model_flops.json"]


def reanalyze_all(results_dir: str = RESULTS_DIR) -> None:
    """Recompute the roofline fields from the saved op records."""
    n = 0
    for name in _record_names(results_dir):
        path = os.path.join(results_dir, name)
        with open(path) as f:
            rec = json.load(f)
        ops_path = os.path.join(results_dir, "ops", name[:-5] + ".json.gz")
        if rec.get("status") != "ok" or not os.path.exists(ops_path):
            continue
        with gzip.open(ops_path, "rt") as f:
            ops = json.load(f)
        _analyze(rec, ops)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    print(f"reanalyzed {n} records")


def _load_flops_cache(results_dir: str) -> dict:
    path = os.path.join(results_dir, "model_flops.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _save_flops_cache(results_dir: str, cache: dict) -> None:
    """``model_flops.json`` in ``results_dir``: a cell's model FLOPs,
    traced by the first mesh's process to reach it, are read by the
    other's."""
    path = os.path.join(results_dir, "model_flops.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1)
    os.replace(tmp, path)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
             force: bool = False, save: bool = True,
             overrides: Optional[dict] = None, variant: str = "",
             mesh=None, results_dir: str = RESULTS_DIR) -> dict:
    """One cell's record (cached on disk unless ``force``). ``mesh``: the
    ``DeviceMesh`` to run on (default: the production mesh over a fake
    group, made if there is none)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.cells import CellSkip, build_cell
    from repro_torch.launch.opcost import OpRecorder, tensor_bytes
    from repro_torch.models import common as cm
    label = (mesh_name(multi_pod) if mesh is None else
             "mesh" + "x".join(str(n) for n in cm.mesh_sizes(mesh).values()))
    label += f"__{variant}" if variant else ""
    os.makedirs(os.path.join(results_dir, "ops"), exist_ok=True)
    out_path, ops_path = _paths(results_dir, arch_id, shape_name, label)
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    rec = {"arch": arch_id, "shape": shape_name, "mesh": label,
           "status": "error"}
    t0 = time.time()
    try:
        mesh = mesh if mesh is not None else fake_production_mesh(multi_pod)
        sizes = cm.mesh_sizes(mesh)
        cache = _load_flops_cache(results_dir)
        n_cached = len(cache)
        try:
            cell = build_cell(arch_id, shape_name, mesh, overrides=overrides,
                              flops_cache=cache)
        except CellSkip as e:
            rec.update(status="skip", reason=str(e))
            if save:
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
            return rec
        if len(cache) > n_cached:
            _save_flops_cache(results_dir, cache)
        cell.step_fn.build()
        t_build = time.time() - t0
        recorder = OpRecorder()
        fake = cell.kind in FAKE_CPU_KINDS
        with (FakeTensorMode(allow_non_fake_inputs=True) if fake
              else contextlib.nullcontext()):
            local = tuple(_local_args(a, s, sizes, "cpu" if fake else "meta")
                          for a, s in zip(cell.args, cell.in_shardings))
            arg_bytes = {name: sum(tensor_bytes(t) for t in _tensor_leaves(a))
                         for name, a in zip(ARG_NAMES[cell.kind], local)}
            recorder.hold(_tensor_leaves(local))
            with recorder:
                cell.step_fn(*local)
        t_run = time.time() - t0 - t_build
        if save:
            with gzip.open(ops_path, "wt") as f:
                json.dump(recorder.ops, f)
        rec.update(
            status="ok",
            n_devices=math.prod(sizes.values()),
            kind=cell.kind,
            note=cell.note,
            steps_multiplier=cell.steps_multiplier,
            build_s=round(t_build, 2), run_s=round(t_run, 2),
            n_ops=len(recorder.ops),
            model_flops=float(cell.model_flops),
            model_matmul_flops=getattr(cell.model_flops, "matmul_flops", None),
            six_nd=cell.six_nd,
            memory_analysis={
                "argument_size_bytes": sum(arg_bytes.values()),
                "argument_bytes": arg_bytes,
                "peak_bytes": recorder.peak_bytes},
        )
        _analyze(rec, recorder.ops)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    if save:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def summary(results_dir: str = RESULTS_DIR) -> None:
    rows = []
    for name in _record_names(results_dir):
        with open(os.path.join(results_dir, name)) as f:
            rows.append(json.load(f))
    print(f"{'arch':26s} {'shape':12s} {'mesh':11s} {'status':7s} "
          f"{'bottleneck':10s} {'compute_s':>10s} {'memory_s':>10s} "
          f"{'coll_s':>10s} {'useful%':>8s} {'peakGB':>7s}")
    for r in rows:
        if r["status"] == "ok":
            useful = (100.0 * r["model_flops"] / r["hlo_flops_per_device"]
                      / r["n_devices"] if r["hlo_flops_per_device"] else 0.0)
            peak = (r["memory_analysis"]["peak_bytes"] or 0) / 1e9
            print(f"{r['arch']:26s} {r['shape']:12s} {r['mesh']:11s} "
                  f"{r['status']:7s} {r.get('bottleneck', ''):10s} "
                  f"{r['compute_s']:10.4g} {r['memory_s']:10.4g} "
                  f"{r['collective_s']:10.4g} {useful:8.1f} {peak:7.2f}")
        else:
            msg = r.get("reason") or r.get("error", "")
            print(f"{r['arch']:26s} {r['shape']:12s} {r['mesh']:11s} "
                  f"{r['status']:7s} {msg[:70]}")


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--include-dehaze", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (perf iteration); "
                         "repeatable. Adds a __<variant> suffix to the record.")
    ap.add_argument("--variant", default="",
                    help="label for the override variant record")
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute metrics from the saved op records")
    ap.add_argument("--results-dir", default=RESULTS_DIR,
                    help="where the records go (default results/dryrun_torch)")
    ap.add_argument("--one-mesh", choices=("single", "multi"),
                    help=argparse.SUPPRESS)       # the child of one mesh
    return ap.parse_args(argv)


def _cells(args):
    from repro_torch import configs as cfgreg
    if args.all:
        return cfgreg.all_cells(include_dehaze=args.include_dehaze)
    if not (args.arch and args.shape):
        raise SystemExit("--arch and --shape (or --all)")
    return [(args.arch, args.shape)]


def _overrides(args):
    if not args.override:
        return None
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    if not args.variant:
        args.variant = "-".join(f"{k}={v}" for k, v in overrides.items())
    return overrides


def _run_mesh(args) -> int:
    """The child of one mesh size: every cell on one fake group."""
    torch.set_num_threads(1)
    overrides = _overrides(args)
    multi_pod = args.one_mesh == "multi"
    failures = 0
    for arch_id, shape_name in _cells(args):
        rec = run_cell(arch_id, shape_name, multi_pod=multi_pod,
                       force=args.force, overrides=overrides,
                       variant=args.variant, results_dir=args.results_dir)
        status = rec["status"]
        extra = rec.get("reason") or rec.get("error", "")
        print(f"[{rec['mesh']}] {arch_id} x {shape_name}: {status} "
              f"({rec.get('wall_s', 0)}s) {extra[:100]}", flush=True)
        failures += status == "error"
    return 1 if failures else 0


def main(argv=None) -> int:
    args = _parse(argv)
    if args.reanalyze:
        reanalyze_all(args.results_dir)
        return 0
    if args.summary:
        summary(args.results_dir)
        return 0
    if args.one_mesh:
        return _run_mesh(args)
    _cells(args)                                  # checks the flags
    flops_path = os.path.join(args.results_dir, "model_flops.json")
    if args.force and os.path.exists(flops_path):
        os.remove(flops_path)                     # traced anew, once
    meshes = ["single", "multi"] if args.both_meshes else \
        ["multi" if args.multi_pod else "single"]
    argv = list(sys.argv[1:] if argv is None else argv)
    # One process a mesh (a process holds one fake process group), both
    # at once.
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                               *argv, "--one-mesh", m]) for m in meshes]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(main())
