"""The multi-device dry run (counterpart of ``repro/launch/dryrun.py``):
every (arch x input shape) on the production meshes, each step run once
on fake tensors laid out as DTensors, with its per-device memory, FLOPs,
bytes and collective bytes counted.

Nothing is allocated and no kernel launches: the mesh's process group is
the ``fake`` one (``launch/mesh.py``), the tensors are a
``FakeTensorMode``'s, and the attention kernels run as their custom ops'
fake implementations (``kernels/registered.py``).  ``--device cuda`` (the
default) makes the fake tensors CUDA tensors, the path the card takes;
``--device cpu`` the CPU's.  The counters (``launch/comm_stats.py``) see
each rank's shards, as the reference's per-device HLO does.

The reference corrects XLA's cost analysis, which counts a scanned layer
stack's body once, by lowering 1- and 2-layer clones
(``corrected_costs``).  The port runs its layers as a Python loop, and
the counters see every layer's ops: there is nothing to correct, and no
``corrected`` field.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape decode_32k [--mode hcmp|megatron] [--variant verify16]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--mesh single|multi|both]
Results: one JSON per case under results/torch/dryrun/ (``--out`` to
write elsewhere); a case already there is read back unless ``--force``.
A failing case is recorded with its traceback and the sweep goes on; the
CLI exits 1 if any case failed.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch.cases import VARIANTS, build_case, supports

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch" / \
    "dryrun"


def case_path(out_dir, arch, shape_name, mesh_tag, mode, variant):
    vtag = "" if variant == "baseline" else f"__{variant}"
    return Path(out_dir) / f"{arch}__{shape_name}__{mesh_tag}__{mode}" \
        f"{vtag}.json"


def measure(case, mesh):
    """Run the case's step once under ``StepCounters`` in the fake mode
    its tensors belong to.  Returns the record's measured fields."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.comm_stats import StepCounters, local_bytes
    args = case["args"]
    c = StepCounters(mesh, case["fake_mode"])
    # implicit replication: the model's shape-derived constants (RoPE
    # frequencies, masks, tree depths) are alike on every rank
    with implicit_replication(), c:
        out = case["step"](*args)
    arg_bytes = local_bytes(args)
    out_bytes = c.live_storages(out)
    return dict(
        memory={"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                "temp_bytes": max(c.peak_live - out_bytes, 0),
                "peak_bytes": arg_bytes + max(c.peak_live, out_bytes)},
        flops=c.flops, bytes_accessed=c.bytes,
        collectives=c.collective_bytes(),
        collectives_by_mesh_dim=c.collective_bytes_by_mesh_dim(),
        op_histogram=c.op_histogram())


def run_case(arch, shape_name, *, multi_pod=False, mode="hcmp",
             variant="baseline", out_dir=None, force=False, verbose=True,
             device="cuda"):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import mesh as mesh_lib
    out_dir = Path(out_dir or RESULTS)
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_tag = "multi" if multi_pod else "single"
    fname = case_path(out_dir, arch, shape_name, mesh_tag, mode, variant)
    if fname.exists() and not force:
        return json.loads(fname.read_text())

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, why = supports(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "mode": mode, "variant": variant, "device": device,
           "torch_version": torch.__version__}
    if not ok:
        rec.update(status="skipped", reason=why)
        _save(fname, rec)
        return rec

    t0 = time.perf_counter()
    try:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device_type=device)
        with FakeTensorMode() as fake:
            case = build_case(arch, shape_name, mesh, mode=mode,
                              variant=variant, device=device)
            case["fake_mode"] = fake
            t_build = time.perf_counter() - t0
            stats = measure(case, mesh)
        rec.update(status="ok", build_s=round(t_build, 2),
                   run_s=round(time.perf_counter() - t0 - t_build, 2),
                   **stats, n_devices=mesh.size(),
                   model_params=cfg.param_count(),
                   model_params_active=cfg.active_param_count())
    except Exception as e:  # noqa: BLE001 - record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000],
                   traceback=traceback.format_exc()[-4000:])
    finally:
        mesh_lib.release_fake_group()
    _save(fname, rec)
    if verbose:
        s = rec["status"]
        extra = (f" flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e}"
                 f" coll={rec['collectives']['total']:.3e}"
                 f" peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB"
                 f" ({time.perf_counter() - t0:.1f}s)"
                 if s == "ok" else " " + rec.get("reason",
                                                 rec.get("error", "")))
        print(f"[dryrun] {arch} x {shape_name} x {mesh_tag}/{mode}"
              f"{'' if variant == 'baseline' else '/' + variant}: {s}{extra}",
              flush=True)
    return rec


def _run_job(kw):
    return run_case(**kw)


def _save(fname, rec):
    fname.write_text(json.dumps(rec, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="hcmp", choices=["hcmp", "megatron"])
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the fake tensors (cpu: the CPU's path)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cases run at once, each in a process of its own")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs(
        include_paper_model=False)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if not (args.all or (args.arch and args.shape)):
        ap.error("pass --arch and --shape, or --all")
    if args.device == "cuda":
        from repro_torch.devices import resolve_device
        resolve_device("cuda")

    t0 = time.perf_counter()
    jobs = [dict(arch=arch, shape_name=shape, multi_pod=mp, mode=args.mode,
                 variant=args.variant, out_dir=args.out, force=args.force,
                 device=args.device)
            for arch in archs for shape in shapes for mp in meshes]
    if args.jobs > 1:
        # the largest cases first, so the last ones to finish are small
        jobs.sort(key=lambda j: (INPUT_SHAPES[j["shape_name"]].kind
                                 == "decode",
                                 -get_config(j["arch"]).param_count()))
        import concurrent.futures as cf
        import multiprocessing
        with cf.ProcessPoolExecutor(
                args.jobs,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            recs = list(pool.map(_run_job, jobs))
    else:
        recs = [_run_job(j) for j in jobs]
    n_fail = sum(r["status"] == "error" for r in recs)
    n_ok = len(recs) - n_fail
    print(f"[dryrun] done: {n_ok} ok/skipped, {n_fail} failed in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
