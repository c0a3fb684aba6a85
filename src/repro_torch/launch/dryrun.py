"""The multi-pod dry run (port of ``repro/launch/dryrun.py``): every
(arch x input-shape) cell traced shape-only on the production meshes,
with its per-device work, memory and roofline terms on the H100.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--replication none|pod|split]
        [--out FILE.json] [--report]

A cell builds the model on ``meta`` in a one-process world of 512 fake
ranks (``launch.mesh.fake_world``: the counterpart of the reference's
512 forced host devices), places every parameter, optimizer moment, input
and cache as a DTensor by ``distributed/sharding.py`` on the 16 x 16,
2 x 16 x 16 or 2 x 8 x 16 mesh, and runs the train, prefill or decode
step under ``launch/op_cost.py``'s counter. Nothing runs a step of real
numbers: the meta build is the dry run's design, as lowering on forced
host devices is the reference's, and no route to a kernel or its plain
version is taken (``kernels/meta.py`` stands in for the kernels). The
repeated units (layers, groups, the xLSTM's sequence loops) are traced at
1 and 2 and extrapolated exactly (``op_cost.extrapolate``), so a cell
takes a few small traces whatever its depth.

Each cell prints the reference's line and JSON fields (``terms``:
``launch/roofline.py``'s ``RooflineTerms``); where the reference reports
``lower_s`` / ``compile_s`` the port reports ``trace_s``. Each cell
also records the torch release it ran on (``torch``) and names the terms
that follow DTensor's plans (``plan_dependent``): on a mesh, which
strategy DTensor picks and which ops it cannot place (gathered, then
computed whole on each device) differ between releases, and move the
bytes, the collectives and even the per-device FLOPs. A count on one
device (``one_device=True``) takes no plan: it is the one that
``chip_smoke.py`` holds to the card's, FLOP for FLOP.
``memory_per_device`` holds the exact argument bytes (the local shards of
the parameters, the optimizer state, the inputs and the cache), the
output and aliased (donated) bytes, and ``temp``, an estimate: the most
live bytes the traced step made, extrapolated like the counts
(``temp_basis`` says so); ``generated_code`` is None (eager ops, no
generated program). ``--report`` prints the 16 x 16 table of
``benchmarks/roofline_report.py`` and its choice of hill-climb cells.

``lower_cell(..., one_device=True)`` traces the step on one device without
DTensor (a 1 x 1 mesh): what ``chip_smoke.py`` holds against a real step's
count on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.context import use_batch_axes
from repro_torch.kernels import meta as kernel_meta
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as rl
from repro_torch.launch import step_fns
from repro_torch.launch.mesh import (activate_mesh, fake_world,
                                     make_production_mesh,
                                     make_replica_split_mesh)
from repro_torch.models import api as model_api
from repro_torch.models import trips as trips_lib
from repro_torch.optim import adamw

WORLD = 512
META = torch.device("meta")
# the terms of a cell on a mesh that follow DTensor's plans, which differ
# between torch releases: which ops it gathers and computes whole on each
# device moves even the FLOPs. A count on one device takes no plan
PLAN_DEPENDENT = ("flops_per_device", "compute_s", "useful_ratio",
                  "bytes_per_device", "bytes_per_device_ub", "bytes_by_op",
                  "memory_s", "memory_ub_s", "collective_bytes_per_device",
                  "collective_breakdown", "collective_s", "dominant",
                  "bound_time_s", "roofline_fraction")


def mesh_name(multi_pod: bool, replication: str) -> str:
    return ("replica-split" if replication == "split" else
            ("2x16x16" if multi_pod else "16x16"))


# -- the repeated units ------------------------------------------------------

def unit_counts(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, int]:
    """{unit: how many} of a cell: the stack's layers (groups for the VLM,
    the hybrid and the xLSTM; the encoder and decoder stacks for audio)
    and, for the xLSTM's train and prefill, its loops over the sequence
    (mLSTM chunks, sLSTM tokens)."""
    if cfg.family == "vlm":
        return {"groups": cfg.n_layers // cfg.cross_attn_every}
    if cfg.family == "hybrid":
        return {"groups": cfg.n_layers // cfg.attn_every,
                "tail": cfg.n_layers % cfg.attn_every}
    if cfg.family == "audio":
        return {"enc": cfg.n_encoder_layers, "dec": cfg.n_layers}
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import CHUNK
        out = {"groups": cfg.n_layers // cfg.slstm_every}
        if shape.kind != "decode":
            s = shape.seq_len
            out.update(mlstm=s // min(CHUNK, s), slstm=s)
        return out
    return {"layers": cfg.n_layers}


def cut(cfg: ModelConfig, counts: Dict[str, int]) -> ModelConfig:
    """``cfg`` with its stacks cut to ``counts``' layers."""
    if cfg.family == "vlm":
        return dataclasses.replace(
            cfg, n_layers=counts["groups"] * cfg.cross_attn_every)
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, n_layers=counts["groups"] * cfg.attn_every
            + counts["tail"])
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_encoder_layers=counts["enc"],
                                   n_layers=counts["dec"])
    if cfg.family == "ssm":
        return dataclasses.replace(
            cfg, n_layers=counts["groups"] * cfg.slstm_every)
    return dataclasses.replace(cfg, n_layers=counts["layers"])


# -- placing tensors on the mesh ---------------------------------------------

class LogicalMesh:
    """A mesh's axis names and sizes, for the rules: the production mesh
    as the reference names it, whichever ``DeviceMesh`` holds the
    tensors."""

    def __init__(self, names, shape):
        self.mesh_dim_names = tuple(names)
        self.mesh = torch.empty(tuple(shape), device=META)


def device_meshes(multi_pod: bool, replication: str):
    """(the ``DeviceMesh`` the dry run places tensors on, the production
    mesh's ``LogicalMesh``): on the multi-pod mesh with the batch over
    both pods, its ``pod`` and ``data`` dims flattened into one,
    ``pod+data`` (the same 512 ranks and the same placements; DTensor
    plans a 3-D mesh's redistributes ~50x slower)."""
    if replication == "split":
        mesh = make_replica_split_mesh()
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    logical = LogicalMesh(mesh.mesh_dim_names, mesh.mesh.shape)
    if multi_pod and replication == "none":
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            mesh["pod", "data"]._flatten("pod+data")
            mesh = mesh["pod+data", "model"]
    return mesh, logical


class _Placer:
    """Meta DTensors of given global shapes and specs on ``mesh`` (plain
    meta tensors when ``mesh`` is None); ``sizes``: the logical axes'."""

    def __init__(self, mesh, logical=None):
        self.mesh = mesh
        ref = logical if logical is not None else mesh
        self.sizes = sharding.mesh_axes(ref) if ref is not None else {}

    def __call__(self, shape, dtype, spec, requires_grad=False):
        shape = tuple(shape)
        if self.mesh is None:
            return torch.empty(shape, dtype=dtype, device=META)
        from torch.distributed.tensor import DTensor
        local = torch.empty(sharding.local_shape(shape, spec, self.sizes),
                            dtype=dtype, device=META)
        t = DTensor.from_local(local, self.mesh,
                               sharding.placements(spec, self.mesh),
                               run_check=False, shape=torch.Size(shape),
                               stride=torch.empty(shape, device=META)
                               .stride())
        return t.requires_grad_(requires_grad)

    def local_bytes(self, shape, dtype, spec) -> int:
        n = 1
        for d in sharding.local_shape(shape, spec, self.sizes):
            n *= d
        return n * torch.empty((), dtype=dtype).element_size()


def _param_specs(model, mesh) -> Dict[str, tuple]:
    shapes = {k: tuple(p.shape) for k, p in model.state_dict().items()}
    if mesh is None:
        return {k: (None,) * len(s) for k, s in shapes.items()}
    return sharding.param_pspecs(shapes, mesh)


def _place_module(model, mesh, place):
    """Replace every parameter of ``model`` by a placed meta DTensor."""
    specs = _param_specs(model, mesh)
    for name, p in list(model.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        owner._parameters[leaf] = torch.nn.Parameter(
            place(p.shape, p.dtype, specs[name]), requires_grad=False)


def input_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """{name: (global shape, dtype)} of the step's inputs, as the
    reference's ``input_specs``."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if shape.kind == "decode":
        return {"tokens": ((b, 1), torch.int32), "pos": ((b, 1), torch.int32)}
    out = {"tokens": ((b, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = ((b, s), torch.int32)
    if cfg.family == "audio":
        out["frames"] = ((b, cfg.n_frames, cfg.d_model), dt)
    if cfg.family == "vlm":
        out["image_embeds"] = ((b, cfg.n_image_tokens, cfg.d_model), dt)
    return out


def _input_spec(sh, logical, replication):
    return sharding.input_pspec(sh, logical, replication) \
        if logical is not None else (None,) * len(sh)


def _inputs(cfg: ModelConfig, shape: ShapeConfig, logical, place,
            replication: str) -> dict:
    """The step's inputs placed by ``input_pspec``."""
    return {k: place(sh, dt, _input_spec(sh, logical, replication))
            for k, (sh, dt) in input_shapes(cfg, shape).items()}


def _place_cache(cache, logical, place, global_batch, replication):
    """The cache tree with each tensor replaced by a placed meta DTensor;
    and its local bytes."""
    specs = (sharding.cache_pspecs(cache, logical, global_batch,
                                   replication)
             if logical is not None else
             {p: (None,) * t.ndim for p, t in sharding.cache_leaves(cache)})
    total = 0

    def walk(tree, path=()):
        nonlocal total
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        if isinstance(tree, torch.Tensor):
            spec = specs[path]
            total += place.local_bytes(tree.shape, tree.dtype, spec)
            return place(tree.shape, tree.dtype, spec)
        return tree
    return walk(cache), total


# -- one cell ----------------------------------------------------------------

def _step_trace(cfg, shape, mesh, logical, replication, seq_chunk, counts):
    """The op_cost report of one traced step of ``cfg`` cut to
    ``counts``."""
    ccfg = cut(cfg, counts)
    place = _Placer(mesh, logical)
    folds = {k: counts[k] for k in ("mlstm", "slstm") if k in counts}
    model = model_api.build_model(ccfg, device=META)
    inputs = _inputs(ccfg, shape, logical, place, replication)
    if shape.kind == "train":
        specs = _param_specs(model, mesh)
        params = {k: place(p.shape, p.dtype, specs[k])
                  for k, p in model.state_dict().items()}
        del model
        opt = adamw.AdamWState(
            step=torch.zeros((), dtype=torch.int32),     # a host count
            m={k: place(p.shape, torch.float32, specs[k])
               for k, p in params.items()},
            v={k: place(p.shape, torch.float32, specs[k])
               for k, p in params.items()})
        run = RunConfig(model=ccfg, shape=shape, remat="none",
                        seq_chunk=seq_chunk)
        step, _ = step_fns.make_train_step(run)

        def fn():
            step(params, opt, inputs)
    else:
        _place_module(model, mesh, place)
        if shape.kind == "prefill":
            def fn():
                model.prefill(inputs)
        else:
            cache = model.init_cache(shape.global_batch, shape.seq_len)
            cache, _ = _place_cache(cache, logical, place,
                                    shape.global_batch, replication)
            with torch.no_grad():
                cache = _ring_ready(cache, shape.seq_len)

            def fn():
                with torch.no_grad():
                    model.decode_step(cache, inputs["tokens"], inputs["pos"])
    with _distributed(mesh, replication), trips_lib.folded(folds):
        return op_cost.trace(fn)


def _ring_ready(cache, seq_len):
    """A decode cache as after a prompt of ``seq_len - 1`` tokens: each
    ring's host index set (the buffers' contents do not matter here)."""
    def walk(tree):
        if isinstance(tree, dict):
            out = {k: walk(v) for k, v in tree.items()}
            if "idx" in out and isinstance(out["idx"], int):
                out["idx"] = seq_len - 1
            return out
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree
    return walk(cache)


@contextlib.contextmanager
def _distributed(mesh, replication):
    """The mesh active for the models, its batch axes set, and plain
    tensors made inside the step taken as replicated."""
    if mesh is None:
        with activate_mesh(None):
            yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with activate_mesh(mesh), use_batch_axes(
            sharding.batch_axes(mesh, replication)), implicit_replication():
        yield


def argument_bytes(cfg, shape, logical, replication) -> dict:
    """The exact local bytes of the step's arguments on one device of the
    mesh ``logical`` names (None: one device): parameters (and for
    training the f32 moments and the step count), inputs, and for decode
    the cache."""
    place = _Placer(None, logical)
    model = model_api.build_model(cfg, device=META)
    shapes = {k: tuple(p.shape) for k, p in model.state_dict().items()}
    specs = (sharding.param_pspecs(shapes, logical) if logical is not None
             else {k: (None,) * len(v) for k, v in shapes.items()})
    sd = model.state_dict()
    out = {"params": sum(place.local_bytes(p.shape, p.dtype, specs[k])
                         for k, p in sd.items())}
    if shape.kind == "train":
        out["opt"] = 2 * sum(place.local_bytes(p.shape, torch.float32,
                                               specs[k])
                             for k, p in sd.items()) + 4
    out["inputs"] = sum(
        place.local_bytes(sh, dt, _input_spec(sh, logical, replication))
        for sh, dt in input_shapes(cfg, shape).values())
    if shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        specs_c = (sharding.cache_pspecs(cache, logical, shape.global_batch,
                                         replication)
                   if logical is not None else None)
        out["cache"] = sum(
            place.local_bytes(t.shape, t.dtype,
                              specs_c[p] if specs_c else (None,) * t.ndim)
            for p, t in sharding.cache_leaves(cache))
    return out


def lower_cell(arch_name, shape_name, *, multi_pod: bool = False,
               replication: str = "none", seq_chunk: int = 2048,
               cfg: Optional[ModelConfig] = None,
               shape: Optional[ShapeConfig] = None, one_device=False):
    """Trace one (arch x shape x mesh) cell; its stats dict. ``cfg`` and
    ``shape`` override the registry's (a depth-cut model, a card-sized
    batch); ``one_device`` traces on one device, without DTensor."""
    cfg = cfg or get_arch(arch_name)
    shape = shape or get_shape(shape_name)
    if one_device:
        mesh, logical, name, chips = None, None, "1x1", 1
    else:
        fake_world(WORLD)
        kernel_meta.register_sharding()
        mesh, logical = device_meshes(multi_pod, replication)
        name = mesh_name(multi_pod, replication)
        chips = logical.mesh.numel()
    t0 = time.perf_counter()   # repro: allow[wallclock] -- genuine wall
    counts = unit_counts(cfg, shape)
    n_traces = [0]

    def trace_at(corner):
        n_traces[0] += 1
        return _step_trace(cfg, shape, mesh, logical, replication,
                           seq_chunk, corner)
    rep = op_cost.extrapolate(trace_at, counts)
    # repro: allow[wallclock] -- genuine wall measurement
    t_trace = time.perf_counter() - t0
    args = argument_bytes(cfg, shape, logical, replication)
    arg_total = sum(args.values())
    if shape.kind == "train":
        output = args["params"] + args["opt"] + 4
        alias = args["params"] + args["opt"]
    else:
        # the last position's logits and the cache (decode: the donated
        # one, aliased)
        lg = (shape.global_batch, 1, cfg.vocab_size)
        spec = sharding.input_pspec(lg, logical, replication) \
            if logical is not None else (None,) * 3
        cache = args.get("cache")
        if cache is None:
            cache = argument_bytes(cfg, dataclasses.replace(
                shape, kind="decode"), logical, replication)["cache"]
        output = _Placer(None, logical).local_bytes(
            lg, torch.float32, spec) + cache
        alias = args.get("cache", 0)
    n_active = model_api.param_count(cfg, active_only=True)
    mf = rl.model_flops(n_active, shape.tokens_per_step,
                        "train" if shape.kind == "train" else "serve")
    num = op_cost.as_number
    terms = rl.RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh=name, chips=chips,
        flops_per_device=num(rep.flops),
        bytes_per_device=num(rep.bytes_lb),
        bytes_per_device_ub=num(rep.bytes),
        bytes_by_op={k: num(v) for k, v in sorted(
            rep.bytes_by_op.items(), key=lambda kv: -kv[1])[:12]},
        collective_bytes_per_device=num(rep.collective_bytes),
        collective_breakdown={k: {kk: num(vv) for kk, vv in v.items()}
                              for k, v in rl.collective_stats(
                                  rep.collective_breakdown).items()},
        model_flops_global=mf,
        memory_per_device={
            "argument": arg_total, "argument_parts": args,
            "output": output, "alias": alias,
            "temp": num(rep.temp_peak),
            "temp_basis": "estimate: the most live bytes the traced step "
                          "made, extrapolated from the traced depths",
            "generated_code": None}).finish()
    return {"ok": True, "cell": f"{cfg.name}:{shape.name}:{name}",
            "trace_s": round(t_trace, 2), "traces": n_traces[0],
            "units": counts,
            "kernel_flops": {k: num(v) for k, v in rep.kernel_flops.items()},
            # ops DTensor could not place, run on gathered inputs (count a
            # step, extrapolated like the costs)
            "replicated_ops": {k: num(v) for k, v in rep.fallbacks.items()},
            "torch": torch.__version__,
            "plan_dependent": [] if one_device else list(PLAN_DEPENDENT),
            "terms": terms.as_dict()}


def run_cells(cells, *, multi_pod: bool, replication: str = "none",
              out_path: str = None, verbose: bool = True):
    results = []
    for arch_name, shape_name in cells:
        tag = f"{arch_name}:{shape_name}:{'multi' if multi_pod else 'single'}"
        try:
            res = lower_cell(arch_name, shape_name, multi_pod=multi_pod,
                             replication=replication)
            t = res["terms"]
            if verbose:
                mem = t["memory_per_device"] or {}
                per_dev_gb = (mem.get("argument", 0)
                              + (mem.get("temp") or 0)) / 2**30
                print(f"[ok] {tag:48s} trace={res['trace_s']:7.1f}s "
                      f"comp={t['compute_s']:.3e}s mem={t['memory_s']:.3e}s "
                      f"coll={t['collective_s']:.3e}s dom={t['dominant']:10s} "
                      f"bytes/dev={per_dev_gb:6.2f}GiB "
                      f"useful={t['useful_ratio']:.2f}", flush=True)
        except Exception as e:  # noqa: BLE001 - report, keep going
            res = {"ok": False, "cell": tag,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            print(f"[FAIL] {tag}: {res['error']}", flush=True)
        results.append(res)
        if out_path:
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
    return results


def applicable_cells(include_long_for_all: bool = False):
    cells = []
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not arch.is_subquadratic \
                    and not include_long_for_all:
                continue
            cells.append((arch.name, shape.name))
    return cells


# -- the report (benchmarks/roofline_report.py's table and picks) ------------

def markdown_table(results, mesh="16x16") -> str:
    hdr = ("| arch | shape | comp(s) | mem(s) | coll(s) | dominant | "
           "useful | roofline-frac |\n|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in sorted((r for r in results if r.get("ok")),
                    key=lambda r: (r["terms"]["arch"], r["terms"]["shape"])):
        t = r["terms"]
        if t["mesh"] != mesh:
            continue
        lines.append(
            f"| {t['arch']} | {t['shape']} | {t['compute_s']:.3e} | "
            f"{t['memory_s']:.3e} | {t['collective_s']:.3e} | "
            f"{t['dominant']} | {t['useful_ratio']:.2f} | "
            f"{t['roofline_fraction']:.4f} |")
    return hdr + "\n".join(lines)


def pick_hillclimb_cells(results) -> dict:
    """The worst roofline fraction of the 16 x 16 train cells, the most
    collective-bound 16 x 16 cell, and the paper's representative
    (qwen1.5-110b's train step: replication wraps it)."""
    singles = [r["terms"] for r in results
               if r.get("ok") and r["terms"]["mesh"] == "16x16"]
    if not singles:
        return {}
    key = (lambda t: (t["arch"], t["shape"], t["mesh"]))
    trains = [t for t in singles if t["shape"] == "train_4k"]
    out = {"most_collective": key(max(singles,
                                      key=lambda t: t["collective_s"])),
           "paper_representative": ("qwen1.5-110b", "train_4k", "16x16")}
    if trains:
        out["worst_fraction"] = key(min(
            trains, key=lambda t: t["roofline_fraction"]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all)")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--replication", default="none",
                    choices=["none", "pod", "split"])
    ap.add_argument("--out", default=None, help="write JSON results here")
    ap.add_argument("--report", action="store_true",
                    help="print the 16x16 roofline table and the "
                         "hill-climb cells")
    args = ap.parse_args(argv)

    if args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(a, s) for a, s in applicable_cells() if a == args.arch]
    elif args.shape:
        cells = [(a, s) for a, s in applicable_cells() if s == args.shape]
    else:
        cells = applicable_cells()

    all_results = []
    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    for mp in meshes[args.mesh]:
        out = None
        if args.out:
            stem, ext = os.path.splitext(args.out)
            out = f"{stem}_{'multi' if mp else 'single'}{ext}" \
                if args.mesh == "both" else args.out
        all_results += run_cells(cells, multi_pod=mp,
                                 replication=args.replication, out_path=out)
    n_fail = sum(1 for r in all_results if not r["ok"])
    print(f"\n{len(all_results) - n_fail}/{len(all_results)} cells OK")
    if args.report:
        print(markdown_table(all_results))
        print(json.dumps({"hillclimb": pick_hillclimb_cells(all_results)}))
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
