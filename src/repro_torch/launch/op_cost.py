"""Trip-count-aware cost of a traced step, per device (the counterpart of
``repro/launch/hlo_cost.py``; there is no HLO here, so the ops a step
dispatches are counted as it runs on ``meta`` tensors).

``CostMode`` is a ``TorchDispatchMode`` that charges every op it sees:

  flops       the op's FLOPs from ``torch.utils.flop_counter``'s formulas
              (the matmuls, convolutions and attention of ATen) and, for a
              kernel (``torch.ops.repro_torch.*``, ``kernels/meta.py``),
              the kernel's work from ``kernels/cost.py``; nothing for the
              elementwise ops, as ``FlopCounterMode`` counts them
  bytes       operands plus results of each op that moves data (no view,
              no allocation): an unfused upper bound
  bytes_lb    the same for the ops that cannot fuse into a neighbour
              (matmuls, kernels, gathers, sorts, reductions, copies, the
              embedding): the fused lower bound
  collectives the operand bytes of each functional collective, by kind
              (``all-reduce``, ``all-gather``, ``reduce-scatter``,
              ``all-to-all``), which DTensor runs to redistribute and the
              MoE's sharded path runs itself

Over DTensors the mode sees each compute op at its *global* shapes and
each collective at its local ones. An op's per-device work is its global
work divided by the sizes of the mesh dims over which its output is
``Shard`` or ``Partial`` (each device computes its shard, or its share of
the sum); an output replicated over a dim was computed whole on each of
its devices. Bytes are the operands' and results' local shards.

Repeated units: a layer (a group, an encoder or decoder stack) and the
xLSTM's loops over the sequence are traced at 1 and 2 of each
(``extrapolate``) and the cost is taken at the real counts from the
multilinear function through those corners, which the cost of a step is:
every layer of a stack and every iteration of a loop after the first
costs the same. That is exact for every count (ints and fractions, no
rounding), forward and backward, and needs a handful of 1- and 2-layer
traces whatever the depth or sequence.
"""
from __future__ import annotations

import contextlib
import itertools
import sys
import weakref
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import meta as kernel_meta

COLLECTIVES = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
# ops whose bytes count toward the fused lower bound
_UNFUSED = ("mm", "bmm", "addmm", "baddbmm", "matmul", "convolution",
            "embedding", "embedding_dense_backward", "index_select",
            "index", "index_put", "index_add", "gather", "scatter",
            "scatter_add", "sort", "argsort", "topk", "searchsorted",
            "sum", "mean", "amax", "max", "min", "cumsum", "logsumexp",
            "_log_softmax", "_softmax", "_log_softmax_backward_data",
            "_softmax_backward_data", "nll_loss_forward",
            "nll_loss_backward", "clone", "copy", "_to_copy", "cat",
            "stack", "constant_pad_nd", "masked_fill", "where")
# the ops that may run on gathered inputs where DTensor has no placement
# for them on their inputs (``CostMode``): the views of a head dim split
# unevenly over ``model`` (decode's GQA heads), the KV cache's write at a
# position, the Mamba conv's padding, an add of two differently placed
# operands (torch 2.11) and the xLSTM gates' ``log_sigmoid_backward``
# (no strategy). Any other op that DTensor refuses raises: a shape fault
# under a mesh must not turn into a larger count.
GATHERED_OPS = frozenset({"view", "_unsafe_view", "index_put",
                          "constant_pad_nd", "add", "log_sigmoid_backward"})
_NO_BYTES = ("empty", "empty_like", "new_empty", "empty_strided",
             "new_empty_strided", "detach", "lift_fresh",
             "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd", "set_", "sym_size",
             "sym_stride", "sym_numel", "is_same_size")


def _exact(num, den):
    """num / den as an int when it divides, else a Fraction."""
    num = int(num)
    return num // den if num % den == 0 else Fraction(num, den)


@dataclass
class Report:
    flops: object = 0
    bytes: object = 0                 # unfused upper bound
    bytes_lb: object = 0              # fused lower bound
    collective_bytes: object = 0
    collective_breakdown: Dict[str, dict] = field(default_factory=dict)
    bytes_by_op: Dict[str, object] = field(default_factory=dict)
    kernel_flops: Dict[str, object] = field(default_factory=dict)
    temp_peak: object = 0             # most live bytes the step made
    # ops DTensor could not place on their inputs, run on gathered ones
    fallbacks: Dict[str, object] = field(default_factory=dict)

    def combine(self, other: "Report", k=1) -> "Report":
        """self + k * other (k may be negative: ``extrapolate``)."""
        out = Report(self.flops + k * other.flops,
                     self.bytes + k * other.bytes,
                     self.bytes_lb + k * other.bytes_lb,
                     self.collective_bytes + k * other.collective_bytes,
                     {kk: dict(v) for kk, v in
                      self.collective_breakdown.items()},
                     dict(self.bytes_by_op), dict(self.kernel_flops),
                     self.temp_peak + k * other.temp_peak,
                     dict(self.fallbacks))
        for kk, v in other.collective_breakdown.items():
            slot = out.collective_breakdown.setdefault(
                kk, {"count": 0, "bytes": 0})
            slot["count"] += k * v["count"]
            slot["bytes"] += k * v["bytes"]
        for src, dst in ((other.bytes_by_op, out.bytes_by_op),
                         (other.kernel_flops, out.kernel_flops),
                         (other.fallbacks, out.fallbacks)):
            for kk, v in src.items():
                dst[kk] = dst.get(kk, 0) + k * v
        return out


def _local(t):
    return getattr(t, "_local_tensor", t)


def _nbytes(t) -> int:
    loc = _local(t)
    return loc.numel() * loc.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _shards(out) -> int:
    """Devices that split an op's output: the product of the mesh dims
    over which it is Shard or Partial (1 for a plain tensor)."""
    t = next(_tensors(out), None)
    placements = getattr(t, "placements", None)
    if not placements:
        return 1
    mesh = t.device_mesh
    n = 1
    for i, p in enumerate(placements):
        if p.is_shard() or p.is_partial():
            n *= mesh.size(i)
    return n


def _on_replicated(func, args, kwargs):
    """``func`` on the local tensors of replicated DTensor arguments, its
    tensors returned as replicated DTensors on their mesh."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(t.device_mesh for t in _tensors((args, kwargs))
                if hasattr(t, "placements"))

    def local(tree):
        if isinstance(tree, (list, tuple)):
            return type(tree)(local(v) for v in tree)
        if isinstance(tree, dict):
            return {k: local(v) for k, v in tree.items()}
        return tree.to_local() if hasattr(tree, "placements") else tree

    def wrap(tree):
        if isinstance(tree, (list, tuple)):
            return type(tree)(wrap(v) for v in tree)
        if isinstance(tree, torch.Tensor):
            return DTensor.from_local(tree, mesh,
                                      [Replicate()] * mesh.ndim,
                                      run_check=False)
        return tree
    return wrap(func(*local(args), **local(kwargs)))


class CostMode(TorchDispatchMode):
    """Charge every dispatched op to ``report`` (see the module's text)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.report = Report()
        self._live = 0
        self._gathering = False       # inside a fallback's redistribute

    def _track(self, out, alias: bool):
        if alias:
            return
        for t in _tensors(out):
            n = _nbytes(t)
            self._live += n
            self.report.temp_peak = max(self.report.temp_peak, self._live)
            weakref.finalize(t, self._free, n)

    def _free(self, n):
        self._live -= n

    def _replicated(self, tree, keep_batch: bool):
        """``tree`` with each DTensor redistributed to Replicate on every
        mesh dim (but a batch ``Shard(0)`` when ``keep_batch``), the
        collectives charged. Where DTensor cannot redistribute it either
        (some torch releases), ``_gathered`` stands in."""
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._replicated(v, keep_batch) for v in tree)
        if isinstance(tree, dict):
            return {k: self._replicated(v, keep_batch)
                    for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor) or \
                not hasattr(tree, "placements"):
            return tree
        from torch.distributed.tensor import Replicate
        pl = [p if keep_batch and p.is_shard() and p.dim == 0
              else Replicate() for p in tree.placements]
        if list(tree.placements) == pl:
            return tree
        if not self._gathering:
            self._gathering = True
            try:
                with self:
                    return tree.redistribute(tree.device_mesh, pl)
            except (RuntimeError, NotImplementedError, IndexError):
                pass
            finally:
                self._gathering = False
        return self._gathered(tree, pl)

    def _gathered(self, t, pl):
        """``t`` at placements ``pl`` built on its local shard: an
        all-gather (a concatenation of the shard's copies) for each mesh
        dim whose split goes, an all-reduce for each partial sum, charged
        as those collectives; differentiable back to ``t``."""
        from torch.distributed.tensor import DTensor
        loc = t.to_local()
        mesh = t.device_mesh
        for i, (a, b) in enumerate(zip(t.placements, pl)):
            if a == b:
                continue
            n = mesh.size(i)
            kind = "all-gather" if a.is_shard() else "all-reduce"
            b_in = _nbytes(loc)
            slot = self.report.collective_breakdown.setdefault(
                kind, {"count": 0, "bytes": 0})
            slot["count"] += 1
            slot["bytes"] += b_in
            self.report.collective_bytes += b_in
            if a.is_shard():
                loc = torch.cat([loc] * n, dim=a.dim)
        # an uneven split's first shard is its largest: trim the copies
        # to the dims the placements ``pl`` leave whole
        for d in range(loc.ndim):
            if not any(p.is_shard() and p.dim == d for p in pl) and \
                    loc.shape[d] > t.shape[d]:
                loc = loc.narrow(d, 0, t.shape[d])
        return DTensor.from_local(loc, mesh, pl, run_check=False)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        name = packet.__name__
        try:
            out = func(*args, **kwargs)
        except (RuntimeError, NotImplementedError, IndexError):
            # DTensor has no placement for this op on these inputs (an
            # uneven split of a head dim, say): for an op of
            # ``GATHERED_OPS``, gather what it cannot split, keep the batch
            # split if it can, and count the op; any other op raises
            if self._gathering or name not in GATHERED_OPS or not any(
                    hasattr(t, "placements")
                    for t in _tensors((args, kwargs))):
                raise
            self.report.fallbacks[name] = \
                self.report.fallbacks.get(name, 0) + 1
            try:
                a, kw = self._replicated((args, kwargs), True)
                out = func(*a, **kw)
            except (RuntimeError, NotImplementedError, IndexError):
                a, kw = self._replicated((args, kwargs), False)
                try:
                    out = func(*a, **kw)
                except NotImplementedError:
                    # no strategy at all (a pointwise backward DTensor
                    # lacks): the op on the whole, replicated tensors
                    out = _on_replicated(func, a, kw)
            args, kwargs = a, kw
        r = self.report
        ns = getattr(func, "namespace", "")
        schema = func._schema
        alias = any(ret.alias_info is not None for ret in schema.returns)
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = COLLECTIVES.get(name)
            if kind is not None:
                b = sum(_nbytes(t) for t in _tensors((args, kwargs)))
                slot = r.collective_breakdown.setdefault(
                    kind, {"count": 0, "bytes": 0})
                slot["count"] += 1
                slot["bytes"] += b
                r.collective_bytes += b
                bb = b + sum(_nbytes(t) for t in _tensors(out))
                r.bytes += bb
                r.bytes_lb += bb
                r.bytes_by_op[kind] = r.bytes_by_op.get(kind, 0) + bb
                if kind == "all-reduce":
                    r.flops += sum(_local(t).numel()
                                   for t in _tensors(out))
                self._track(out, False)
            return out
        work = kernel_meta.work(func, args, kwargs)
        if work is not None:
            flops = _exact(work.flops, _shards(out))
            r.kernel_flops[name] = r.kernel_flops.get(name, 0) + flops
            r.flops += flops
        elif packet in self.registry:
            flops = self.registry[packet](*args, out_val=out, **kwargs)
            r.flops += _exact(flops, _shards(out))
        if not alias and name not in _NO_BYTES:
            b = sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
                sum(_nbytes(t) for t in _tensors(out))
            r.bytes += b
            r.bytes_by_op[name] = r.bytes_by_op.get(name, 0) + b
            if work is not None or name.rstrip("_") in _UNFUSED:
                r.bytes_lb += b
        self._track(out, alias or name in ("detach", "lift_fresh"))
        return out


# DTensor's redistribute plans, by (source spec, target spec, planner):
# torch plans each redistribute anew, and on a 3-D mesh with the batch
# over two mesh dims its graph search takes most of a trace
_PLANS: dict = {}


@contextlib.contextmanager
def _dtensor_hooks(mode: "CostMode"):
    """While DTensor is in use: the collectives that DTensor runs to
    redistribute an op's inputs (inside the op's dispatch, where ``mode``
    is off) run with ``mode`` on, so they are charged; and redistribute
    plans are memoised."""
    dispatch = sys.modules.get("torch.distributed.tensor._dispatch")
    if dispatch is None:
        yield
        return
    import torch.distributed.tensor._redistribute as rd
    orig_redistribute = dispatch.redistribute_local_tensor
    # torch releases before the graph planner cache their plans themselves
    orig_plan = getattr(rd, "_gen_transform_infos_non_cached", None)

    def redistribute(*args, **kwargs):
        with mode:
            return orig_redistribute(*args, **kwargs)

    def plan(src, dst, use_graph_based_transform=None):
        key = (src, dst, use_graph_based_transform)
        if key not in _PLANS:
            _PLANS[key] = orig_plan(src, dst, use_graph_based_transform)
        return _PLANS[key]
    saved = (rd._gen_transform_infos, orig_plan)
    dispatch.redistribute_local_tensor = redistribute
    if orig_plan is not None:
        rd._gen_transform_infos = rd._gen_transform_infos_non_cached = plan
    try:
        yield
    finally:
        dispatch.redistribute_local_tensor = orig_redistribute
        if orig_plan is not None:
            rd._gen_transform_infos, rd._gen_transform_infos_non_cached = \
                saved


def trace(fn: Callable[[], object]) -> Report:
    """Run ``fn`` under a ``CostMode``; its report."""
    mode = CostMode()
    with _dtensor_hooks(mode), mode:
        fn()
    return mode.report


def extrapolate(trace_at: Callable[[dict], Report],
                counts: Dict[str, int]) -> Report:
    """The cost at ``counts`` ({unit: how many}) from traces at 1 and 2 of
    each unit whose count is above 2 (a unit at 0, 1 or 2 is traced at its
    count): the multilinear function through the traced corners, taken at
    the real counts. ``trace_at(corner)`` traces the step with the units
    cut to ``corner``."""
    free = [u for u, n in counts.items() if n > 2]
    total: Optional[Report] = None
    for corner in itertools.product((1, 2), repeat=len(free)):
        at = dict(counts)
        at.update(zip(free, corner))
        w = 1
        for u, c in zip(free, corner):
            w *= (2 - counts[u]) if c == 1 else (counts[u] - 1)
        rep = trace_at(at)
        total = Report().combine(rep, w) if total is None else \
            total.combine(rep, w)
    return total


def as_number(x) -> float:
    """An exact count as a float (ints stay ints)."""
    return x if isinstance(x, int) else float(x)
