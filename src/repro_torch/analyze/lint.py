"""AST lint pass with repo-specific determinism/FT rules (port of
``repro/analyze/lint.py``).

The simulator's correctness story rests on bitwise determinism: every
rank/replica pair must produce identical results, so anything that lets
wall-clock time, unseeded randomness, or unordered iteration leak into
computed values is a latent replica-divergence bug.  This pass encodes
those invariants as eight rules over ``src/repro_torch``:

  wallclock           time.time()/perf_counter()/monotonic() etc. outside
                      annotated genuine wall-measurement sites — virtual
                      time must come from clock.VirtualClock
  unseeded-rng        stdlib ``random.*`` module functions, legacy
                      ``numpy.random.*`` global-state functions, and
                      ``default_rng()`` with no seed argument
  set-order           iterating a set (for / comprehension / list(...) /
                      tuple(...) / enumerate(...)) — set order is
                      nondeterministic across processes and feeds
                      combine/placement/reduction order; iterate
                      ``sorted(...)`` instead
  unpriced-transport  ``ReplicaTransport(...)`` constructed without a
                      ``cost_model=`` keyword: messages move for free and
                      TimeBreakdown.comm silently under-reports
  tag-range           declared ``TAG_*`` constants / CollectiveOp ``tag``
                      attributes that leave their reserved band
                      (analyze.tags.RESERVED_BANDS) or collide with
                      another declaration; app modules must not declare
                      negative tags at all
  deepcopy            ``copy.deepcopy`` in ``src/repro_torch/comm/`` hot
                      paths: payloads are copy-on-write (frozen at send,
                      comm.payload), so a deepcopy per message is an
                      O(payload) regression waiting to happen
  per-rank-loop       ``for … in range(<x>.n)`` (self.n / engine.n)
                      inside ``comm/collectives.py``: the switchboard
                      hot paths are vectorized over SoA message tables,
                      so a per-rank Python loop there is
                      an O(N) regression; genuine per-destination dense
                      message loops annotate
                      ``# repro: allow[per-rank-loop]``
  no-print            bare ``print(...)`` in library modules: runtime
                      state belongs in the obs surfaces (metrics /
                      traces) or in a returned result, not on stdout.
                      CLI modules are exempt — a ``__main__.py``, any
                      module defining a top-level ``main()`` entry point,
                      or a module on the explicit ``_CLI_MODULE_SUFFIXES``
                      list

Suppression: a finding is suppressed by ``# repro: allow[rule]`` (comma
separated rule ids; ``allow[*]`` allows everything) on the finding's line
or the line directly above it.  The port's modules keep the reference's
pragma syntax, and the path rules name the port's paths.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analyze.findings import ERROR, Finding
from repro_torch.analyze.tags import (RESERVED_MAX, RESERVED_MIN,
                                      band_owner, in_infra_module)

RULES: Dict[str, str] = {
    "wallclock": "wall-clock read outside an annotated measurement site",
    "unseeded-rng": "unseeded / global-state random number generation",
    "set-order": "iteration over an unordered set",
    "unpriced-transport": "ReplicaTransport constructed without a "
                          "cost_model",
    "tag-range": "reserved message-tag band violation or collision",
    "deepcopy": "copy.deepcopy on a comm hot path (payloads are "
                "copy-on-write)",
    "per-rank-loop": "per-rank Python loop on a vectorized collective "
                     "hot path",
    "no-print": "bare print() in a library module (not a CLI entry "
                "point)",
}

# the comm hot paths the deepcopy rule polices (path fragments)
_DEEPCOPY_PATHS = ("repro_torch/comm/",)

# the files the per-rank-loop rule polices: the collective engine is
# vectorized over SoA tables, so range(self.n)/range(engine.n) loops
# there are regressions unless explicitly allowed
_PER_RANK_PATHS = ("repro_torch/comm/collectives.py",)

# explicit no-print exemptions: CLI-facing library modules that are
# neither a __main__.py nor a top-level main() module (path suffixes,
# "/"-normalized).  repro_torch/pool/demo.py backs
# `python -m repro_torch.pool`.
_CLI_MODULE_SUFFIXES = ("repro_torch/pool/demo.py",)

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[([^\]]*)\]")

# time-module calls that read the wall clock
_WALLCLOCK_FNS = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.clock_gettime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}

# stdlib random module-level functions (process-global Mersenne state)
_STDLIB_RANDOM_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "vonmisesvariate", "seed", "getrandbits",
}

# numpy.random legacy global-state functions
_NUMPY_RANDOM_FNS = {
    "rand", "randn", "random", "random_sample", "ranf", "sample",
    "randint", "choice", "shuffle", "permutation", "uniform", "normal",
    "standard_normal", "seed", "bytes", "beta", "binomial", "poisson",
    "exponential", "integers",
}

# order-insensitive consumers: a set inside these calls is fine
_ORDER_SAFE_CALLS = {"sorted", "len", "min", "max", "sum", "any", "all",
                     "frozenset", "set"}


def parse_allows(source: str) -> Dict[int, Set[str]]:
    """1-based line -> set of allowed rule ids (or {"*"})."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out[i] = rules
    return out


def _suppressed(allows: Dict[int, Set[str]], line: int, rule: str) -> bool:
    for at in (line, line - 1):
        rules = allows.get(at)
        if rules and (rule in rules or "*" in rules):
            return True
    return False


class _TagDecl:
    """One declared tag constant (module-level TAG_* or CollectiveOp
    ``tag = ...`` attribute)."""

    __slots__ = ("path", "line", "name", "value")

    def __init__(self, path: str, line: int, name: str, value: int):
        self.path = path
        self.line = line
        self.name = name
        self.value = value


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.findings: List[Finding] = []
        self.tag_decls: List[_TagDecl] = []
        # alias -> dotted module path ("np" -> "numpy")
        self.mod_alias: Dict[str, str] = {}
        # name -> dotted function path ("perf_counter" -> "time.perf_counter")
        self.func_alias: Dict[str, str] = {}
        # scope stack of {name: is-set} maps for local set inference
        self._set_vars: List[Dict[str, bool]] = [{}]
        self._order_safe_depth = 0
        self._class_stack: List[ast.ClassDef] = []
        # no-print: findings held back until the whole module is seen —
        # a later top-level ``def main`` still marks the module as a CLI
        self.print_findings: List[Finding] = []
        norm = path.replace(os.sep, "/")
        self.is_cli = os.path.basename(path) == "__main__.py" or \
            any(norm.endswith(sfx) for sfx in _CLI_MODULE_SUFFIXES)
        self.check_per_rank = any(frag in norm
                                  for frag in _PER_RANK_PATHS)

    # -- helpers -------------------------------------------------------------

    def _emit(self, node: ast.AST, rule: str, message: str,
              hint: str = "", severity: str = ERROR) -> None:
        self.findings.append(Finding(rule, self.path, node.lineno,
                                     message, hint, severity))

    def _dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve an expression to a dotted name with import aliases
        substituted at the root; None when unresolvable."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = node.id
        parts.append(self.mod_alias.get(root, self.func_alias.get(root,
                                                                  root)))
        return ".".join(reversed(parts))

    @staticmethod
    def _const_int(node: ast.AST) -> Optional[int]:
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return node.value
        if isinstance(node, ast.UnaryOp) and \
                isinstance(node.op, ast.USub):
            inner = _Linter._const_int(node.operand)
            return -inner if inner is not None else None
        return None

    def _is_set_expr(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("set", "frozenset"):
            return True
        if isinstance(node, ast.Name):
            for scope in reversed(self._set_vars):
                if node.id in scope:
                    return scope[node.id]
        return False

    # -- imports -------------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.mod_alias[alias.asname or alias.name.split(".")[0]] = \
                alias.name if alias.asname else alias.name.split(".")[0]

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module is None:
            return
        for alias in node.names:
            local = alias.asname or alias.name
            dotted = f"{node.module}.{alias.name}"
            # submodule import (from numpy import random) vs function
            # import (from time import perf_counter): treat both as a
            # dotted prefix — attribute chains and calls resolve the same
            self.func_alias[local] = dotted

    # -- scopes --------------------------------------------------------------

    def _walk_scope(self, node: ast.AST) -> None:
        self._set_vars.append({})
        self.generic_visit(node)
        self._set_vars.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node.name == "main" and len(self._set_vars) == 1 \
                and not self._class_stack:
            self.is_cli = True           # top-level main(): a CLI module
        self._walk_scope(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._walk_scope(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._walk_scope(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node)
        self._collect_class_tag(node)
        self._walk_scope(node)
        self._class_stack.pop()

    # -- assignments (set inference + TAG_* declarations) --------------------

    def _note_assign(self, target: ast.AST, value: ast.AST,
                     lineno: int) -> None:
        if not isinstance(target, ast.Name):
            return
        self._set_vars[-1][target.id] = self._is_set_expr(value)
        if target.id.startswith("TAG_") and len(self._set_vars) == 1 \
                and not self._class_stack:
            const = self._const_int(value)
            if const is not None:
                self.tag_decls.append(_TagDecl(self.path, lineno,
                                               target.id, const))

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        for target in node.targets:
            self._note_assign(target, node.value, node.lineno)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None:
            self._note_assign(node.target, node.value, node.lineno)

    def _collect_class_tag(self, node: ast.ClassDef) -> None:
        """``tag = TAG_X`` / ``tag = -n`` attributes on CollectiveOp-style
        classes register a collective on that tag."""
        looks_op = any(isinstance(b, ast.Name) and b.id.endswith("Op")
                       for b in node.bases) or \
            any(isinstance(s, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "kind"
                for t in s.targets) for s in node.body)
        if not looks_op:
            return
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "tag"
                    for t in stmt.targets):
                const = self._const_int(stmt.value)
                if const is None and isinstance(stmt.value, ast.Name):
                    # references a module TAG_* constant — the constant's
                    # own declaration is checked; nothing new to record
                    continue
                if const is not None and const != 0:
                    self.tag_decls.append(_TagDecl(
                        self.path, stmt.lineno,
                        f"{node.name}.tag", const))

    # -- calls ---------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        dotted = self._dotted(node.func)
        if dotted is not None:
            self._check_wallclock(node, dotted)
            self._check_rng(node, dotted)
            self._check_transport(node, dotted)
            self._check_deepcopy(node, dotted)
        self._check_print(node)
        self._check_set_call(node)
        safe = isinstance(node.func, ast.Name) and \
            node.func.id in _ORDER_SAFE_CALLS
        if safe:
            self._order_safe_depth += 1
        self.generic_visit(node)
        if safe:
            self._order_safe_depth -= 1

    def _check_wallclock(self, node: ast.Call, dotted: str) -> None:
        if dotted in _WALLCLOCK_FNS:
            self._emit(node, "wallclock",
                       f"{dotted}() reads the wall clock",
                       "charge virtual time through "
                       "clock.VirtualClock, or annotate a genuine "
                       "wall measurement with  # repro: allow[wallclock]")

    def _check_rng(self, node: ast.Call, dotted: str) -> None:
        parts = dotted.split(".")
        if parts[0] == "random" and len(parts) == 2 and \
                parts[1] in _STDLIB_RANDOM_FNS:
            self._emit(node, "unseeded-rng",
                       f"{dotted}() draws from the process-global RNG",
                       "use a seeded np.random.default_rng(seed) / "
                       "random.Random(seed) instance")
        elif dotted == "random.Random" and not node.args \
                and not node.keywords:
            self._emit(node, "unseeded-rng",
                       "random.Random() constructed without a seed",
                       "pass an explicit seed")
        elif len(parts) >= 2 and parts[-2] == "random" \
                and parts[0] == "numpy":
            fn = parts[-1]
            if fn in _NUMPY_RANDOM_FNS:
                self._emit(node, "unseeded-rng",
                           f"numpy.random.{fn}() uses the legacy global "
                           f"RNG state",
                           "use np.random.default_rng(seed)")
            elif fn == "default_rng" and not node.args \
                    and not node.keywords:
                self._emit(node, "unseeded-rng",
                           "default_rng() constructed without a seed",
                           "pass an explicit seed")

    def _check_transport(self, node: ast.Call, dotted: str) -> None:
        if dotted.split(".")[-1] != "ReplicaTransport":
            return
        if any(kw.arg == "cost_model" for kw in node.keywords):
            return
        if any(kw.arg is None for kw in node.keywords):
            return                       # **kwargs may carry it — skip
        self._emit(node, "unpriced-transport",
                   "ReplicaTransport constructed without a cost_model: "
                   "its messages move in zero virtual time",
                   "pass cost_model= (clock.pricing_from_ft), or "
                   "annotate a deliberately free transport with  "
                   "# repro: allow[unpriced-transport]")

    def _check_deepcopy(self, node: ast.Call, dotted: str) -> None:
        if dotted != "copy.deepcopy":
            return
        norm = self.path.replace(os.sep, "/")
        if not any(frag in norm for frag in _DEEPCOPY_PATHS):
            return
        self._emit(node, "deepcopy",
                   "copy.deepcopy on the comm hot path: payloads are "
                   "copy-on-write (frozen at send), so this is an "
                   "O(payload) copy per message",
                   "share the frozen payload or use comm.payload."
                   "structural_copy; annotate a justified isolation copy "
                   "with  # repro: allow[deepcopy]")

    def _check_print(self, node: ast.Call) -> None:
        """Bare print() in library code; held back until the module-level
        walk finishes so a later ``def main`` still exempts the module."""
        if isinstance(node.func, ast.Name) and node.func.id == "print":
            self.print_findings.append(Finding(
                "no-print", self.path, node.lineno,
                "print() in a library module writes simulator state to "
                "stdout",
                "route it through obs (metrics/trace) or return "
                "it; CLI modules (__main__.py / top-level main()) are "
                "exempt, or annotate with  # repro: allow[no-print]"))

    def _check_set_call(self, node: ast.Call) -> None:
        """list(set(..)) / tuple(set(..)) / enumerate(set(..)) materialize
        the unordered iteration order."""
        if self._order_safe_depth:
            return
        if isinstance(node.func, ast.Name) and \
                node.func.id in ("list", "tuple", "enumerate", "iter") \
                and node.args and self._is_set_expr(node.args[0]):
            self._emit(node, "set-order",
                       f"{node.func.id}() over a set materializes "
                       f"nondeterministic order",
                       "wrap in sorted(...) before iterating")

    # -- iteration -----------------------------------------------------------

    def _check_iter(self, node: ast.AST, iter_node: ast.AST) -> None:
        self._check_per_rank(node, iter_node)
        if self._order_safe_depth:
            return
        if self._is_set_expr(iter_node):
            self._emit(node, "set-order",
                       "iterating a set: element order is "
                       "nondeterministic and feeds downstream "
                       "combine/placement/reduction order",
                       "iterate sorted(...) instead")

    def _check_per_rank(self, node: ast.AST, iter_node: ast.AST) -> None:
        """``range(self.n)`` / ``range(x, engine.n)`` loops in the
        collective engine: the switchboard is vectorized over SoA tables,
        so a per-rank Python loop there is an O(N) hot-path regression."""
        if not self.check_per_rank:
            return
        if not (isinstance(iter_node, ast.Call)
                and isinstance(iter_node.func, ast.Name)
                and iter_node.func.id == "range"):
            return
        if any(isinstance(a, ast.Attribute) and a.attr == "n"
               for a in iter_node.args):
            self._emit(node, "per-rank-loop",
                       "per-rank Python loop over range(*.n) on a "
                       "collective hot path",
                       "vectorize over the SoA message tables, "
                       "or annotate a genuine "
                       "per-destination message loop with  "
                       "# repro: allow[per-rank-loop]")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node, node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(node, gen.iter)
        self._walk_scope(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp


def lint_source(source: str, path: str = "<string>",
                collect_tags: Optional[List[_TagDecl]] = None
                ) -> List[Finding]:
    """Lint one module's source; suppressed findings are dropped.  Tag
    declarations are appended to ``collect_tags`` for the caller's
    cross-file pass (and checked against the reserved bands here)."""
    tree = ast.parse(source, filename=path)
    linter = _Linter(path, source)
    linter.visit(tree)
    if not linter.is_cli:
        linter.findings.extend(linter.print_findings)
    allows = parse_allows(source)
    findings = [f for f in linter.findings
                if not _suppressed(allows, f.line, f.rule)]
    findings.extend(
        f for f in _band_findings(linter.tag_decls)
        if not _suppressed(allows, f.line, f.rule))
    if collect_tags is not None:
        collect_tags.extend(
            d for d in linter.tag_decls
            if not _suppressed(allows, d.line, "tag-range"))
    return findings


def _band_findings(decls: Sequence[_TagDecl]) -> List[Finding]:
    """Per-file reserved-band membership checks."""
    out: List[Finding] = []
    for d in decls:
        if in_infra_module(d.path):
            if not (RESERVED_MIN <= d.value <= RESERVED_MAX):
                out.append(Finding(
                    "tag-range", d.path, d.line,
                    f"{d.name} = {d.value} leaves the reserved tag "
                    f"space [{RESERVED_MIN}..{RESERVED_MAX}]",
                    "pick a free tag inside the owning subsystem's band "
                    "(analyze.tags.RESERVED_BANDS)"))
        elif d.value < 0:
            owner = band_owner(d.value)
            owned = f" (owned by {owner})" if owner else ""
            out.append(Finding(
                "tag-range", d.path, d.line,
                f"{d.name} = {d.value}: app modules must use tags >= 0; "
                f"negative tags are reserved{owned}",
                "use a non-negative application tag"))
    return out


def _collision_findings(decls: Sequence[_TagDecl]) -> List[Finding]:
    """Cross-file pass: two declarations sharing a tag value collide."""
    by_value: Dict[int, List[_TagDecl]] = {}
    for d in decls:
        if d.value < 0:                 # reserved space only: app tags may
            by_value.setdefault(d.value, []).append(d)   # legitimately repeat
    out: List[Finding] = []
    for value, ds in sorted(by_value.items()):
        names = {d.name for d in ds}
        if len(names) <= 1:
            continue
        first = min(ds, key=lambda d: (d.path, d.line))
        for d in ds:
            if d is first:
                continue
            out.append(Finding(
                "tag-range", d.path, d.line,
                f"{d.name} = {value} collides with {first.name} "
                f"({first.path}:{first.line})",
                "every reserved tag must be unique across subsystems"))
    return out


def iter_py_files(paths: Iterable[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            files.extend(os.path.join(root, n) for n in sorted(names)
                         if n.endswith(".py"))
    return files


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    """Lint every .py file under ``paths`` + the cross-file tag pass."""
    findings: List[Finding] = []
    tags: List[_TagDecl] = []
    for path in iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        findings.extend(lint_source(source, path, collect_tags=tags))
    findings.extend(_collision_findings(tags))
    return findings
