"""Project lint: static enforcement of the serving stack's house rules.

Run as ``python -m repro_torch.analysis.lint src tests`` (clean = exit 0).

Rules (each waivable per line with ``# lint: allow(<rule>): reason``):

* ``dispatch-host-sync`` — no host-synchronizing call (``jax.device_get``,
  ``block_until_ready``, ``.item()``) reachable from any ``_dispatch*``
  function through the intra-package call graph. Dispatch must stay
  issue-only so the pipelined step's overlap (DESIGN.md §13) is never
  silently re-serialized; only commit may sync.
* ``wall-clock-rng`` — no wall-clock reads (``time.time``,
  ``time.perf_counter``, ...) or unseeded randomness (bare ``random``,
  ``np.random.<dist>``) inside ``core/``, ``serving/``, ``sim/`` —
  virtual-time code must be deterministic, keyed off SeedSequence or
  (seed, position).
* ``undeclared-counter`` — every literal ``counters[...]`` key,
  ``counters.update({...})`` key, ``causes[...]`` key, and literal
  ledger cause must be declared in the `repro_torch.obs.metrics` schema.
* ``alias-needs-donation`` — every jit site that (transitively) reaches
  a ``pl.pallas_call`` using ``input_output_aliases`` must carry a
  ``donate_argnums``/``donate_argnames``; aliasing without donation
  silently copies on TPU.

The call graph is name-based (callee names resolved against every
function definition in ``src`` with that name) — deliberately
over-approximate; waivers document the intentional exceptions.
"""

from __future__ import annotations

import ast
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.obs.metrics import (
    ENGINE_COUNTER_SCHEMA,
    EXTRA_COUNTER_SCHEMA,
    SCHED_COUNTER_SCHEMA,
    WASTE_CAUSE_SCHEMA,
)

RULES = (
    "dispatch-host-sync",
    "wall-clock-rng",
    "undeclared-counter",
    "alias-needs-donation",
)

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([a-z-]+)\)\s*:\s*\S")

SYNC_NAMES = {"device_get", "block_until_ready", "item"}
WALL_CLOCK_ATTRS = {
    "time", "perf_counter", "monotonic", "clock", "process_time", "thread_time",
}
SEEDED_RNG_OK = {
    "default_rng", "Generator", "SeedSequence", "PCG64", "Philox", "BitGenerator",
}

COUNTER_KEYS = (
    set(ENGINE_COUNTER_SCHEMA)
    | set(SCHED_COUNTER_SCHEMA)
    | set(EXTRA_COUNTER_SCHEMA)
    | {f"engine_{k}" for k in ENGINE_COUNTER_SCHEMA}
    | {f"sched_{k}" for k in SCHED_COUNTER_SCHEMA}
)
CAUSE_KEYS = set(WASTE_CAUSE_SCHEMA)


@dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ----------------------------------------------------------------------
# per-file collection
# ----------------------------------------------------------------------
def _terminal_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted form of a Name/Attribute chain ('np.random.rand')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


@dataclass
class FuncInfo:
    name: str
    path: str
    line: int
    waived: Set[str]                         # rules waived on the def line
    calls: List[Tuple[str, int, Set[str]]]   # (callee name, line, waived rules)
    syncs: List[Tuple[str, int]]             # direct host syncs (name, line)
    aliasing: bool                           # contains aliased pallas_call


@dataclass
class JitSite:
    path: str
    line: int
    waived: Set[str]
    donated: bool
    wrapped: List[str]    # function names whose bodies this jit compiles


class _Collector(ast.NodeVisitor):
    def __init__(self, path: str, waivers: Dict[int, Set[str]], is_src: bool,
                 rng_scope: bool):
        self.path = path
        self.waivers = waivers
        self.is_src = is_src
        self.rng_scope = rng_scope
        self.funcs: List[FuncInfo] = []
        self.jit_sites: List[JitSite] = []
        self.findings: List[LintFinding] = []
        self._stack: List[FuncInfo] = []

    def _waived(self, line: int) -> Set[str]:
        return self.waivers.get(line, set())

    # -------------------------- functions ----------------------------
    def _visit_func(self, node) -> None:
        info = FuncInfo(
            name=node.name, path=self.path, line=node.lineno,
            waived=self._waived(node.lineno), calls=[], syncs=[],
            aliasing=False,
        )
        self._jit_decorators(node, info)
        self.funcs.append(info)
        self._stack.append(info)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _jit_decorators(self, node, info: FuncInfo) -> None:
        """``@jax.jit`` / ``@functools.partial(jax.jit, ...)`` sites."""
        if not self.is_src:
            return
        for dec in node.decorator_list:
            donated = False
            is_jit = False
            if isinstance(dec, ast.Call):
                fn = _dotted(dec.func)
                if fn.endswith("jit"):
                    is_jit = True
                elif fn.endswith("partial") and dec.args and \
                        _dotted(dec.args[0]).endswith("jit"):
                    is_jit = True
                if is_jit:
                    donated = any(kw.arg in ("donate_argnums", "donate_argnames")
                                  for kw in dec.keywords)
            elif _dotted(dec).endswith("jit") and "jit" in _dotted(dec).split("."):
                is_jit = True
            if is_jit:
                self.jit_sites.append(JitSite(
                    path=self.path, line=dec.lineno,
                    waived=self._waived(dec.lineno) | self._waived(node.lineno),
                    donated=donated, wrapped=[node.name],
                ))

    # ---------------------------- calls ------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _terminal_name(node.func)
        waived = self._waived(node.lineno)
        if self._stack and name is not None:
            self._stack[-1].calls.append((name, node.lineno, waived))
            if name in SYNC_NAMES and "dispatch-host-sync" not in waived:
                self._stack[-1].syncs.append((name, node.lineno))
            if name == "pallas_call" and any(
                    kw.arg == "input_output_aliases" for kw in node.keywords):
                self._stack[-1].aliasing = True
        self._check_rng(node, name, waived)
        self._check_counters(node, name, waived)
        self._check_jit_call(node, name)
        self.generic_visit(node)

    def _check_rng(self, node: ast.Call, name, waived: Set[str]) -> None:
        if not self.rng_scope or "wall-clock-rng" in waived:
            return
        dotted = _dotted(node.func)
        parts = dotted.split(".")
        msg = None
        if len(parts) == 2 and parts[0] == "time" and parts[1] in WALL_CLOCK_ATTRS:
            msg = f"wall-clock read {dotted}() in virtual-time code"
        elif parts[0] == "random" and (len(parts) == 1 or len(parts) == 2):
            msg = f"unseeded stdlib randomness {dotted}()"
        elif len(parts) >= 2 and parts[-2] == "random" and \
                parts[0] in ("np", "numpy") and parts[-1] not in SEEDED_RNG_OK:
            msg = f"unseeded global numpy randomness {dotted}()"
        if msg:
            self.findings.append(LintFinding(
                "wall-clock-rng", self.path, node.lineno,
                msg + " — key RNG off SeedSequence / (seed, position)"))

    def _counter_base(self, node: ast.expr) -> Optional[str]:
        if isinstance(node, ast.Name) and node.id in ("counters", "causes"):
            return node.id
        if isinstance(node, ast.Attribute) and node.attr in ("counters", "causes"):
            return node.attr
        return None

    def _check_key(self, base: str, key: str, line: int) -> None:
        schema, what = ((CAUSE_KEYS, "cause") if base == "causes"
                        else (COUNTER_KEYS, "counter"))
        if key not in schema:
            self.findings.append(LintFinding(
                "undeclared-counter", self.path, line,
                f"{what} key {key!r} not declared in repro_torch.obs.metrics schema"))

    def _check_counters(self, node: ast.Call, name, waived: Set[str]) -> None:
        if "undeclared-counter" in waived:
            return
        if name == "update" and isinstance(node.func, ast.Attribute) and \
                self._counter_base(node.func.value) == "counters":
            for arg in node.args:
                if isinstance(arg, ast.Dict):
                    for k in arg.keys:
                        if isinstance(k, ast.Constant) and isinstance(k.value, str):
                            self._check_key("counters", k.value, node.lineno)
        if name == "charge_abandoned":
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    self._check_key("causes", arg.value, node.lineno)
        for kw in node.keywords:
            if kw.arg == "cause" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                self._check_key("causes", kw.value.value, node.lineno)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        base = self._counter_base(node.value)
        if base is not None and isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str) and \
                "undeclared-counter" not in self._waived(node.lineno):
            self._check_key(base, node.slice.value, node.lineno)
        self.generic_visit(node)

    def _check_jit_call(self, node: ast.Call, name) -> None:
        """``jax.jit(fn_or_lambda, ...)`` call-expression sites."""
        if not self.is_src or name != "jit" or not node.args:
            return
        donated = any(kw.arg in ("donate_argnums", "donate_argnames")
                      for kw in node.keywords)
        wrapped: List[str] = []
        target = node.args[0]
        if isinstance(target, ast.Lambda):
            for sub in ast.walk(target):
                if isinstance(sub, ast.Call):
                    sub_name = _terminal_name(sub.func)
                    if sub_name:
                        wrapped.append(sub_name)
        else:
            tname = _terminal_name(target)
            if tname:
                wrapped.append(tname)
        self.jit_sites.append(JitSite(
            path=self.path, line=node.lineno, waived=self._waived(node.lineno),
            donated=donated, wrapped=wrapped,
        ))


# ----------------------------------------------------------------------
# whole-project analysis
# ----------------------------------------------------------------------
def _iter_py(paths: Sequence[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    return out


def _is_src(path: Path) -> bool:
    return "tests" not in path.parts


def _rng_scope(path: Path) -> bool:
    parts = path.parts
    return "repro" in parts and any(d in parts for d in ("core", "serving", "sim"))


def _closure(seed: Set[str], funcs: List[FuncInfo],
             rule: str) -> Tuple[Set[int], Dict[int, Tuple[str, int]]]:
    """Fixpoint over the name-based call graph.

    Returns (tainted func ids, witness edge per tainted id) where the
    witness names the callee (and call line) that propagated the taint.
    """
    by_name: Dict[str, List[int]] = {}
    for i, f in enumerate(funcs):
        by_name.setdefault(f.name, []).append(i)
    tainted: Set[int] = {i for i, f in enumerate(funcs)
                         if f.name in seed or (rule == "dispatch-host-sync"
                                               and f.syncs)
                         or (rule == "alias-needs-donation" and f.aliasing)}
    witness: Dict[int, Tuple[str, int]] = {}
    changed = True
    while changed:
        changed = False
        for i, f in enumerate(funcs):
            if i in tainted or rule in f.waived:
                continue
            for callee, line, waived in f.calls:
                if rule in waived:
                    continue
                if any(j in tainted and rule not in funcs[j].waived
                       for j in by_name.get(callee, ())):
                    tainted.add(i)
                    witness[i] = (callee, line)
                    changed = True
                    break
    return tainted, witness


def _chain(i: int, funcs: List[FuncInfo],
           witness: Dict[int, Tuple[str, int]]) -> str:
    parts = [funcs[i].name]
    by_name: Dict[str, List[int]] = {}
    for j, f in enumerate(funcs):
        by_name.setdefault(f.name, []).append(j)
    seen = {i}
    while i in witness:
        callee, line = witness[i]
        parts.append(f"{callee} ({funcs[i].path}:{line})")
        nxt = next((j for j in by_name.get(callee, ()) if j in witness
                    or funcs[j].syncs or funcs[j].aliasing), None)
        if nxt is None or nxt in seen:
            break
        seen.add(nxt)
        i = nxt
    return " -> ".join(parts)


def run(paths: Sequence[str]) -> List[LintFinding]:
    findings: List[LintFinding] = []
    funcs: List[FuncInfo] = []
    jit_sites: List[JitSite] = []
    for path in _iter_py(paths):
        try:
            source = path.read_text()
            tree = ast.parse(source, filename=str(path))
        except (OSError, SyntaxError) as exc:   # pragma: no cover
            findings.append(LintFinding("parse", str(path), 0, str(exc)))
            continue
        waivers: Dict[int, Set[str]] = {}
        for lineno, text in enumerate(source.splitlines(), start=1):
            m = _ALLOW_RE.search(text)
            if m:
                waivers.setdefault(lineno, set()).add(m.group(1))
        col = _Collector(str(path), waivers, _is_src(path), _rng_scope(path))
        col.visit(tree)
        findings.extend(col.findings)
        if col.is_src:
            funcs.extend(col.funcs)
            jit_sites.extend(col.jit_sites)

    # R1: no host sync reachable from _dispatch*
    syncy, witness = _closure(set(), funcs, "dispatch-host-sync")
    for i, f in enumerate(funcs):
        if not f.name.startswith("_dispatch") or "dispatch-host-sync" in f.waived:
            continue
        if f.syncs:
            name, line = f.syncs[0]
            findings.append(LintFinding(
                "dispatch-host-sync", f.path, line,
                f"host sync {name}() inside {f.name} — only commit may sync"))
        elif i in syncy:
            findings.append(LintFinding(
                "dispatch-host-sync", f.path, f.line,
                f"host sync reachable from {f.name}: "
                f"{_chain(i, funcs, witness)} — only commit may sync"))

    # R4: aliased pallas_call needs donation at the jit site
    reaches, _ = _closure(set(), funcs, "alias-needs-donation")
    reach_names = {funcs[i].name for i in reaches}
    for site in jit_sites:
        if site.donated or "alias-needs-donation" in site.waived:
            continue
        hit = next((w for w in site.wrapped if w in reach_names), None)
        if hit is not None:
            findings.append(LintFinding(
                "alias-needs-donation", site.path, site.line,
                f"jit site wraps {hit!r} which reaches an aliased pallas_call "
                "(input_output_aliases) but passes no donate_argnums/"
                "donate_argnames — the alias silently copies"))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Project lint: dispatch purity, virtual-time determinism, "
                    "counter schema, alias/donation pairing.")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--json", metavar="FILE",
                    help="also write findings to FILE as JSON")
    args = ap.parse_args(argv)
    findings = run(args.paths)
    for f in findings:
        print(f)
    if args.json:
        Path(args.json).write_text(json.dumps(
            [f.__dict__ for f in findings], indent=2) + "\n")
    if findings:
        print(f"{len(findings)} finding(s)")
        return 1
    print("lint: clean")
    return 0


if __name__ == "__main__":   # pragma: no cover
    sys.exit(main())
