"""AST rules for the port (``lint`` command): the project's invariants
that mean something for PyTorch, scoped to ``repro_torch/``.

The port's counterpart of ``repro/analysis/lint.py`` (whose rules
``tools/dtmlint`` runs over all of ``src/``, the port included).  The
rules here are the ones that hold for torch code, with their scopes set
to the port's modules; a finding is suppressed by
``# dtmlint: disable=DTMxxx`` (comma-separated codes, or ``all``) on the
flagged line, with the reason beside it.

The JAX rules that do not apply here:

* DTM001 (unsized ``jnp.nonzero``): a data-dependent shape retraces a jit
  executable; torch has no trace cache, and a data-dependent shape under
  a CUDA graph capture needs a host read, which DTM003 flags.
* DTM004 (Python branch on a traced value): nothing here is traced; a
  branch on a device value needs a host read, which DTM003 flags.
* DTM005 (untyped ``jnp.asarray(0)``): JAX's dtype promotion against the
  packed layout; torch's constructors are checked by the parity tests.
* DTM006 (``lru_cache``'d numpy array left writeable): the port caches no
  array (its caches hold SM counts and loaded libraries), and the JAX
  lint still runs this rule over the port.
* DTM008 (``interpret=True`` default): Pallas interpret mode has no
  counterpart; a wrapper picks its plain version from the tensor's
  device alone.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import List, Optional, Sequence

__all__ = ["RULES", "Finding", "lint_source", "lint_paths", "main"]


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    scope: str
    rationale: str


RULES: Sequence[Rule] = (
    Rule("DTM002", "env-read",
         "repro_torch/ (all)",
         "The port reads no environment variable: the JAX package's "
         "REPRO_* knobs are engine arguments (kernel_path=, skip=, "
         "ta_prng=, autotune=, autotune_cache=), so a stray os.environ "
         "read would re-decide configuration behind the caller's back."),
    Rule("DTM003", "hot-path-sync",
         "repro_torch/core/{dtm,graph,prng,threefry}.py, kernels/, "
         "launch/",
         "A host read (.item(), .tolist(), .cpu(), .numpy()) or a "
         "synchronize (torch.cuda.synchronize, Event.synchronize) on the "
         "launch path serialises the device and breaks a CUDA graph "
         "capture; answers are fetched in collect() or at a documented "
         "fetch, marked inline."),
    Rule("DTM007", "mutable-default-arg",
         "repro_torch/ (all)",
         "A mutable default on an engine or server entry point is shared "
         "across tenants."),
    Rule("DTM009", "bare-except",
         "repro_torch/ (all)",
         "Silent fallbacks hid kernels in the JAX package; the port has "
         "no fallback: catch something nameable or raise."),
    Rule("DTM010", "unlocked-stats-read",
         "repro_torch/launch/scheduler.py",
         "The scheduler's thread mutates its counters between "
         "launches: every self.* read in stats() belongs under "
         "self._work."),
    Rule("DTM011", "non-atomic-file-publish",
         "repro_torch/checkpoint/, repro_torch/runtime/",
         "Durable state publishes atomically: write a *tmp* path, then "
         "os.replace; a crash mid-write must not leave a torn file a "
         "reader trusts."),
)

_RULES_BY_CODE = {r.code: r for r in RULES}
_HOT_MODULES = ("repro_torch/core/dtm.py", "repro_torch/core/graph.py",
                "repro_torch/core/prng.py", "repro_torch/core/threefry.py")
_HOT_DIRS = ("repro_torch/kernels/", "repro_torch/launch/")
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    code: str
    message: str

    def render(self, explain: bool = False) -> str:
        s = f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"
        if explain:
            s += f"\n    why: {_RULES_BY_CODE[self.code].rationale}"
        return s


def _norm(path: str) -> str:
    """Posix path from the ``repro_torch/`` package root."""
    p = Path(path).as_posix()
    i = p.rfind("repro_torch/")
    return p[i:] if i >= 0 else p


_SUPPRESS_RE = re.compile(r"#\s*dtmlint:\s*disable=([A-Za-z0-9_,\s]+|all)")


def _suppressed(lines: Sequence[str], f: Finding) -> bool:
    if not 1 <= f.line <= len(lines):
        return False
    m = _SUPPRESS_RE.search(lines[f.line - 1])
    if not m:
        return False
    spec = m.group(1).strip()
    return spec == "all" or f.code in {c.strip() for c in spec.split(",")}


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.path = relpath
        self.findings: List[Finding] = []
        self._fn_stack: List[str] = []
        self.in_port = relpath.startswith("repro_torch/")
        self.hot = (relpath in _HOT_MODULES
                    or relpath.startswith(_HOT_DIRS))
        self.in_scheduler = relpath == "repro_torch/launch/scheduler.py"
        self.in_durable = relpath.startswith(("repro_torch/checkpoint/",
                                              "repro_torch/runtime/"))

    def _flag(self, node: ast.AST, code: str, message: str) -> None:
        if self.in_port:
            self.findings.append(Finding(self.path, node.lineno,
                                         node.col_offset, code, message))

    # ---- DTM007, DTM010 ------------------------------------------------------
    def _visit_fn(self, node) -> None:
        for d in list(node.args.defaults) + [d for d in node.args.kw_defaults
                                             if d is not None]:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                    and d.func.id in ("list", "dict", "set", "bytearray")):
                self._flag(d, "DTM007", f"mutable default argument in "
                           f"{node.name}(): use None and build inside")
        if self.in_scheduler and node.name == "stats":
            self._check_stats_locking(node)
        self._fn_stack.append(node.name)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _check_stats_locking(self, node) -> None:
        def scan(n: ast.AST, locked: bool) -> None:
            if isinstance(n, ast.With):
                takes = any(
                    isinstance(i.context_expr, ast.Attribute)
                    and i.context_expr.attr == "_work"
                    and isinstance(i.context_expr.value, ast.Name)
                    and i.context_expr.value.id == "self" for i in n.items)
                for c in ast.iter_child_nodes(n):
                    scan(c, locked or takes)
                return
            if (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                    and n.value.id == "self" and n.attr != "_work"
                    and not locked):
                self._flag(n, "DTM010", f"stats() reads self.{n.attr} "
                           "outside `with self._work`")
            for c in ast.iter_child_nodes(n):
                scan(c, locked)

        for stmt in node.body:
            scan(stmt, False)

    # ---- DTM002, DTM003, DTM011 ----------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr == "getenv"
                and _root_name(f) == "os"):
            self._flag(node, "DTM002", "os.getenv: the port takes its "
                       "configuration as arguments")
        if (self.hot and isinstance(f, ast.Attribute)
                and f.attr in _SYNC_METHODS
                and "collect" not in self._fn_stack):
            self._flag(node, "DTM003", f".{f.attr}() on a hot path outside "
                       "collect(): a host synchronisation")
        if self.in_durable:
            self._check_atomic_publish(node)
        self.generic_visit(node)

    @staticmethod
    def _mentions_tmp(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            name = (sub.id if isinstance(sub, ast.Name) else
                    sub.attr if isinstance(sub, ast.Attribute) else
                    sub.value if (isinstance(sub, ast.Constant)
                                  and isinstance(sub.value, str)) else None)
            if name is not None and "tmp" in name.lower():
                return True
        return False

    def _check_atomic_publish(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Name) and f.id == "open" and len(node.args) >= 2:
            mode = node.args[1]
            if (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
                    and any(c in mode.value for c in "wax")
                    and not self._mentions_tmp(node.args[0])):
                self._flag(node, "DTM011", "file written at its final "
                           "path: write a *tmp* path and os.replace")
        if (isinstance(f, ast.Attribute)
                and f.attr in ("save", "savez", "savez_compressed")
                and _root_name(f) in ("np", "numpy", "torch") and node.args
                and not self._mentions_tmp(node.args[0])):
            self._flag(node, "DTM011", f"{_root_name(f)}.{f.attr} to a "
                       "final path: write a *tmp* path and os.replace")

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (node.attr == "environ" and isinstance(node.value, ast.Name)
                and node.value.id == "os"):
            self._flag(node, "DTM002", "os.environ: the port takes its "
                       "configuration as arguments")
        self.generic_visit(node)

    # ---- DTM009 ---------------------------------------------------------------
    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self._flag(node, "DTM009", "bare except: name the exception "
                       "or let it raise")
        self.generic_visit(node)


def lint_source(src: str, relpath: str) -> List[Finding]:
    """Lint one source string as if it lived at ``relpath`` (only paths
    under ``repro_torch/`` have rules)."""
    tree = ast.parse(src, filename=relpath)
    v = _Visitor(_norm(relpath))
    v.visit(tree)
    lines = src.splitlines()
    out = [f for f in v.findings if not _suppressed(lines, f)]
    out.sort(key=lambda f: (f.line, f.col, f.code))
    return out


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    """Lint files and directories (recursively, ``*.py``)."""
    files: List[Path] = []
    for p in map(Path, paths):
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    findings: List[Finding] = []
    for f in files:
        findings.extend(lint_source(f.read_text(), str(f)))
    return findings


def default_paths() -> List[str]:
    """The port's own tree."""
    return [str(Path(__file__).resolve().parents[1])]


def main(argv: Sequence[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis lint",
        description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: repro_torch/)")
    ap.add_argument("--explain", action="store_true",
                    help="print each rule's rationale")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule table and exit")
    ns = ap.parse_args(list(argv))
    if ns.rules:
        for r in RULES:
            print(f"{r.code} {r.name:24s} [{r.scope}]")
            print(f"    {r.rationale}")
        return 0
    findings = lint_paths(ns.paths or default_paths())
    for f in findings:
        print(f.render(explain=ns.explain))
    print(f"dtmlint (repro_torch): {len(findings)} finding(s), "
          f"{len(RULES)} rules active")
    return 1 if findings else 0
