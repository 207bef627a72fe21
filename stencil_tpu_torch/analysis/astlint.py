"""AST lint engine + the port's rule set.

The port's own copy of ``stencil_tpu.analysis.astlint``. The engine walks
Python ASTs (stdlib ``ast`` only: no torch, no imports of the linted code)
and runs registered rules over each file. Each rule has a name, a
severity, and a docstring that IS its user-facing description
(``lint_tool lint --list-rules`` prints them). This module is stdlib-only.

Suppression: an inline ``# lint: disable=<rule>[,<rule>...]`` comment on
the finding's line (or on the line directly above it) suppresses those
rules there. A disable naming an unknown rule is itself a loud
``bad-pragma`` error — a typo'd suppression must never silently disable
nothing.

Baseline: a committed JSON file of finding fingerprints
(:func:`load_baseline` / :func:`write_baseline`; the port's is
``stencil_tpu_torch/analysis/lint-baseline.json``). Fingerprints hash the
rule + file path + source-line text (+ an occurrence index), so unrelated
edits that shift line numbers do not invalidate the baseline, while
editing the offending line re-surfaces the finding. ``lint_tool`` exits 1
only on findings NOT in the baseline.

The rules, as the JAX package has them except where noted:

- ``pure-stdlib``     obs/watchdog.py, obs/ledger.py, obs/status.py are
                      loaded BY FILE PATH (a supervisor that must not
                      initialize CUDA) and must import only the stdlib, at
                      any nesting depth.
- ``telemetry-vocab`` literal metric names at Recorder record sites must
                      be in obs/telemetry's vocabulary (``NAME_FIELDS`` and
                      ``KNOWN_NAMES``), read by parsing that file, never by
                      importing it. Dynamic names are explicitly generic.
- ``atomic-write``    json.dump through a plain ``open(path, "w")`` with
                      no tmp+rename in scope: a crash mid-write leaves a
                      torn artifact where every other writer in this
                      repo (ckpt, ledger, status, plan DB) guarantees
                      atomic replacement.
- ``no-bare-assert``  ``assert`` used for validation in PUBLIC library
                      functions vanishes under ``python -O``; raise
                      ValueError/RuntimeError instead.
- ``fstring-placeholder`` a plain string containing ``{name}`` fed to
                      raise/log without the f-prefix: the reader gets the
                      placeholder, not the value.
- ``host-sync-in-hot-loop`` ``.item()``/``.cpu()``/``.tolist()``,
                      ``float()``/``int()`` of a tensor,
                      ``torch.cuda.synchronize``, ``np.asarray`` and
                      ``time.time()`` inside the step loops and the kernel
                      wrappers: a host sync stalls the launch queue, so
                      the card idles while the host waits. The JAX rule
                      seeds on the functions handed to ``jax.jit`` and its
                      kin; the port's eager loops have no such marker, so
                      the rule seeds on the loop builders' step closures
                      and on the kernel wrappers, by file and name
                      (:data:`HOT_LOOP_BUILDERS`, :data:`KERNEL_WRAPPERS`).
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

SEVERITIES = ("error", "warning")

# Repo files under the pure-stdlib contract: loaded by file path, so any
# non-stdlib (or relative) import, however deeply nested, breaks them.
# Matched by path SUFFIX, so a fixture obs/watchdog.py in a temp dir is
# held to the same contract (the CI gate's fires-on-bad proof).
PURE_STDLIB_FILES = (
    "obs/watchdog.py",
    "obs/ledger.py",
    "obs/status.py",
)
# Directories never linted by default (tests use asserts and ad-hoc
# metric names legitimately; generated caches and builds are not source).
EXCLUDE_DIR_NAMES = ("__pycache__", ".git", ".claude", "_build")
EXCLUDE_PREFIXES = ("tests/",)

DEFAULT_PATHS = ("stencil_tpu_torch", "chip_smoke.py")

# The telemetry vocabulary's authority, found by path from the linted
# tree's root (parsed, never imported).
TELEMETRY_FILE = "stencil_tpu_torch/obs/telemetry.py"


@dataclass(frozen=True)
class Finding:
    """One lint finding; ``fingerprint`` is assigned by the engine (rule +
    file basename + offending line text + occurrence index)."""

    rule: str
    path: str           # repo-relative, forward slashes
    line: int
    col: int
    message: str
    severity: str = "error"
    snippet: str = ""   # stripped source line (fingerprint input)
    fingerprint: str = ""

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "severity": self.severity,
            "message": self.message, "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule}/{self.severity}] {self.message}")


@dataclass
class FileContext:
    """Everything a rule sees about one file."""

    relpath: str            # repo-relative, forward slashes
    src: str
    lines: List[str]
    tree: ast.AST
    repo_root: Optional[str] = None

    def finding(self, rule: "Rule", node, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = (self.lines[line - 1].strip()
                   if 0 < line <= len(self.lines) else "")
        return Finding(rule=rule.name, path=self.relpath, line=line,
                       col=col, message=message, severity=rule.severity,
                       snippet=snippet)


@dataclass(frozen=True)
class Rule:
    name: str
    severity: str
    doc: str
    check: Callable[["FileContext"], List[Finding]]
    applies: Callable[[str], bool]


RULES: Dict[str, Rule] = {}


def rule(name: str, severity: str = "error",
         applies: Optional[Callable[[str], bool]] = None):
    """Register a rule; the decorated function's docstring is the
    user-facing description."""
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r} for rule {name}")

    def deco(fn):
        RULES[name] = Rule(
            name=name, severity=severity,
            doc=(fn.__doc__ or "").strip().splitlines()[0],
            check=fn, applies=applies or (lambda relpath: True),
        )
        return fn

    return deco


def _norm(relpath: str) -> str:
    return relpath.replace(os.sep, "/")


def _not_tests(relpath: str) -> bool:
    p = _norm(relpath)
    return not (p.startswith("tests/") or "/tests/" in p)


def _library_code(relpath: str) -> bool:
    """Library scope: not tests, not operational scripts (probe/gate
    scripts use asserts as executable documentation)."""
    p = _norm(relpath)
    return _not_tests(p) and not (p.startswith("scripts/")
                                  or "/scripts/" in p)


# -- suppression pragmas ------------------------------------------------------

_PRAGMA_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_\-, ]+)")


def suppressions(ctx: FileContext) -> Tuple[Dict[int, Set[str]],
                                            List[Finding]]:
    """(line -> suppressed rule names, bad-pragma findings). A pragma on
    line N suppresses findings on N and N+1 (the comment-above idiom)."""
    supp: Dict[int, Set[str]] = {}
    bad: List[Finding] = []
    for i, text in enumerate(ctx.lines, 1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        names = {t.strip() for t in m.group(1).split(",") if t.strip()}
        unknown = sorted(n for n in names if n not in RULES)
        if unknown:
            bad.append(Finding(
                rule="bad-pragma", path=ctx.relpath, line=i,
                col=text.index("#"), severity="error",
                message=(f"lint: disable names unknown rule(s) "
                         f"{', '.join(unknown)} (known: "
                         f"{', '.join(sorted(RULES))})"),
                snippet=text.strip(),
            ))
        known = names - set(unknown)
        if known:
            # pure comment line: the pragma governs the NEXT line too
            supp.setdefault(i, set()).update(known)
            if text.lstrip().startswith("#"):
                supp.setdefault(i + 1, set()).update(known)
    return supp, bad


# -- rule: pure-stdlib --------------------------------------------------------


def _stdlib_names() -> frozenset:
    names = getattr(sys, "stdlib_module_names", None)
    if names:
        return frozenset(names) | {"__future__"}
    # pre-3.10 fallback: forbid the third-party stack this repo uses
    return frozenset()


_STDLIB = _stdlib_names()
_FORBIDDEN_PREFIXES = ("torch", "triton", "numpy", "np", "scipy", "einops",
                       "jax", "jaxlib", "stencil_tpu", "stencil_tpu_torch")


def _is_stdlib(mod: str) -> bool:
    top = mod.split(".")[0]
    if _STDLIB:
        return top in _STDLIB
    return not any(top == p or top.startswith(p + ".")
                   for p in _FORBIDDEN_PREFIXES)


def _pure_stdlib_applies(relpath: str) -> bool:
    p = _norm(relpath)
    return any(p == f or p.endswith("/" + f) for f in PURE_STDLIB_FILES)


@rule("pure-stdlib", severity="error", applies=_pure_stdlib_applies)
def check_pure_stdlib(ctx: FileContext) -> List[Finding]:
    """File-path-loaded modules (obs/watchdog, obs/ledger, obs/status)
    must import only the stdlib, at any nesting depth."""
    out: List[Finding] = []
    r = RULES["pure-stdlib"]

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                for alias in child.names:
                    if not _is_stdlib(alias.name):
                        out.append(ctx.finding(
                            r, child,
                            f"non-stdlib import {alias.name!r} in a "
                            f"pure-stdlib module (loaded by file path: "
                            f"importing it must never pull in "
                            f"torch/numpy/the package)"))
            elif isinstance(child, ast.ImportFrom):
                if child.level and child.level > 0:
                    out.append(ctx.finding(
                        r, child,
                        "relative import in a pure-stdlib module: the "
                        "file is loaded by file path, where no package "
                        "context exists"))
                elif child.module and not _is_stdlib(child.module):
                    out.append(ctx.finding(
                        r, child,
                        f"non-stdlib import {child.module!r} in a "
                        f"pure-stdlib module"))
            visit(child)

    visit(ctx.tree)
    return out


# -- rule: telemetry-vocab ----------------------------------------------------

_RECORD_NAME_ARG = {"counter": 0, "gauge": 0, "span": 0, "meta": 0,
                    "emit": 1}

_vocab_cache: Dict[str, frozenset] = {}


def parse_vocab(path: str) -> frozenset:
    """The metric names obs/telemetry.py sanctions, read from its source:
    the keys of the ``NAME_FIELDS`` dict literal and the string constants
    of the ``KNOWN_NAMES`` expression (its set literals)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    names: Set[str] = set()
    found: Set[str] = set()
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if not isinstance(t, ast.Name):
                continue
            if t.id == "NAME_FIELDS" and isinstance(node.value, ast.Dict):
                found.add(t.id)
                names.update(k.value for k in node.value.keys
                             if isinstance(k, ast.Constant) and isinstance(k.value, str))
            elif t.id == "KNOWN_NAMES":
                found.add(t.id)
                names.update(n.value for n in ast.walk(node.value)
                             if isinstance(n, ast.Constant) and isinstance(n.value, str))
    if found != {"NAME_FIELDS", "KNOWN_NAMES"}:
        raise ValueError(f"{path}: no NAME_FIELDS / KNOWN_NAMES vocabulary to read")
    return frozenset(names)


def telemetry_vocab(repo_root: Optional[str] = None) -> frozenset:
    """The sanctioned metric-name set: obs/telemetry.py of the tree at
    ``repo_root`` when it holds the package, else this package's own."""
    path = os.path.join(repo_root or "", TELEMETRY_FILE)
    if repo_root is None or not os.path.exists(path):
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "obs", "telemetry.py")
    if path not in _vocab_cache:
        _vocab_cache[path] = parse_vocab(path)
    return _vocab_cache[path]


@rule("telemetry-vocab", severity="error", applies=_library_code)
def check_telemetry_vocab(ctx: FileContext) -> List[Finding]:
    """Literal metric names at Recorder record sites (span/counter/
    gauge/meta/emit) must be in obs/telemetry's vocabulary; a typo'd name
    validates silently otherwise. Dynamically-built names are explicitly
    generic and exempt."""
    vocab = telemetry_vocab(ctx.repo_root)
    out: List[Finding] = []
    r = RULES["telemetry-vocab"]
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            continue
        idx = _RECORD_NAME_ARG.get(fn.attr)
        if idx is None or len(node.args) <= idx:
            continue
        arg = node.args[idx]
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            continue  # dynamic name: explicitly generic
        name = arg.value
        if name in vocab:
            continue
        out.append(ctx.finding(
            r, arg,
            f"metric name {name!r} is not in the telemetry vocabulary "
            f"(obs/telemetry NAME_FIELDS / KNOWN_NAMES): a typo here validates "
            f"silently and no dashboard will aggregate it — add the "
            f"name to the vocabulary or build it dynamically if generic"))
    return out


# -- rule: atomic-write -------------------------------------------------------


@rule("atomic-write", severity="error", applies=_not_tests)
def check_atomic_write(ctx: FileContext) -> List[Finding]:
    """json.dump through a plain ``open(path, "w")`` with no
    os.replace/os.rename in the same function: a crash mid-write leaves
    a torn artifact; use the repo's tmp+fsync+rename protocol."""
    out: List[Finding] = []
    r = RULES["atomic-write"]

    def scopes(node):
        """(scope node, body-walk excluding nested functions)."""
        own: List[ast.AST] = []
        stack = list(ast.iter_child_nodes(node))
        while stack:
            n = stack.pop()
            own.append(n)
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(n))
        yield node, own
        for n in own:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from scopes(n)

    for _scope, body in scopes(ctx.tree):
        opens = []
        dumps = []
        has_replace = False
        for n in body:
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Name) and f.id == "open":
                mode = None
                if len(n.args) > 1 and isinstance(n.args[1], ast.Constant):
                    mode = n.args[1].value
                for kw in n.keywords:
                    if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                        mode = kw.value.value
                if isinstance(mode, str) and mode.startswith("w"):
                    target = ast.unparse(n.args[0]) if n.args else ""
                    opens.append((n, target))
            elif isinstance(f, ast.Attribute):
                # .rename never exists on str; .replace does — only an
                # os/shutil receiver counts as the atomic protocol, or a
                # str.replace in scope would silence the rule (a pathlib
                # tmp.replace(path) reads as a finding to pragma, which
                # is visible — the false negative would not be)
                if f.attr == "rename" or (
                        f.attr == "replace"
                        and isinstance(f.value, ast.Name)
                        and f.value.id in ("os", "shutil")):
                    has_replace = True
                elif (f.attr == "dump" and isinstance(f.value, ast.Name)
                      and f.value.id == "json"):
                    dumps.append(n)
        if has_replace or not dumps:
            continue
        plain = [(n, t) for n, t in opens if "tmp" not in t.lower()]
        if not plain:
            continue
        for d in dumps:
            out.append(ctx.finding(
                r, d,
                f"json.dump through a plain open({plain[0][1]}, 'w') "
                f"with no os.replace/os.rename in scope: a crash "
                f"mid-write leaves a torn artifact — write to a .tmp "
                f"sibling, fsync, then os.replace (the ckpt/ledger/"
                f"status discipline)"))
    return out


# -- rule: no-bare-assert -----------------------------------------------------

_PUBLIC_DUNDERS = ("__init__", "__post_init__", "__call__")


@rule("no-bare-assert", severity="error", applies=_library_code)
def check_no_bare_assert(ctx: FileContext) -> List[Finding]:
    """``assert`` used for validation in a public library function
    vanishes under ``python -O``, silently accepting the bad input;
    raise ValueError/RuntimeError instead. Private helpers and nested
    functions may keep internal-invariant asserts; ``assert_*``-named
    checkers are exempt by design."""
    out: List[Finding] = []
    r = RULES["no-bare-assert"]

    # ``at_boundary`` tracks the lexical SCOPE, not the direct parent:
    # a def under a module-level if/try (feature gates, optional-dep
    # fallbacks) is just as public as one at the top level
    def visit(node, at_boundary: bool, boundary_fn: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
                public = (at_boundary
                          and (not name.startswith("_")
                               or name in _PUBLIC_DUNDERS)
                          and not name.startswith("assert"))
                visit(child, False, name if public else None)
            elif isinstance(child, ast.ClassDef):
                visit(child, True, None)
            elif isinstance(child, ast.Assert):
                if boundary_fn is not None:
                    out.append(ctx.finding(
                        r, child,
                        f"assert in public function {boundary_fn!r} "
                        f"vanishes under python -O: raise ValueError "
                        f"(bad argument) or RuntimeError (bad state) "
                        f"so the validation survives every interpreter "
                        f"mode"))
                visit(child, at_boundary, boundary_fn)
            else:
                visit(child, at_boundary, boundary_fn)

    visit(ctx.tree, True, None)
    return out


# -- rule: fstring-placeholder ------------------------------------------------

# a {placeholder} that looks like an expression (identifier head, then
# attribute/index/call trailers, optional !conversion / :format-spec)
_PLACEHOLDER_RE = re.compile(
    r"\{[A-Za-z_][A-Za-z0-9_]*"
    r"(?:\.[A-Za-z0-9_]+|\[[^\]{}]*\]|\(\))*"
    r"(?:![sra])?(?::[^{}]*)?\}"
)

_LOG_METHODS = ("debug", "info", "warn", "warning", "error", "fatal",
                "critical", "exception")


@rule("fstring-placeholder", severity="error", applies=_not_tests)
def check_fstring_placeholder(ctx: FileContext) -> List[Finding]:
    """A plain string containing ``{name}`` placeholders fed to raise or
    a log call without the f-prefix (a bug class this code has met): the reader
    gets the literal placeholder, not the value. ``.format()`` and
    ``{{`` escapes are recognized."""
    out: List[Finding] = []
    r = RULES["fstring-placeholder"]
    seen: Set[int] = set()

    def formatted_receivers(root) -> Set[int]:
        """ids of string constants that ARE formatted (x.format / x % y)."""
        done: Set[int] = set()
        for n in ast.walk(root):
            if (isinstance(n, ast.Attribute) and n.attr == "format"
                    and isinstance(n.value, ast.Constant)):
                done.add(id(n.value))
            if (isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mod)
                    and isinstance(n.left, ast.Constant)):
                done.add(id(n.left))
        return done

    def scan(root, where: str):
        done = formatted_receivers(root)
        for n in ast.walk(root):
            if isinstance(n, ast.JoinedStr):
                # the literal parts of an f-string are already formatted
                done.update(id(v) for v in ast.walk(n)
                            if isinstance(v, ast.Constant))
        for n in ast.walk(root):
            if not (isinstance(n, ast.Constant) and isinstance(n.value, str)):
                continue
            if id(n) in done or id(n) in seen:
                continue
            s = n.value
            if "{{" in s or "}}" in s:
                continue
            if _PLACEHOLDER_RE.search(s):
                seen.add(id(n))
                out.append(ctx.finding(
                    r, n,
                    f"string at a {where} site contains "
                    f"{{placeholder}} but is not an f-string: the "
                    f"reader gets the literal braces, not the value "
                    f"(add the f prefix or .format())"))

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Raise):
            scan(node, "raise")
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in _LOG_METHODS):
            for a in list(node.args) + [k.value for k in node.keywords]:
                scan(a, "log")
    return out


# -- rule: host-sync-in-hot-loop ----------------------------------------------

# The step-loop builders: the closures they build (the step or loop they
# return) run every step; their own bodies run once, at build time.
HOT_LOOP_BUILDERS = {
    "ops/jacobi.py": ("make_jacobi_loop", "make_jacobi_step", "make_batched_jacobi_loop"),
    "astaroth/integrate.py": ("make_astaroth_step", "make_fused_astaroth_loop",
                              "make_batched_astaroth_step"),
}
# The kernel wrappers: their bodies run at every launch.
KERNEL_WRAPPERS = {
    "ops/stencil_kernels.py": ("sweep", "multistep", "sweep_tenants", "sweep_region",
                               "sweep_positions", "sweep_regions"),
    "ops/halo_fill.py": ("self_fill", "wrap_fill_tenants"),
    "ops/remote_dma.py": ("remote_axis",),
    "ops/fused_stencil.py": ("fused_jacobi", "fused_exchange", "fused_jacobi_mesh"),
    "ops/persistent_stencil.py": ("persistent_jacobi", "persistent_jacobi_mesh"),
    "ops/astaroth_substep.py": ("substep", "substep_tasks", "substep_positions"),
}

_SYNC_ATTR_CALLS = ("item", "tolist", "cpu")
_SYNC_DOTTED = {
    ("np", "asarray"), ("np", "array"), ("numpy", "asarray"), ("numpy", "array"),
    ("torch", "cuda", "synchronize"), ("time", "time"),
}


def _dotted(fn) -> Tuple[str, ...]:
    parts: List[str] = []
    node = fn
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


def _seeds_for(relpath: str, table) -> Tuple[str, ...]:
    p = _norm(relpath)
    return tuple(n for f, names in table.items()
                 if p == f or p.endswith("/" + f) for n in names)


def _host_sync_applies(relpath: str) -> bool:
    return _not_tests(relpath) and bool(_seeds_for(relpath, HOT_LOOP_BUILDERS)
                                        or _seeds_for(relpath, KERNEL_WRAPPERS))


def _tensor_valued(expr) -> bool:
    """``float(x)`` / ``int(x)`` reads a tensor when ``x`` is an element
    (``t[i, j]``, not a ``.shape[i]``) or a method's result (``t.max()``,
    not ``len(...)``)."""
    if isinstance(expr, ast.Subscript):
        return not (isinstance(expr.value, ast.Attribute)
                    and expr.value.attr in ("shape", "stride"))
    return (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute)
            and expr.func.attr not in ("size", "dim", "numel", "element_size",
                                       "data_ptr", "get", "index", "count"))


@rule("host-sync-in-hot-loop", severity="error", applies=_host_sync_applies)
def check_host_sync(ctx: FileContext) -> List[Finding]:
    """Host syncs (``.item()``, ``.cpu()``, ``.tolist()``, ``float()`` or
    ``int()`` of a tensor, ``torch.cuda.synchronize``, ``np.asarray``,
    ``time.time()``) in the step loops and the kernel wrappers: a sync
    stalls the launch queue, so the card idles while the host waits. The
    hot code is the closures the loop builders return and the wrappers'
    bodies, by file and name, and every function of the file they reach
    (the CPU plain versions, ``*_plain``, excepted)."""
    out: List[Finding] = []
    r = RULES["host-sync-in-hot-loop"]

    defs: Dict[str, List[ast.AST]] = {}
    qual: Dict[int, str] = {}

    def index(node, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                index(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = (f"{cls}.{child.name}"
                        if isinstance(node, ast.ClassDef) else child.name)
                defs.setdefault(child.name, []).append(child)
                defs.setdefault(name, []).append(child)
                qual[id(child)] = name
                index(child, cls)
            else:
                index(child, cls)

    index(ctx.tree, None)

    def resolve_ref(expr) -> List[ast.AST]:
        """Function defs a name or ``self.method`` may refer to."""
        if isinstance(expr, ast.Lambda):
            return [expr]
        if isinstance(expr, ast.Name):
            return defs.get(expr.id, [])
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            return defs.get(expr.attr, [])
        return []

    hot: Set[int] = set()
    hot_nodes: List[ast.AST] = []

    def mark(fn_node):
        if getattr(fn_node, "name", "").endswith("_plain"):
            return  # a plain version runs on CPU tensors, where nothing waits
        if id(fn_node) not in hot:
            hot.add(id(fn_node))
            hot_nodes.append(fn_node)

    top = {id(n) for n in ctx.tree.body}
    for name in _seeds_for(ctx.relpath, KERNEL_WRAPPERS):
        for fn in defs.get(name, []):
            if id(fn) in top:
                mark(fn)
    for name in _seeds_for(ctx.relpath, HOT_LOOP_BUILDERS):
        for fn in defs.get(name, []):
            if id(fn) not in top:
                continue
            for n in ast.walk(fn):
                if n is not fn and isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                  ast.Lambda)):
                    mark(n)

    # propagate: a function referenced from hot code is hot
    i = 0
    while i < len(hot_nodes):
        t = hot_nodes[i]
        i += 1
        for n in ast.walk(t):
            if n is not t and isinstance(n, (ast.Name, ast.Attribute)):
                for ref in resolve_ref(n):
                    mark(ref)

    # scan hot bodies (their nested defs are scanned under their own entry)
    for t in hot_nodes:
        fname = qual.get(id(t), getattr(t, "name", "<lambda>"))
        stack = list(ast.iter_child_nodes(t))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)) and id(n) in hot:
                continue
            stack.extend(ast.iter_child_nodes(n))
            if not isinstance(n, ast.Call):
                continue
            name = _dotted(n.func)
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr in _SYNC_ATTR_CALLS and not n.args):
                out.append(ctx.finding(
                    r, n,
                    f".{n.func.attr}() inside hot function {fname!r}: a host "
                    f"sync in the step loop stalls the launch queue"))
            elif name in _SYNC_DOTTED:
                what = ".".join(name)
                why = ("a host clock in the step loop times the launch, not the "
                       "device work" if name[0] == "time"
                       else "it waits for the device")
                out.append(ctx.finding(
                    r, n, f"{what}() inside hot function {fname!r}: {why}"))
            elif (isinstance(n.func, ast.Name)
                  and n.func.id in ("float", "int") and n.args
                  and _tensor_valued(n.args[0])):
                out.append(ctx.finding(
                    r, n,
                    f"{n.func.id}() of a tensor inside hot function {fname!r}: "
                    f"a device-to-host read that waits for the device; keep "
                    f"the value on the device"))
    return out


# -- baseline -----------------------------------------------------------------


def assign_fingerprints(findings: Sequence[Finding]) -> List[Finding]:
    """Stable fingerprints: rule + file basename + line text + occurrence
    index — line-number-independent, so edits elsewhere in the file never
    invalidate a baseline entry."""
    counts: Dict[Tuple[str, str, str], int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.snippet)
        idx = counts.get(key, 0)
        counts[key] = idx + 1
        h = hashlib.sha1(
            "\x1f".join((f.rule, _norm(f.path), f.snippet,
                         str(idx))).encode()
        ).hexdigest()[:16]
        out.append(Finding(**{**f.__dict__, "fingerprint":
                              f"{f.rule}:{h}"}))
    return out


def load_baseline(path: str) -> Set[str]:
    """Fingerprint set from a committed baseline file. Missing file =
    empty baseline; a malformed one is a loud error (a torn baseline
    must not silently un-suppress or mask everything)."""
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("version") != 1 \
            or not isinstance(doc.get("fingerprints"), list):
        raise ValueError(
            f"{path}: not a v1 lint baseline "
            "({'version': 1, 'fingerprints': [...]})")
    return set(str(fp) for fp in doc["fingerprints"])


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    """Atomic baseline rewrite (the repo's own tmp+fsync+rename rule)."""
    doc = {"version": 1,
           "fingerprints": sorted(f.fingerprint for f in findings)}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# -- running the rules --------------------------------------------------------


def iter_py_files(paths: Sequence[str], repo_root: str) -> List[str]:
    """Expand files/dirs to .py files (repo-relative), excluding tests,
    caches, and native sources."""
    out: List[str] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(repo_root, p)
        if os.path.isfile(ap):
            if ap.endswith(".py"):
                out.append(ap)
            continue
        for root, dirs, files in os.walk(ap):
            dirs[:] = [d for d in sorted(dirs)
                       if d not in EXCLUDE_DIR_NAMES]
            for fn in sorted(files):
                if fn.endswith(".py"):
                    out.append(os.path.join(root, fn))
    uniq: List[str] = []
    seen: Set[str] = set()
    for ap in out:
        rel = _norm(os.path.relpath(ap, repo_root))
        if rel in seen or any(rel.startswith(pre)
                              for pre in EXCLUDE_PREFIXES):
            continue
        seen.add(rel)
        uniq.append(ap)
    return uniq


def lint_paths(paths: Sequence[str], repo_root: Optional[str] = None,
               rules: Optional[Sequence[str]] = None
               ) -> Tuple[List[Finding], List[str]]:
    """Lint files/dirs; returns (fingerprinted findings, engine errors).
    ``rules`` restricts to a subset (unknown names are an error)."""
    repo_root = repo_root or os.getcwd()
    if rules:
        unknown = sorted(set(rules) - set(RULES))
        if unknown:
            raise ValueError(f"unknown rule(s): {', '.join(unknown)}")
    active = [RULES[n] for n in (rules or sorted(RULES))]
    findings: List[Finding] = []
    errors: List[str] = []
    for ap in iter_py_files(paths, repo_root):
        rel = _norm(os.path.relpath(ap, repo_root))
        try:
            src = open(ap, encoding="utf-8").read()
            tree = ast.parse(src, filename=rel)
        except (OSError, SyntaxError, UnicodeDecodeError) as e:
            errors.append(f"{rel}: {type(e).__name__}: {e}")
            continue
        ctx = FileContext(relpath=rel, src=src,
                          lines=src.splitlines(), tree=tree, repo_root=repo_root)
        supp, bad = suppressions(ctx)
        findings.extend(bad)  # bad pragmas are never suppressible
        for r in active:
            if not r.applies(rel):
                continue
            try:
                got = r.check(ctx)
            except Exception as e:  # a broken rule must name itself
                errors.append(f"{rel}: rule {r.name} crashed: "
                              f"{type(e).__name__}: {e}")
                continue
            for f in got:
                if r.name in supp.get(f.line, set()):
                    continue
                findings.append(f)
    return assign_fingerprints(findings), errors
