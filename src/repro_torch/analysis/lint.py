"""AST lint framework for the port's hot-path checkers (counterpart of
``repro/analysis/lint.py``).

Checkers are small classes registered in a string-keyed registry
(``register_checker`` / ``get_checker`` / ``available_checkers``), as the
engine's substrates are, and ``lint_paths`` drives all of them over a
parsed project.

Findings carry a stable rule id (``RPR...``, the JAX package's ids where
the meaning carries over), a path, and an exact line/column. A finding
is suppressed by putting

    # repro-lint: disable=RPR101
    # repro-lint: disable=RPR101,RPR401
    # repro-lint: disable=all

on the flagged line or on the line directly above it, with the reason
beside it, so every sanctioned violation is documented in place.

No torch imports here: the lint pass runs on a bare Python install.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis import callgraph

# Rule ids -> one-line summaries of what each means on the card (the
# README rule table comes from the same registry via ``--list-rules``).
RULES: Dict[str, str] = {
    "RPR101": "host read in a hot-path function: a device->host read "
              "(.item()/.tolist()/.cpu()/.numpy()/.to('cpu'), float()/"
              "int()/bool() of a tensor, np.asarray() of a tensor) or a "
              "host->device copy (torch.tensor/torch.as_tensor of host "
              "data with device=); either blocks the host on the card",
    "RPR102": "truthiness of a tensor (if/while/assert) in a hot-path "
              "function: a blocking device->host read on the card",
    "RPR201": "torch.compile(f)(...) per call (a fresh compiled wrapper "
              "every call; nothing is cached)",
    "RPR202": "Python branch on a tensor value inside a torch.compile "
              "target (a graph break)",
    "RPR203": "iteration over a set builds containers (tree / cache-key "
              "order is nondeterministic across processes)",
    "RPR301": "dataclass with torch.Tensor fields that the port's tree "
              "walkers (repro_torch.tree, engine.mesh placement, "
              "engine.persist) cannot walk (derive from core.pim.Plan or "
              "use a NamedTuple)",
    "RPR401": "kernel wrapper passes .data_ptr() of a tensor whose dtype "
              "and contiguity it neither produced (torch.empty/zeros/"
              ".contiguous()) nor checked to a ctypes entry point",
    "RPR402": "fallback to the plain version: a library `device` "
              "parameter defaulting to 'cpu', or an except around a "
              "kernel launch / runtime.load_library that does not raise "
              "(a CUDA failure would silently run the plain version)",
    "RPR501": "JAX substrate alias ('exact-pallas', 'exact-jnp', "
              "'analog-pallas') written as a literal outside its "
              "resolution site (core/pim.py); use the port's names",
}

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Za-z0-9,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


@dataclasses.dataclass
class ModuleInfo:
    """One parsed source file."""

    name: str                    # dotted name, e.g. repro_torch.core.pim
    path: str
    tree: ast.Module
    lines: List[str]
    # module-level integer constants (NAME = <int>)
    int_constants: Dict[str, int] = dataclasses.field(default_factory=dict)

    def suppressed(self, line: int) -> frozenset:
        """Rule ids suppressed at ``line`` (same line or the line
        directly above)."""
        out: set = set()
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines):
                m = _SUPPRESS_RE.search(self.lines[ln - 1])
                if m:
                    out.update(p.strip() for p in m.group(1).split(","))
        return frozenset(out)


@dataclasses.dataclass
class Project:
    """Parsed modules plus the call-graph context checkers consume."""

    modules: Dict[str, ModuleInfo]
    graph: callgraph.CallGraph
    hot: frozenset                # qualnames in the hot set
    assume_hot: bool = False      # fixture mode: every function is hot

    def is_hot(self, qualname: str) -> bool:
        return self.assume_hot or qualname in self.hot


class Checker:
    """Base checker. Subclasses set ``name``/``rules`` and implement
    ``check`` yielding :class:`Finding` for one module."""

    name: str = ""
    rules: Tuple[str, ...] = ()

    def check(self, project: Project,
              module: ModuleInfo) -> Iterable[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Checker] = {}


def register_checker(checker: Checker, *, name: Optional[str] = None
                     ) -> Checker:
    """Register a checker instance under ``name`` (defaults to
    ``checker.name``)."""
    key = name or checker.name
    if not key:
        raise ValueError("checker needs a name")
    unknown = [r for r in checker.rules if r not in RULES]
    if unknown:
        raise ValueError(f"checker {key!r} declares unknown rules "
                         f"{unknown}; add them to lint.RULES")
    _REGISTRY[key] = checker
    return checker


def get_checker(name: str) -> Checker:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown checker {name!r}; available: "
            f"{', '.join(available_checkers())}") from None


def available_checkers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _ensure_builtin_checkers() -> None:
    # registration is an import side effect, as for the built-in
    # substrates
    from repro_torch.analysis import checkers as _checkers  # noqa: F401


# ---------------------------------------------------------------------------
# Project loading
# ---------------------------------------------------------------------------
def _module_name(path: Path, root: Path) -> str:
    """Dotted module name for ``path``: files under a ``src/`` directory
    are named from below it (src/repro_torch/core/pim.py ->
    repro_torch.core.pim), everything else relative to ``root``
    (examples/torch/quickstart.py -> examples.torch.quickstart)."""
    rel = path.resolve().relative_to(root.resolve())
    parts = list(rel.with_suffix("").parts)
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _collect_files(paths: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            files.append(path)
    return files


def _module_info(name: str, path: str, source: str) -> ModuleInfo:
    tree = ast.parse(source, filename=path)
    info = ModuleInfo(name=name, path=path, tree=tree,
                      lines=source.splitlines())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)
                and not isinstance(node.value.value, bool)):
            info.int_constants[node.targets[0].id] = node.value.value
    return info


def load_module(path: Path, root: Path) -> ModuleInfo:
    return _module_info(_module_name(path, root), str(path),
                        path.read_text())


def build_project(paths: Sequence[str], root: Optional[str] = None,
                  hot_roots: Sequence[str] = callgraph.DEFAULT_HOT_ROOTS,
                  ) -> Project:
    rootp = Path(root) if root else Path.cwd()
    modules: Dict[str, ModuleInfo] = {}
    for f in _collect_files(paths):
        info = load_module(f, rootp)
        modules[info.name] = info
    graph = callgraph.build_graph(
        {m.name: m.tree for m in modules.values()})
    hot = graph.hot_set(hot_roots)
    return Project(modules=modules, graph=graph, hot=hot)


def _run_checkers(project: Project, select: Optional[Sequence[str]],
                  ignore: Optional[Sequence[str]]) -> List[Finding]:
    _ensure_builtin_checkers()
    findings: List[Finding] = []
    for name in available_checkers():
        checker = get_checker(name)
        for module in project.modules.values():
            for f in checker.check(project, module):
                if select and f.rule not in select:
                    continue
                if ignore and f.rule in ignore:
                    continue
                sup = module.suppressed(f.line)
                if "all" in sup or f.rule in sup:
                    continue
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_paths(paths: Sequence[str], root: Optional[str] = None,
               select: Optional[Sequence[str]] = None,
               ignore: Optional[Sequence[str]] = None,
               hot_roots: Sequence[str] = callgraph.DEFAULT_HOT_ROOTS,
               ) -> List[Finding]:
    """Lint every ``.py`` file under ``paths`` and return sorted
    findings. The call graph (and therefore the hot set for the
    host-sync rules) is built from exactly these files."""
    project = build_project(paths, root=root, hot_roots=hot_roots)
    return _run_checkers(project, select, ignore)


def lint_source(source: str, module: str = "fixture",
                assume_hot: bool = True,
                select: Optional[Sequence[str]] = None,
                ignore: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one in-memory snippet (test fixtures). ``assume_hot`` treats
    every function as hot-path so host-sync fixtures need no call
    graph."""
    info = _module_info(module, f"<{module}>", source)
    graph = callgraph.build_graph({module: info.tree})
    project = Project(modules={module: info}, graph=graph,
                      hot=graph.hot_set(callgraph.DEFAULT_HOT_ROOTS),
                      assume_hot=assume_hot)
    return _run_checkers(project, select, ignore)
