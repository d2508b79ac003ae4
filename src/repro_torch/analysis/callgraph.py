"""Project-wide call graph over the port's AST, and the *hot set*
(counterpart of ``repro/analysis/callgraph.py``).

The host-sync rules only make sense on the serving hot path, so the
graph models how the port is wired: module functions, methods, nested
closures, ``self._fn = fn`` / ``self._fn = torch.compile(fn)`` aliases,
function-valued arguments to torch's transforms (``torch.compile``,
``torch.func.vmap`` / ``grad``, ``torch.vmap``,
``torch.utils.checkpoint.checkpoint``, ``functools.partial``),
``Fn.apply(...)`` of a ``torch.autograd.Function`` to its ``forward`` and
``backward``, and package re-exports (``engine.matmul`` resolves through
``repro_torch/engine/__init__.py`` to ``repro_torch.engine.api.matmul``).
A lambda's calls belong to the function that holds it, so
``ServingEngine.generate``'s ``_checked(lambda ...: self._decode_fn(...))``
reaches ``decode_step``.

The hot set is everything upstream *or* downstream of the roots.
"Compile targets" are the functions ``torch.compile`` wraps (the JAX
package's jit targets).
"""
from __future__ import annotations

import ast
import dataclasses
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

DEFAULT_HOT_ROOTS: Tuple[str, ...] = (
    "repro_torch.models.lm.decode_step",
    "repro_torch.serving.scheduler.ContinuousScheduler.run",
    "repro_torch.serving.engine.ServingEngine.generate",
    "repro_torch.serving.engine.ServingEngine.prefill_step",
    "repro_torch.engine.api.matmul",
)

# transforms whose function-valued arguments become call edges; the
# value is the positions holding functions
_BODY_ARG_TRANSFORMS = {
    "compile": (0,), "vmap": (0,), "grad": (0,), "grad_and_value": (0,),
    "checkpoint": (0,), "partial": (0,),
}
_TRANSFORM_PREFIXES = ("torch.", "functools.")
COMPILE = "torch.compile"


def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None for anything fancier."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


@dataclasses.dataclass
class FunctionInfo:
    qualname: str
    module: str
    node: ast.AST
    class_qual: Optional[str] = None      # enclosing class, if a method
    is_compile_target: bool = False


class CallGraph:
    def __init__(self) -> None:
        self.functions: Dict[str, FunctionInfo] = {}
        self.edges: Dict[str, Set[str]] = {}
        self.redges: Dict[str, Set[str]] = {}
        self.imports: Dict[str, Dict[str, str]] = {}
        self.compiled_self_aliases: Dict[str, Set[str]] = {}
        self.self_aliases: Dict[str, Dict[str, str]] = {}

    # -- construction ---------------------------------------------------
    def add_function(self, info: FunctionInfo) -> None:
        self.functions[info.qualname] = info

    def add_edge(self, src: str, dst: str) -> None:
        self.edges.setdefault(src, set()).add(dst)

    def canonical(self, qual: str) -> str:
        """Chase package re-exports: ``repro_torch.engine.matmul`` ->
        ``repro_torch.engine.api.matmul`` when
        ``repro_torch/engine/__init__`` binds the name."""
        for _ in range(8):
            if qual in self.functions:
                return qual
            parts = qual.split(".")
            rebound = None
            for cut in range(len(parts) - 1, 0, -1):
                mod = ".".join(parts[:cut])
                binding = self.imports.get(mod, {}).get(parts[cut])
                if binding is not None:
                    rebound = ".".join([binding] + parts[cut + 1:])
                    break
            if rebound is None or rebound == qual:
                return qual
            qual = rebound
        return qual

    def finalize(self) -> None:
        self.edges = {src: {self.canonical(d) for d in dsts}
                      for src, dsts in self.edges.items()}
        self.redges = {}
        for src, dsts in self.edges.items():
            for d in dsts:
                self.redges.setdefault(d, set()).add(src)

    # -- queries --------------------------------------------------------
    def match(self, root: str) -> List[str]:
        return [q for q in self.functions
                if q == root or q.endswith("." + root)]

    def hot_set(self, roots: Sequence[str]) -> frozenset:
        seeds = [q for r in roots for q in self.match(r)]
        hot: Set[str] = set(seeds)
        for rel in (self.edges, self.redges):
            frontier = deque(seeds)
            seen = set(seeds)
            while frontier:
                cur = frontier.popleft()
                for nxt in rel.get(cur, ()):
                    if nxt not in seen:
                        seen.add(nxt)
                        frontier.append(nxt)
            hot |= seen
        return frozenset(hot)

    def is_compile_target(self, qual: str) -> bool:
        info = self.functions.get(qual)
        return bool(info and info.is_compile_target)


def _import_map(tree: ast.Module, module: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = module.split(".")
                base_parts = parts[:len(parts) - node.level]
                if node.module:
                    base_parts.append(node.module)
                base = ".".join(base_parts)
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{base}.{a.name}" if base \
                    else a.name
    return out


def wrapped_calls(value: ast.AST) -> Iterable[ast.Call]:
    """Call nodes inside an assignment value, looking through a
    conditional expression (``torch.compile(f) if flag else f``)."""
    if isinstance(value, ast.Call):
        yield value
    elif isinstance(value, ast.IfExp):
        yield from wrapped_calls(value.body)
        yield from wrapped_calls(value.orelse)


def full_name(imports: Dict[str, str], chain: List[str]) -> str:
    """Expand the head of an attribute chain through a module's import
    map (``F.softmax`` -> ``torch.nn.functional.softmax``)."""
    head = imports.get(chain[0], chain[0])
    return ".".join([head] + chain[1:])


class _ModuleScanner:
    """Registers functions / methods / nested closures of one module."""

    def __init__(self, graph: CallGraph, module: str, tree: ast.Module):
        self.graph = graph
        self.module = module
        self.tree = tree
        self.graph.imports[module] = _import_map(tree, module)

    def full_name(self, chain: List[str]) -> str:
        return full_name(self.graph.imports[self.module], chain)

    def scan(self) -> None:
        self._walk_body(self.tree.body, scope=self.module, class_qual=None)

    def _walk_body(self, body: Sequence[ast.stmt], scope: str,
                   class_qual: Optional[str]) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{scope}.{node.name}"
                info = FunctionInfo(qualname=qual, module=self.module,
                                    node=node, class_qual=class_qual)
                info.is_compile_target = self._decorated_compile(node)
                self.graph.add_function(info)
                self._walk_body(node.body, scope=qual,
                                class_qual=class_qual)
            elif isinstance(node, ast.ClassDef):
                cqual = f"{scope}.{node.name}"
                self._walk_body(node.body, scope=cqual, class_qual=cqual)
            else:
                for sub in ast.walk(node):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        # e.g. a def inside an if-block
                        qual = f"{scope}.{sub.name}"
                        self.graph.add_function(FunctionInfo(
                            qualname=qual, module=self.module, node=sub,
                            class_qual=class_qual))

    def _decorated_compile(self, node: ast.AST) -> bool:
        """``@torch.compile``, ``@torch.compile(...)`` or
        ``@functools.partial(torch.compile, ...)``."""
        for dec in getattr(node, "decorator_list", []):
            chain = attr_chain(dec.func if isinstance(dec, ast.Call)
                               else dec)
            if not chain:
                continue
            full = self.full_name(chain)
            if full == COMPILE:
                return True
            if isinstance(dec, ast.Call) and full.endswith("partial") \
                    and dec.args:
                inner = attr_chain(dec.args[0])
                if inner and self.full_name(inner) == COMPILE:
                    return True
        return False


def _collect_self_aliases(graph: CallGraph, scanner: _ModuleScanner
                          ) -> None:
    for qual, info in list(graph.functions.items()):
        if info.module != scanner.module or info.class_qual is None:
            continue
        for node in ast.walk(info.node):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1):
                continue
            tgt = node.targets[0]
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            targets: List[Tuple[str, bool]] = []
            if isinstance(node.value, ast.Name):
                targets.append((node.value.id, False))
            for call in wrapped_calls(node.value):
                chain = attr_chain(call.func)
                if not chain:
                    continue
                full = scanner.full_name(chain)
                if full == COMPILE or full.endswith("partial"):
                    for arg in call.args[:1]:
                        inner = attr_chain(arg)
                        if inner and len(inner) == 1:
                            targets.append((inner[0], full == COMPILE))
            for name, compiled in targets:
                resolved = _resolve_local(graph, info, name)
                if resolved is None:
                    continue
                cls = info.class_qual
                graph.self_aliases.setdefault(cls, {})[tgt.attr] = resolved
                if compiled:
                    graph.compiled_self_aliases.setdefault(cls, set()).add(
                        tgt.attr)
                    if resolved in graph.functions:
                        graph.functions[resolved].is_compile_target = True


def _resolve_local(graph: CallGraph, info: FunctionInfo, name: str
                   ) -> Optional[str]:
    """Resolve a bare name from inside ``info``: nested defs in the
    enclosing scope chain, then module-level functions, then imports."""
    scope = info.qualname
    while True:
        cand = f"{scope}.{name}"
        if cand in graph.functions:
            return cand
        if "." not in scope:
            break
        scope = scope.rsplit(".", 1)[0]
        if scope == info.module:
            break
    cand = f"{info.module}.{name}"
    if cand in graph.functions:
        return cand
    return graph.imports.get(info.module, {}).get(name)


def _local_instances(graph: CallGraph, scanner: _ModuleScanner,
                     info: FunctionInfo, class_quals: Set[str]
                     ) -> Dict[str, str]:
    """Locals bound to instances of known classes
    (``eng = ServingEngine(...)`` -> calls on ``eng`` resolve to its
    methods)."""
    out: Dict[str, str] = {}
    stack = list(ast.iter_child_nodes(info.node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call):
            chain = attr_chain(node.value.func)
            if chain and len(chain) == 1:
                binding = graph.imports[scanner.module].get(chain[0])
                for cand in (binding, f"{scanner.module}.{chain[0]}"):
                    if cand in class_quals:
                        out[node.targets[0].id] = cand
                        break
        stack.extend(ast.iter_child_nodes(node))
    return out


def _transform_edges(graph: CallGraph, info: FunctionInfo, qual: str,
                     call: ast.Call, full: str) -> bool:
    """Edges to the function-valued arguments of a torch / functools
    transform; True when ``call`` was one."""
    leaf = full.split(".")[-1]
    if leaf not in _BODY_ARG_TRANSFORMS or \
            not full.startswith(_TRANSFORM_PREFIXES):
        return False
    for pos in _BODY_ARG_TRANSFORMS[leaf]:
        if pos < len(call.args):
            inner = attr_chain(call.args[pos])
            if inner and len(inner) == 1:
                resolved = _resolve_local(graph, info, inner[0])
                if resolved:
                    graph.add_edge(qual, resolved)
                    if full == COMPILE and resolved in graph.functions:
                        graph.functions[resolved].is_compile_target = True
    return True


def _collect_calls(graph: CallGraph, scanner: _ModuleScanner) -> None:
    class_quals = {f.class_qual for f in graph.functions.values()
                   if f.class_qual}
    for qual, info in graph.functions.items():
        if info.module != scanner.module:
            continue
        instances = _local_instances(graph, scanner, info, class_quals)
        for call in iter_calls(info.node):
            chain = attr_chain(call.func)
            if chain is None:
                continue
            if chain[0] in instances and len(chain) >= 2:
                graph.add_edge(qual, f"{instances[chain[0]]}.{chain[1]}")
                continue
            if chain[0] == "self" and len(chain) >= 2 and info.class_qual:
                alias = graph.self_aliases.get(info.class_qual, {})
                target = alias.get(chain[1],
                                   f"{info.class_qual}.{chain[1]}")
                graph.add_edge(qual, target)
                continue
            full = scanner.full_name(chain)
            if _transform_edges(graph, info, qual, call, full):
                continue
            if len(chain) == 1:
                resolved = _resolve_local(graph, info, chain[0])
                if resolved:
                    graph.add_edge(qual, resolved)
                continue
            binding = graph.imports[scanner.module].get(chain[0])
            # unbound head: maybe a module-level class, Cls.method(...)
            base = binding if binding is not None \
                else f"{scanner.module}.{chain[0]}"
            target = ".".join([base] + chain[1:])
            if chain[-1] == "apply" and len(chain) >= 2:
                # Fn.apply(...) of an autograd Function runs its forward
                # (and, under autograd, its backward)
                cls = ".".join([base] + chain[1:-1])
                for method in ("forward", "backward"):
                    graph.add_edge(qual, f"{cls}.{method}")
            graph.add_edge(qual, target)


def iter_calls(fn_node: ast.AST) -> Iterable[ast.Call]:
    """Call nodes belonging to ``fn_node``: descends into lambdas and
    plain statements but not into nested def/class (separate
    functions)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def build_graph(trees: Dict[str, ast.Module]) -> CallGraph:
    graph = CallGraph()
    scanners = []
    for module, tree in trees.items():
        scanner = _ModuleScanner(graph, module, tree)
        scanner.scan()
        scanners.append(scanner)
    for scanner in scanners:
        _collect_self_aliases(graph, scanner)
    for scanner in scanners:
        _collect_calls(graph, scanner)
    graph.finalize()
    return graph
