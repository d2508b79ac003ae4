"""The port's checkers (counterpart of ``repro/analysis/checkers.py``).
Importing this module registers them all.

Taint model (shared by the host-sync and graph-break checkers): inside
one function, a value is *device* when it comes from a ``torch.`` call
(``torch.nn.functional`` included; not the host-side members such as
``torch.device`` or ``torch.cuda.is_available``), from a method of a
device value (``x.sum()``, ``logits.argmax(-1)``), from calling a
``torch.compile`` alias, or from a name such a value was assigned /
unpacked / iterated into. Shapes, dtypes, ``.device`` and the like are
host metadata, and ``.item()`` / ``.cpu()`` / ``.numpy()`` return host
values. Function parameters are *not* tainted: cross-function taint is
out of scope, which keeps the pass quiet enough to gate CI.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from repro_torch.analysis import callgraph
from repro_torch.analysis.callgraph import attr_chain
from repro_torch.analysis.lint import (Checker, Finding, ModuleInfo, Project,
                                       register_checker)

# tensor attributes that are host values, not tensors
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "is_cpu",
                 "is_meta", "layout", "requires_grad", "is_leaf", "names",
                 "itemsize", "nbytes", "grad_fn"}
# tensor methods that return host values without reading the data
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                   "stride", "storage_offset", "data_ptr", "is_contiguous",
                   "get_device", "is_floating_point", "is_complex",
                   "type", "__len__"}
# builtins that never return device values regardless of their arguments
_HOST_BUILTINS = {"len", "range", "enumerate", "zip", "str", "repr",
                  "isinstance", "type", "id", "print", "sorted",
                  "reversed", "format", "hash", "getattr", "hasattr",
                  "callable"}
_SYNC_BUILTINS = ("float", "int", "bool", "complex")
# device -> host reads
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
# host -> device copies when given host data and a device
_H2D_FACTORIES = ("torch.tensor", "torch.as_tensor")
# torch.* members that return host objects
_TORCH_HOST_MEMBERS = {
    "device", "dtype", "Size", "is_tensor", "is_floating_point",
    "is_complex", "promote_types", "finfo", "iinfo", "get_default_dtype",
    "no_grad", "inference_mode", "enable_grad", "set_grad_enabled",
    "is_grad_enabled", "manual_seed", "Generator", "compile",
    "broadcast_shapes", "result_type", "can_cast", "cuda", "backends",
    "distributed", "profiler", "overrides", "utils", "autograd", "testing",
    "library", "jit", "get_device", "use_deterministic_algorithms",
    "are_deterministic_algorithms_enabled", "get_num_threads",
    "set_num_threads"}
_HOST_MODULES = ("np", "numpy", "math", "time", "os", "ctypes", "json",
                 "hashlib", "struct")
# torch.* calls that read their tensors' values into a host bool
_READ_FUNCS = ("torch.equal", "torch.allclose")
# return annotations made of these names are host values
_HOST_TYPES = {"int", "float", "bool", "str", "None", "List", "Tuple",
               "Dict", "Sequence", "Optional", "list", "tuple", "dict"}


def _is_device_call(full: str) -> bool:
    parts = full.split(".")
    return parts[0] == "torch" and len(parts) >= 2 and \
        parts[1] not in _TORCH_HOST_MEMBERS


def _is_cpu_literal(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    if isinstance(node, ast.Call) and attr_chain(node.func) in (
            ["torch", "device"], ["device"]) and node.args:
        return _is_cpu_literal(node.args[0])
    return False


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` /
    ``x.to(torch.device("cpu"))``."""
    return any(_is_cpu_literal(a) for a in call.args[:1]) or any(
        k.arg == "device" and _is_cpu_literal(k.value)
        for k in call.keywords)


class _FunctionTaint:
    """Per-function forward taint over locally derived device values."""

    def __init__(self, fn: ast.AST, module: ModuleInfo, project: Project,
                 class_qual: Optional[str]):
        self.fn = fn
        self.module = module
        self.project = project
        self.imports = project.graph.imports.get(module.name, {})
        self.graph = project.graph
        self.class_qual = class_qual
        self.compiled_attrs = project.graph.compiled_self_aliases.get(
            class_qual or "", set())
        self.tainted: Set[str] = set()
        self._local_compiled = self._find_local_compiled()
        self._compute()

    # -- setup ----------------------------------------------------------
    def full(self, chain: List[str]) -> str:
        return callgraph.full_name(self.imports, chain)

    def _host_returning(self, chain: List[str]) -> bool:
        """Whether ``chain`` names a project function annotated to return
        host values only (``-> List[int]``, ``-> bool``, ...)."""
        if chain[0] == "self" and len(chain) == 2 and self.class_qual:
            qual = f"{self.class_qual}.{chain[1]}"
        elif len(chain) == 1 and f"{self.module.name}.{chain[0]}" in \
                self.graph.functions:
            qual = f"{self.module.name}.{chain[0]}"
        else:
            qual = self.full(chain)
        info = self.graph.functions.get(self.graph.canonical(qual))
        returns = getattr(info.node, "returns", None) if info else None
        if returns is None:
            return False
        names = {n.id for n in ast.walk(returns) if isinstance(n, ast.Name)}
        consts = [n for n in ast.walk(returns) if isinstance(n, ast.Constant)
                  and n.value is not None and n.value is not Ellipsis]
        return bool(names) and names <= _HOST_TYPES and not consts and \
            not any(isinstance(n, ast.Attribute) for n in ast.walk(returns))

    def _find_local_compiled(self) -> Set[str]:
        """Names bound to ``torch.compile(...)`` results inside this
        function (calls through them return device values)."""
        out: Set[str] = set()
        for node in self.stmts():
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                for call in callgraph.wrapped_calls(node.value):
                    chain = attr_chain(call.func)
                    if chain and self.full(chain) == callgraph.COMPILE:
                        out.add(node.targets[0].id)
        return out

    def stmts(self) -> Iterable[ast.AST]:
        """All nodes of this function, not descending into nested defs
        (separate functions) but descending into lambdas."""
        stack = list(ast.iter_child_nodes(self.fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    # -- taint ----------------------------------------------------------
    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            return self._call_tainted(node)
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # identity / membership tests yield host bools (no read)
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.is_tainted(node.left) or any(
                self.is_tainted(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return (self.is_tainted(node.elt) or
                    any(self.is_tainted(g.iter) for g in node.generators))
        return False

    def _call_tainted(self, node: ast.Call) -> bool:
        chain = attr_chain(node.func)
        if chain is not None:
            if len(chain) == 1 and chain[0] in _HOST_BUILTINS:
                return False
            if len(chain) == 1 and chain[0] in _SYNC_BUILTINS:
                return False          # result is a host scalar
            full = self.full(chain)
            if full.split(".")[0] in _HOST_MODULES or full in _READ_FUNCS:
                return False
            if self._host_returning(chain):
                return False
            if _is_device_call(full):
                return True
            if full.split(".")[0] == "torch":
                return False          # a host-side torch member
            if chain[0] == "self" and len(chain) >= 2 \
                    and chain[1] in self.compiled_attrs:
                return True
            if chain[0] in self._local_compiled:
                return True
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _SYNC_METHODS or attr in _STATIC_METHODS or (
                    attr == "to" and _to_cpu(node)):
                return False          # host value
            # a method of a device value returns a device value
            # (logits.argmax(-1), x.to(torch.int64), plan.apply(...))
            if self.is_tainted(node.func.value):
                return True
        # unknown callable: propagate through arguments (min/max of
        # device values stay device values)
        return any(self.is_tainted(a) for a in node.args)

    def _taint_target(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._taint_target(e)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value)

    def _compute(self) -> None:
        for _ in range(4):            # fixpoint over loop-carried taint
            before = len(self.tainted)
            for node in self.stmts():
                if isinstance(node, ast.Assign):
                    if self.is_tainted(node.value):
                        for t in node.targets:
                            self._taint_target(t)
                elif isinstance(node, ast.AnnAssign) and node.value:
                    if self.is_tainted(node.value):
                        self._taint_target(node.target)
                elif isinstance(node, ast.AugAssign):
                    if self.is_tainted(node.value):
                        self._taint_target(node.target)
                elif isinstance(node, ast.For):
                    if self.is_tainted(node.iter):
                        self._taint_target(node.target)
                elif isinstance(node, ast.NamedExpr):
                    if self.is_tainted(node.value):
                        self._taint_target(node.target)
                elif isinstance(node, ast.withitem):
                    if node.optional_vars is not None and \
                            self.is_tainted(node.context_expr):
                        self._taint_target(node.optional_vars)
                elif isinstance(node, ast.comprehension):
                    if self.is_tainted(node.iter):
                        self._taint_target(node.target)
                elif isinstance(node, ast.Expr) and \
                        isinstance(node.value, ast.Call):
                    # container.append(device_value) taints the container
                    call = node.value
                    chain = attr_chain(call.func)
                    if chain and len(chain) == 2 and chain[-1] in (
                            "append", "extend", "insert", "add") and \
                            any(self.is_tainted(a) for a in call.args):
                        self.tainted.add(chain[0])
            if len(self.tainted) == before:
                break


def _functions_of(module: ModuleInfo, project: Project
                  ) -> Iterable[Tuple[str, callgraph.FunctionInfo]]:
    for qual, info in project.graph.functions.items():
        if info.module == module.name:
            yield qual, info


# ---------------------------------------------------------------------------
class HostSyncChecker(Checker):
    """RPR101/RPR102: blocking host reads on the hot path, both ways.

    On the card a read of a tensor's value (``.item()``, ``bool(t)``,
    ``.cpu()``) waits for every queued launch, and a tensor made from host
    data on the device (``torch.tensor(x, device=dev)``) is a pageable
    copy that waits too. The serving engine's one copy per dispatch is
    the sanctioned read, suppressed in place.
    """

    name = "host-sync"
    rules = ("RPR101", "RPR102")

    def check(self, project: Project, module: ModuleInfo
              ) -> Iterable[Finding]:
        for qual, info in _functions_of(module, project):
            if not project.is_hot(qual):
                continue
            taint = _FunctionTaint(info.node, module, project,
                                   info.class_qual)
            yield from self._check_fn(project, module, qual, taint)

    def _read(self, module, node, what, short) -> Finding:
        return Finding("RPR101", module.path, node.lineno, node.col_offset,
                       f"{what} in hot-path function `{short}` is a "
                       "blocking device->host read on the card")

    def _check_fn(self, project, module, qual, taint
                  ) -> Iterable[Finding]:
        short = qual.rsplit(".", 1)[-1]
        compiled = project.graph.is_compile_target(qual)
        for node in taint.stmts():
            if isinstance(node, ast.Call):
                yield from self._check_call(module, node, taint, short)
            elif isinstance(node, (ast.If, ast.While)) and not compiled:
                if taint.is_tainted(node.test):
                    yield Finding(
                        "RPR102", module.path, node.lineno,
                        node.col_offset,
                        "truthiness of a tensor in hot-path function "
                        f"`{short}` is a blocking device->host read; keep "
                        "the decision on the device (torch.where)")
            elif isinstance(node, ast.Assert) and not compiled:
                if taint.is_tainted(node.test):
                    yield Finding(
                        "RPR102", module.path, node.lineno,
                        node.col_offset,
                        f"assert on a tensor in hot-path function `{short}`"
                        " is a blocking device->host read; move the check "
                        "off the hot path")

    def _check_call(self, module, node, taint, short) -> Iterable[Finding]:
        func = node.func
        chain = attr_chain(func)
        if isinstance(func, ast.Attribute) and (
                func.attr in _SYNC_METHODS
                or (func.attr == "to" and _to_cpu(node))) and \
                taint.is_tainted(func.value):
            yield self._read(module, node, f".{func.attr}() of a tensor",
                             short)
            return
        if chain is None:
            return
        if len(chain) == 1 and chain[0] in _SYNC_BUILTINS and \
                any(taint.is_tainted(a) for a in node.args):
            yield self._read(module, node, f"{chain[0]}() of a tensor",
                             short)
            return
        full = taint.full(chain)
        if full in _READ_FUNCS:
            yield self._read(module, node, f"{'.'.join(chain)}()", short)
        elif full in ("numpy.asarray", "numpy.array", "numpy.copy") and \
                node.args and taint.is_tainted(node.args[0]):
            yield self._read(module, node,
                             f"{'.'.join(chain)}() of a tensor", short)
        elif full in _H2D_FACTORIES and node.args and \
                not taint.is_tainted(node.args[0]) and \
                any(k.arg == "device" for k in node.keywords):
            yield Finding(
                "RPR101", module.path, node.lineno, node.col_offset,
                f"{'.'.join(chain)}() of host data with device= in "
                f"hot-path function `{short}` is a host->device copy that "
                "blocks the host on the card; pass a Python scalar to the "
                "op (torch.where, masked_fill) or build it once outside "
                "the hot path")


# ---------------------------------------------------------------------------
class RecompileChecker(Checker):
    """RPR201/RPR202/RPR203: a compiled wrapper made per call, graph
    breaks inside a compile target, and nondeterministic container
    order."""

    name = "recompile"
    rules = ("RPR201", "RPR202", "RPR203")

    def check(self, project: Project, module: ModuleInfo
              ) -> Iterable[Finding]:
        imports = project.graph.imports.get(module.name, {})
        for qual, info in _functions_of(module, project):
            taint = None
            compiled = project.graph.is_compile_target(qual)
            for node in ast.walk(info.node):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Call):
                    chain = attr_chain(node.func.func)
                    if chain is not None and callgraph.full_name(
                            imports, chain) == callgraph.COMPILE:
                        yield Finding(
                            "RPR201", module.path, node.lineno,
                            node.col_offset,
                            "torch.compile(...) invoked immediately: the "
                            "compiled wrapper is made anew every call, so "
                            "nothing is cached; bind it once and reuse it")
                if isinstance(node, (ast.If, ast.While)) and compiled:
                    if taint is None:
                        taint = _FunctionTaint(info.node, module, project,
                                               info.class_qual)
                    if taint.is_tainted(node.test):
                        yield Finding(
                            "RPR202", module.path, node.lineno,
                            node.col_offset,
                            "Python branch on a tensor value inside "
                            f"torch.compile target `{qual.rsplit('.', 1)[-1]}`"
                            " is a graph break; use torch.where or hoist "
                            "the branch out of the compiled function")
        # set-iteration hazards are structural, not per-function
        yield from self._set_iteration(module)

    def _set_iteration(self, module: ModuleInfo) -> Iterable[Finding]:
        # names whose every assignment in this module is a set expression
        # (a single non-set rebinding clears the name)
        set_names: Set[str] = set()
        non_set: Set[str] = set()

        def is_set_expr(node: ast.AST) -> bool:
            if isinstance(node, (ast.Set, ast.SetComp)):
                return True
            if isinstance(node, ast.Call):
                return attr_chain(node.func) == ["set"]
            if isinstance(node, ast.Name):
                return node.id in set_names
            return False

        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if isinstance(node.value, (ast.Set, ast.SetComp)) or (
                        isinstance(node.value, ast.Call)
                        and attr_chain(node.value.func) == ["set"]):
                    set_names.add(name)
                else:
                    non_set.add(name)
        set_names -= non_set

        for node in ast.walk(module.tree):
            iters: List[ast.AST] = []
            if isinstance(node, ast.For):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters.extend(g.iter for g in node.generators)
            for it in iters:
                if is_set_expr(it):
                    yield Finding(
                        "RPR203", module.path, it.lineno, it.col_offset,
                        "iterating a set to build containers: set order "
                        "is nondeterministic across processes, so tree "
                        "structure / cache keys can drift between hosts; "
                        "iterate sorted(...) instead")


# ---------------------------------------------------------------------------
_TENSOR_ANNOTATIONS = ("torch.Tensor", "Tensor")
# bases whose subclasses the port's walkers take as leaves or nodes
_WALKED_BASES = ("Plan", "NamedTuple")


class TreeChecker(Checker):
    """RPR301: a dataclass holding tensors must be something the port's
    tree walkers know (a ``core.pim.Plan``, which ``engine.persist`` and
    ``engine.mesh`` walk, or a NamedTuple, which ``repro_torch.tree``
    walks), or its tensors silently drop out of checkpoints, placement
    and tree maps."""

    name = "tree"
    rules = ("RPR301",)

    def check(self, project: Project, module: ModuleInfo
              ) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ClassDef) or \
                    not self._is_dataclass(node) or self._walked(node):
                continue
            field = self._tensor_field(node)
            if field is not None:
                yield Finding(
                    "RPR301", module.path, node.lineno, node.col_offset,
                    f"dataclass `{node.name}` holds tensors (field "
                    f"`{field}`) but the port's tree walkers cannot walk "
                    "it; derive it from core.pim.Plan or make it a "
                    "NamedTuple")

    @staticmethod
    def _is_dataclass(node: ast.ClassDef) -> bool:
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            chain = attr_chain(target)
            if chain and chain[-1] == "dataclass":
                return True
        return False

    @staticmethod
    def _walked(node: ast.ClassDef) -> bool:
        return any((attr_chain(b) or [""])[-1] in _WALKED_BASES
                   for b in node.bases)

    @staticmethod
    def _tensor_field(node: ast.ClassDef) -> Optional[str]:
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                ann = ast.unparse(stmt.annotation)
                base = ann.replace("Optional[", "").replace("]", "")
                if base in _TENSOR_ANNOTATIONS:
                    return stmt.target.id
        return None


# ---------------------------------------------------------------------------
_ALLOCATORS = {"empty", "zeros", "ones", "full", "empty_like", "zeros_like",
               "ones_like", "full_like", "empty_strided", "arange"}
_MADE_BY_METHOD = {"contiguous", "new_empty", "new_zeros", "new_ones",
                   "new_full"}
_FALLBACK_TRIGGERS = ("load_library", "build_all", "_library")


class KernelBoundaryChecker(Checker):
    """RPR401/RPR402: what crosses into a hand-written kernel, and the
    port's no-fallback rule.

    RPR401 (the counterpart of the TPU tiles a kernel needs): in
    ``repro_torch.kernels``, a ``t.data_ptr()`` handed to a ctypes entry
    point must come from a tensor the function made itself
    (``torch.empty`` / ``zeros`` / ..., ``.contiguous()``) or passed to a
    ``_check*`` helper, else a strided or mistyped tensor reaches the
    kernel as raw memory.

    RPR402 (the counterpart of ``interpret=True`` by default): library
    code whose ``device`` parameter defaults to the CPU, and an
    ``except`` around a kernel launch or ``load_library`` that swallows
    the failure, both run the plain version where the card was asked
    for.
    """

    name = "kernel-boundary"
    rules = ("RPR401", "RPR402")

    def check(self, project: Project, module: ModuleInfo
              ) -> Iterable[Finding]:
        if module.name.startswith("repro_torch.kernels"):
            for _, info in _functions_of(module, project):
                yield from self._data_ptrs(module, info)
        yield from self._device_defaults(module)
        yield from self._swallowed_launches(module)

    # -- RPR401 ---------------------------------------------------------
    def _data_ptrs(self, module: ModuleInfo, info) -> Iterable[Finding]:
        safe = self._safe_names(info.node)
        for call in callgraph.iter_calls(info.node):
            for arg in call.args:
                for ptr in self._ptr_calls(arg):
                    name = ptr.func.value.id
                    if name not in safe:
                        yield Finding(
                            "RPR401", module.path, ptr.lineno,
                            ptr.col_offset,
                            f"`{name}.data_ptr()` goes to a kernel entry "
                            "point, but this function neither made "
                            f"`{name}` (torch.empty/zeros/.contiguous()) "
                            "nor checked its dtype and contiguity; pass "
                            "it through a _check* helper")

    @staticmethod
    def _ptr_calls(arg: ast.AST) -> Iterable[ast.Call]:
        if isinstance(arg, ast.IfExp):
            for branch in (arg.body, arg.orelse):
                yield from KernelBoundaryChecker._ptr_calls(branch)
        elif isinstance(arg, ast.Call) and \
                isinstance(arg.func, ast.Attribute) and \
                arg.func.attr == "data_ptr" and \
                isinstance(arg.func.value, ast.Name):
            yield arg

    @staticmethod
    def _produced(value: ast.AST) -> bool:
        if isinstance(value, ast.IfExp):
            return all(KernelBoundaryChecker._produced(b) or (
                isinstance(b, ast.Constant) and b.value is None)
                for b in (value.body, value.orelse))
        if not isinstance(value, ast.Call):
            return False
        chain = attr_chain(value.func) or []
        if len(chain) == 2 and chain[0] == "torch" and \
                chain[1] in _ALLOCATORS:
            return True
        return isinstance(value.func, ast.Attribute) and \
            value.func.attr in _MADE_BY_METHOD

    def _safe_names(self, fn: ast.AST) -> Set[str]:
        safe: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and self._produced(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        safe.add(t.id)
            elif isinstance(node, ast.Call):
                chain = attr_chain(node.func) or [""]
                if chain[-1].startswith("_check"):
                    safe.update(n.id for a in node.args
                                for n in ast.walk(a)
                                if isinstance(n, ast.Name))
        return safe

    # -- RPR402 ---------------------------------------------------------
    def _device_defaults(self, module: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            args = node.args
            pos = args.posonlyargs + args.args
            defaults = [None] * (len(pos) - len(args.defaults)) + \
                list(args.defaults)
            pairs = list(zip(pos, defaults)) + \
                list(zip(args.kwonlyargs, args.kw_defaults))
            for arg, default in pairs:
                if arg.arg == "device" and default is not None and \
                        _is_cpu_literal(default):
                    yield Finding(
                        "RPR402", module.path, default.lineno,
                        default.col_offset,
                        f"`{node.name}` defaults device to the CPU: "
                        "library code must run on the card unless the "
                        "caller asks for the CPU; default to None and "
                        "resolve it (kernels.runtime.resolve_device)")

    def _swallowed_launches(self, module: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Try):
                continue
            launches = any(self._is_launch(c) for stmt in node.body
                           for c in ast.walk(stmt)
                           if isinstance(c, ast.Call))
            if not launches:
                continue
            for handler in node.handlers:
                if not any(isinstance(s, ast.Raise)
                           for stmt in handler.body for s in ast.walk(stmt)):
                    yield Finding(
                        "RPR402", module.path, handler.lineno,
                        handler.col_offset,
                        "an except around a kernel launch that does not "
                        "raise runs the plain version (or nothing) where "
                        "the card was asked for; the port has no fallback")

    @staticmethod
    def _is_launch(call: ast.Call) -> bool:
        chain = attr_chain(call.func) or [""]
        return chain[-1] in _FALLBACK_TRIGGERS or \
            chain[-1].endswith("_cuda")


# ---------------------------------------------------------------------------
class SubstrateAliasChecker(Checker):
    """RPR501: the JAX package's substrate names stay in their
    resolution site; the port's code names its own substrates."""

    name = "substrate-alias"
    rules = ("RPR501",)

    ALLOWED_MODULES = ("repro_torch.core.pim",)
    # repro-lint: disable=RPR501 (the rule's own list of what it flags)
    ALIASES = ("exact-pallas", "exact-jnp", "analog-pallas")

    def check(self, project: Project, module: ModuleInfo
              ) -> Iterable[Finding]:
        if module.name in self.ALLOWED_MODULES:
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Constant) and \
                    node.value in self.ALIASES:
                yield Finding(
                    "RPR501", module.path, node.lineno, node.col_offset,
                    f"{node.value!r} is a JAX substrate alias; the port "
                    "resolves it in core/pim.py (SUBSTRATE_ALIASES) only, "
                    "so name the port's substrate (exact-cuda, "
                    "exact-torch, analog-cuda)")


register_checker(HostSyncChecker())
register_checker(RecompileChecker())
register_checker(TreeChecker())
register_checker(KernelBoundaryChecker())
register_checker(SubstrateAliasChecker())
