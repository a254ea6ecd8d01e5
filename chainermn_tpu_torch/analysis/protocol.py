"""Static protocol model of the host object plane -- the control-plane
side of cmn-lint.

Counterpart of ``chainermn_tpu/analysis/protocol.py`` (copied: the walk
is AST only and framework-free).  Every hang the flight recorder /
watchdog stack diagnoses is a *host-side* lockstep violation: a
rank-guarded ``bcast_obj``, a tag crossing wires, a send with no recv.
The data-plane rules see none of that -- they read the collectives a
recorded step issues, and the object plane
(``send_obj``/``recv_obj``/``bcast_obj``/... over the gloo channel or the
socket control plane) carries Python objects, not tensors.  This module
recovers the missing half **statically**: an AST walk over the package
extracts every control-plane call site, resolves its tag expression
(constants, named registry tags, ``tag + 1`` arithmetic as used by
``allgather_obj``), its root, the enclosing rank guards and exception
paths, and the thread context, into a serializable
:class:`ProtocolModel` the protocol rules in ``rules.py`` check:

* **tag-band-collision** -- resolved tag intervals from two subsystems
  intersect (including arithmetic neighbors), or a magic number lands in
  a reserved band it does not own (``RESERVED_TAG_BANDS`` of
  ``runtime/control_plane.py``).
* **lockstep-divergence** -- a collective object op reachable under a
  rank guard or except-branch with no matching call on the complementary
  path: the static twin of ``identify_desync``.
* **unmatched-send-recv** -- a p2p send with no structurally matching
  recv on the same (plane, tag).
* **wrapper-surface-drift** -- a wrapper class forwarding object ops
  while dropping parameters the wrapped surface accepts (the
  ``InstrumentedCommunicator`` tag-drop bug, generically).

The op signatures (:data:`_TAG_ARG`, :data:`_ROOT_ARG`) are the port's:
``MeshCommunicator`` (``communicators/mesh_communicator_base.py``),
``ControlPlane`` and ``InstrumentedCommunicator`` take the tag and root
at JAX's positions.

:func:`replay_flight` projects a recorded flight dump's per-rank
object-plane event sequence against the model, so ``elastic_run``
restart manifests can be triaged as protocol violations
(``cmn_lint --protocol --events``).
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: The object-plane API surface (matches InstrumentedCommunicator._OBJECT_OPS
#: plus the dedicated telemetry entry point).
OBJECT_OPS = ("send_obj", "recv_obj", "bcast_obj", "gather_obj",
              "allgather_obj", "scatter_obj", "allreduce_obj", "barrier",
              "gather_telemetry")

P2P_OPS = frozenset({"send_obj", "recv_obj"})
COLLECTIVE_OPS = frozenset(OBJECT_OPS) - P2P_OPS

#: Arithmetic tag consumers: a call at ``tag`` also uses ``tag + 1``
#: (allgather/allreduce fold+bcast; barrier rides allgather).
_ARITHMETIC_OPS = frozenset({"allgather_obj", "allreduce_obj", "barrier"})

#: op -> (positional index of the tag argument, default tag) — index
#: counts call arguments (receiver excluded).  ``None`` index: the op
#: has no tag parameter (gather_telemetry pins TELEMETRY_TAG itself).
_TAG_ARG: Dict[str, Tuple[Optional[int], Optional[int]]] = {
    "send_obj": (2, 0),
    "recv_obj": (1, 0),
    "bcast_obj": (2, 0),
    "gather_obj": (2, 0),
    "allgather_obj": (1, 0),
    "scatter_obj": (2, 0),
    "allreduce_obj": (2, 0),
    "barrier": (0, 900),
    "gather_telemetry": (None, None),
}

#: op -> positional index of the root argument (None: no root).
_ROOT_ARG: Dict[str, Optional[int]] = {
    "send_obj": None, "recv_obj": None, "bcast_obj": 1, "gather_obj": 1,
    "allgather_obj": None, "scatter_obj": 1, "allreduce_obj": None,
    "barrier": None, "gather_telemetry": 1,
}

#: Raw-transport surface: ``<transport>.send(dest, tag, payload)`` /
#: ``<transport>.recv(source, tag, ...)`` — the watchdog's FLIGHT_TAG
#: path bypasses the object plane and goes straight to the framing core.
_RAW_OPS = {"send": 1, "recv": 1}  # op -> tag positional index
_RAW_RECEIVERS = ("_tp", "transport", "_transport")


def _registry_bands():
    from chainermn_tpu_torch.runtime.control_plane import (
        RESERVED_TAG_BANDS)
    return RESERVED_TAG_BANDS


def _reserved_tag_value(name: str) -> Optional[int]:
    band = _registry_bands().get(name)
    return None if band is None else band.base


# ---------------------------------------------------------------------------
# model dataclasses
# ---------------------------------------------------------------------------

@dataclass
class CallSite:
    """One static control-plane call site."""
    op: str
    file: str                      # path relative to the scanned root
    line: int
    subsystem: str                 # first directory component under root
    qualname: str                  # enclosing def/class chain ("" = module)
    cls: str = ""                  # enclosing class name, if any
    receiver: str = ""             # source of the object the op is called on
    raw: bool = False              # raw transport send/recv (not object plane)
    tag: Dict[str, Any] = field(default_factory=dict)
    width: int = 1                 # tags consumed: tag .. tag + width - 1
    root: Optional[int] = None
    guards: List[dict] = field(default_factory=list)   # enclosing If chain
    trys: List[dict] = field(default_factory=list)     # enclosing Try chain
    thread: bool = False           # enclosing function is a Thread target

    @property
    def collective(self) -> bool:
        return not self.raw and self.op in COLLECTIVE_OPS

    @property
    def rank_guards(self) -> List[dict]:
        return [g for g in self.guards if g.get("rank_guard")]

    def tag_interval(self) -> Optional[Tuple[int, int]]:
        """[start, stop) of resolved const tags, else None."""
        if self.tag.get("kind") != "const":
            return None
        base = self.tag["value"]
        return (base, base + self.width)

    def as_dict(self) -> dict:
        return {
            "op": self.op, "file": self.file, "line": self.line,
            "subsystem": self.subsystem, "qualname": self.qualname,
            "cls": self.cls, "receiver": self.receiver, "raw": self.raw,
            "tag": dict(self.tag), "width": self.width, "root": self.root,
            "guards": list(self.guards), "trys": list(self.trys),
            "thread": self.thread,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CallSite":
        return cls(**d)

    def where(self) -> str:
        ctx = f" in {self.qualname}" if self.qualname else ""
        return f"{self.file}:{self.line}{ctx}"


@dataclass
class ClassOpDef:
    """One object-plane method definition on a class: its accepted
    parameters, and — when the body forwards the same op to a wrapped
    attribute (``self._comm.bcast_obj(...)``) — which parameters actually
    make it across the forwarding boundary."""
    cls: str
    op: str
    file: str
    line: int
    params: List[str] = field(default_factory=list)           # after self
    optional_params: List[str] = field(default_factory=list)  # with defaults
    forwards_to: str = ""          # "" = an implementation, not a wrapper
    forwarded_params: List[str] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {"cls": self.cls, "op": self.op, "file": self.file,
                "line": self.line, "params": list(self.params),
                "optional_params": list(self.optional_params),
                "forwards_to": self.forwards_to,
                "forwarded_params": list(self.forwarded_params)}

    @classmethod
    def from_dict(cls, d: dict) -> "ClassOpDef":
        return cls(**d)


@dataclass
class ProtocolModel:
    """Serializable whole-tree protocol model (``protocol_model/v1``)."""
    root: str
    sites: List[CallSite] = field(default_factory=list)
    class_ops: List[ClassOpDef] = field(default_factory=list)
    errors: List[dict] = field(default_factory=list)  # unparseable files

    def collectives(self) -> List[CallSite]:
        return [s for s in self.sites if s.collective]

    def p2p(self) -> List[CallSite]:
        return [s for s in self.sites
                if s.raw or s.op in P2P_OPS]

    def to_json(self) -> dict:
        return {
            "schema": "protocol_model/v1",
            "root": self.root,
            "sites": [s.as_dict() for s in self.sites],
            "class_ops": [c.as_dict() for c in self.class_ops],
            "errors": list(self.errors),
            "bands": [b.as_dict() for b in _registry_bands().values()],
        }

    @classmethod
    def from_json(cls, doc: dict) -> "ProtocolModel":
        return cls(root=doc.get("root", ""),
                   sites=[CallSite.from_dict(d) for d in doc["sites"]],
                   class_ops=[ClassOpDef.from_dict(d)
                              for d in doc.get("class_ops", [])],
                   errors=list(doc.get("errors", [])))


# ---------------------------------------------------------------------------
# pass 1 — module-level integer constants, resolved across modules
# ---------------------------------------------------------------------------

def _const_eval(node: ast.AST, env: Dict[str, int],
                aliases: Dict[str, str],
                modules: Dict[str, "_Module"]) -> Optional[int]:
    """Evaluate simple integer expressions: literals, known names,
    ``a.B`` through module aliases, +,-,*,<<,>>,| arithmetic, and
    ``reserved_tag("name")`` via the real registry."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        modkey = aliases.get(node.value.id)
        if modkey is not None and modkey in modules:
            return modules[modkey].env.get(node.attr)
        return None
    if isinstance(node, ast.BinOp):
        left = _const_eval(node.left, env, aliases, modules)
        right = _const_eval(node.right, env, aliases, modules)
        if left is None or right is None:
            return None
        return _apply_binop(node.op, left, right)
    if isinstance(node, ast.Call):
        fname = ""
        if isinstance(node.func, ast.Name):
            fname = node.func.id
        elif isinstance(node.func, ast.Attribute):
            fname = node.func.attr
        if fname.lstrip("_") == "reserved_tag" and len(node.args) == 1 \
                and isinstance(node.args[0], ast.Constant):
            return _reserved_tag_value(node.args[0].value)
        return None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        val = _const_eval(node.operand, env, aliases, modules)
        return None if val is None else -val
    return None


def _apply_binop(op: ast.operator, left: int, right: int) -> Optional[int]:
    if isinstance(op, ast.Add):
        return left + right
    if isinstance(op, ast.Sub):
        return left - right
    if isinstance(op, ast.Mult):
        return left * right
    if isinstance(op, ast.LShift):
        return left << right
    if isinstance(op, ast.RShift):
        return left >> right
    if isinstance(op, ast.BitOr):
        return left | right
    return None


class _Module:
    def __init__(self, path: str, rel: str, tree: ast.Module):
        self.path = path
        self.rel = rel
        self.tree = tree
        self.env: Dict[str, int] = {}          # name -> resolved int
        self.aliases: Dict[str, str] = {}      # local alias -> module key
        self.from_imports: Dict[str, Tuple[str, str]] = {}  # name->(mod,name)
        self.assigns: List[Tuple[str, ast.AST]] = []
        self.thread_targets: set = set()
        self._scan_toplevel()

    def _modkey(self, module: Optional[str], level: int) -> str:
        """Normalize an import to a key comparable across the tree: the
        trailing module path (absolute and relative imports of the same
        module collide on purpose)."""
        return module or ""

    def _scan_toplevel(self):
        for node in self.tree.body:
            self._scan_stmt(node)
        # function-local from-imports still bind constants worth seeing
        # (point_to_point_communication imports reserved_tag mid-module)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_imports.setdefault(
                        a.asname or a.name, (node.module, a.name))
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases.setdefault(a.asname or a.name, a.name)
            elif isinstance(node, ast.Call):
                self._scan_thread(node)

    def _scan_stmt(self, node: ast.stmt):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            self.assigns.append((node.targets[0].id, node.value))
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            self.assigns.append((node.target.id, node.value))

    def _scan_thread(self, call: ast.Call):
        fname = ""
        if isinstance(call.func, ast.Name):
            fname = call.func.id
        elif isinstance(call.func, ast.Attribute):
            fname = call.func.attr
        if fname != "Thread":
            return
        for kw in call.keywords:
            if kw.arg != "target":
                continue
            if isinstance(kw.value, ast.Name):
                self.thread_targets.add(kw.value.id)
            elif isinstance(kw.value, ast.Attribute):
                self.thread_targets.add(kw.value.attr)


def _resolve_constants(modules: Dict[str, _Module]) -> None:
    """Fixpoint resolution of module-level int constants across the tree
    (handles chains like FLIGHT_TAG = reserved_tag(...) imported
    elsewhere)."""
    by_suffix: Dict[str, List[_Module]] = {}
    for key, mod in modules.items():
        for i in range(len(key.split("."))):
            by_suffix.setdefault(".".join(key.split(".")[i:]), []).append(mod)

    def find_module(name: str) -> Optional[_Module]:
        cands = by_suffix.get(name) or by_suffix.get(name.split(".")[-1])
        return cands[0] if cands else None

    for _ in range(4):
        changed = False
        for mod in modules.values():
            # pull in from-imported constants resolved elsewhere
            for local, (src, orig) in mod.from_imports.items():
                if local in mod.env:
                    continue
                src_mod = find_module(src)
                if src_mod is not None and orig in src_mod.env:
                    mod.env[local] = src_mod.env[orig]
                    changed = True
            # resolve module aliases to canonical keys
            alias_map = {}
            for alias, target in mod.aliases.items():
                tgt = find_module(target)
                alias_map[alias] = tgt.rel_key if tgt else target
            for name, expr in mod.assigns:
                if name in mod.env:
                    continue
                val = _const_eval(expr, mod.env, alias_map,
                                  {m.rel_key: m for m in modules.values()})
                if val is not None:
                    mod.env[name] = val
                    changed = True
        if not changed:
            break


# ---------------------------------------------------------------------------
# pass 2 — call-site extraction
# ---------------------------------------------------------------------------

def _src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — display only
        return "<expr>"


def _mentions_rank(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in (
                "rank", "inter_rank", "intra_rank"):
            return True
        if isinstance(sub, ast.Name) and sub.id == "rank":
            return True
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Attribute) and f.attr == "process_index":
                return True
    return False


def _is_rank_guard(test: ast.AST) -> bool:
    """True when the If test *compares* a rank expression — the shape of
    every root-only branch (``if rank == 0``, ``if comm.rank != root``).
    Size/flag guards (``if multi:``, ``if host_size > 1``) and bit tricks
    on derived vranks are not rank guards."""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Compare):
            sides = [sub.left] + list(sub.comparators)
            if any(_mentions_rank(s) for s in sides):
                return True
    return False


def _is_early_exit_rank_guard(node: ast.AST) -> bool:
    """An ``if`` on the rank with no ``else`` whose body always leaves
    the enclosing block (ends in ``return``/``raise``/``continue``/
    ``break``): the statements after it are the other ranks' path."""
    return (isinstance(node, ast.If) and not node.orelse
            and bool(node.body)
            and isinstance(node.body[-1], (ast.Return, ast.Raise,
                                           ast.Continue, ast.Break))
            and _is_rank_guard(node.test))


class _Extractor:
    def __init__(self, mod: _Module, root: str,
                 modules: Dict[str, _Module]):
        self.mod = mod
        self.root = root
        self.modules = modules
        self.alias_map = {}
        for alias, target in mod.aliases.items():
            self.alias_map[alias] = target
        self.sites: List[CallSite] = []
        self.class_ops: List[ClassOpDef] = []
        rel = mod.rel
        parts = rel.split(os.sep)
        self.subsystem = parts[0] if len(parts) > 1 else \
            os.path.splitext(parts[0])[0]

    # -- scope-carrying recursion ---------------------------------------

    def run(self):
        self._walk_body(self.mod.tree.body, func_stack=(), cls="",
                        params=frozenset(), guards=(), trys=())

    def _walk_body(self, body, **ctx):
        for i, node in enumerate(body):
            self._walk(node, **ctx)
            if _is_early_exit_rank_guard(node):
                # ``if rank == 0: ...; return`` -- the statements after
                # it run on the other ranks only: they are the guard's
                # complementary path, as an ``else`` would be
                info = {"line": node.lineno, "test": _src(node.test),
                        "rank_guard": True, "branch": "orelse"}
                ctx = dict(ctx, guards=ctx["guards"] + (info,))
                for rest in body[i + 1:]:
                    self._walk(rest, **ctx)
                return

    def _walk(self, node, func_stack, cls, params, guards, trys):
        ctx = dict(func_stack=func_stack, cls=cls, params=params,
                   guards=guards, trys=trys)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if cls and not func_stack and node.name in OBJECT_OPS:
                self._record_class_op(node, cls)
            new_params = frozenset(
                a.arg for a in (node.args.posonlyargs + node.args.args
                                + node.args.kwonlyargs)
                if a.arg != "self")
            self._walk_body(node.body, func_stack=func_stack + (node.name,),
                            cls=cls, params=params | new_params,
                            guards=guards, trys=trys)
            return
        if isinstance(node, ast.ClassDef):
            self._walk_body(node.body, func_stack=(), cls=node.name,
                            params=frozenset(), guards=(), trys=())
            return
        if isinstance(node, ast.If):
            info = {"line": node.lineno, "test": _src(node.test),
                    "rank_guard": _is_rank_guard(node.test)}
            self._walk_body(node.body, func_stack=func_stack, cls=cls,
                            params=params,
                            guards=guards + (dict(info, branch="body"),),
                            trys=trys)
            self._walk_body(node.orelse, func_stack=func_stack, cls=cls,
                            params=params,
                            guards=guards + (dict(info, branch="orelse"),),
                            trys=trys)
            self._visit_exprs(node.test, **ctx)
            return
        if isinstance(node, ast.Try):
            tinfo = {"line": node.lineno}
            self._walk_body(node.body, func_stack=func_stack, cls=cls,
                            params=params, guards=guards,
                            trys=trys + (dict(tinfo, branch="try"),))
            for handler in node.handlers:
                self._walk_body(handler.body, func_stack=func_stack,
                                cls=cls, params=params, guards=guards,
                                trys=trys + (dict(tinfo, branch="except"),))
            self._walk_body(node.orelse, func_stack=func_stack, cls=cls,
                            params=params, guards=guards,
                            trys=trys + (dict(tinfo, branch="try"),))
            self._walk_body(node.finalbody, func_stack=func_stack, cls=cls,
                            params=params, guards=guards,
                            trys=trys + (dict(tinfo, branch="finally"),))
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While, ast.With,
                             ast.AsyncWith)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    self._walk(child, **ctx)
                else:
                    self._visit_exprs(child, **ctx)
            return
        # plain statement: scan its expressions for call sites (including
        # lambdas — instrument.py forwards inside ``lambda:`` thunks)
        self._visit_exprs(node, **ctx)

    def _visit_exprs(self, node, func_stack, cls, params, guards, trys):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Lambda):
                lam_params = frozenset(
                    a.arg for a in (sub.args.posonlyargs + sub.args.args
                                    + sub.args.kwonlyargs))
                params = params | lam_params
            if isinstance(sub, ast.Call):
                self._maybe_site(sub, func_stack, cls, params, guards, trys)

    # -- call-site recording --------------------------------------------

    def _maybe_site(self, call: ast.Call, func_stack, cls, params,
                    guards, trys):
        func = call.func
        if not isinstance(func, ast.Attribute):
            return
        op = func.attr
        recv_src = _src(func.value)
        raw = False
        if op in _RAW_OPS:
            # raw transport only: .send/.recv on a transport-ish receiver
            leaf = recv_src.split(".")[-1]
            if leaf not in _RAW_RECEIVERS:
                return
            raw = True
        elif op not in OBJECT_OPS:
            return
        site = CallSite(
            op=op, raw=raw, file=self.mod.rel, line=call.lineno,
            subsystem=self.subsystem,
            qualname=".".join(filter(None, (cls,) + func_stack)),
            cls=cls, receiver=recv_src,
            guards=[dict(g) for g in guards],
            trys=[dict(t) for t in trys],
            thread=any(f in self.mod.thread_targets for f in func_stack),
        )
        site.width = 2 if (not raw and op in _ARITHMETIC_OPS) else 1
        site.tag = self._resolve_tag(call, op, raw, params)
        site.root = self._resolve_root(call, op, raw)
        self.sites.append(site)

    def _tag_expr(self, call: ast.Call, op: str, raw: bool):
        idx = _RAW_OPS[op] if raw else _TAG_ARG[op][0]
        if idx is None:
            return None, None
        for kw in call.keywords:
            if kw.arg == "tag":
                return kw.value, idx
        if idx < len(call.args):
            arg = call.args[idx]
            if isinstance(arg, ast.Starred):
                return None, idx
            return arg, idx
        return None, idx

    def _resolve_tag(self, call: ast.Call, op: str, raw: bool,
                     params: frozenset) -> Dict[str, Any]:
        if not raw and op == "gather_telemetry":
            return {"kind": "const",
                    "value": _reserved_tag_value("telemetry"),
                    "provenance": "named", "source": "TELEMETRY_TAG"}
        expr, _ = self._tag_expr(call, op, raw)
        if expr is None:
            if raw:
                return {"kind": "dynamic", "source": "<missing>"}
            default = _TAG_ARG[op][1]
            return {"kind": "const", "value": default,
                    "provenance": "default", "source": str(default)}
        return self._eval_tag(expr, params)

    def _eval_tag(self, expr: ast.AST, params: frozenset) -> Dict[str, Any]:
        source = _src(expr)
        val = _const_eval(expr, self.mod.env, self.alias_map, {
            m.rel_key: m for m in self.modules.values()})
        if val is not None:
            provenance = "literal" if isinstance(expr, ast.Constant) \
                else "named"
            return {"kind": "const", "value": val,
                    "provenance": provenance, "source": source}
        # param / base + param forms
        if isinstance(expr, ast.Name) and expr.id in params:
            return {"kind": "param", "base": 0, "param": expr.id,
                    "source": source}
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.Add, ast.Sub)):
            for const_side, name_side in ((expr.left, expr.right),
                                          (expr.right, expr.left)):
                base = _const_eval(const_side, self.mod.env, self.alias_map,
                                   {m.rel_key: m
                                    for m in self.modules.values()})
                if base is not None and isinstance(name_side, ast.Name) \
                        and name_side.id in params:
                    if isinstance(expr.op, ast.Sub):
                        if name_side is expr.left:
                            return {"kind": "param", "base": -base,
                                    "param": name_side.id, "source": source}
                        return {"kind": "dynamic", "source": source}
                    return {"kind": "param", "base": base,
                            "param": name_side.id, "source": source}
        return {"kind": "dynamic", "source": source}

    def _resolve_root(self, call: ast.Call, op: str,
                      raw: bool) -> Optional[int]:
        if raw:
            return None
        idx = _ROOT_ARG.get(op)
        expr = None
        for kw in call.keywords:
            if kw.arg == "root":
                expr = kw.value
        if expr is None and idx is not None and idx < len(call.args):
            expr = call.args[idx]
        if expr is None:
            return 0 if idx is not None else None
        return _const_eval(expr, self.mod.env, self.alias_map,
                           {m.rel_key: m for m in self.modules.values()})

    # -- class surface recording ----------------------------------------

    def _record_class_op(self, fn: ast.FunctionDef, cls: str):
        args = fn.args
        names = [a.arg for a in args.posonlyargs + args.args
                 if a.arg != "self"]
        n_opt = len(args.defaults)
        optional = names[len(names) - n_opt:] if n_opt else []
        kw_names = [a.arg for a in args.kwonlyargs]
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if d is not None:
                optional.append(a.arg)
        names += kw_names
        forwards_to, forwarded = "", []
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if not (isinstance(f, ast.Attribute) and f.attr == fn.name):
                continue
            if not (isinstance(f.value, ast.Attribute)
                    and isinstance(f.value.value, ast.Name)
                    and f.value.value.id == "self"):
                continue
            forwards_to = f.value.attr
            used = {n.id for arg in list(sub.args) + [
                kw.value for kw in sub.keywords]
                for n in ast.walk(arg) if isinstance(n, ast.Name)}
            forwarded = [p for p in names if p in used]
            break
        self.class_ops.append(ClassOpDef(
            cls=cls, op=fn.name, file=self.mod.rel, line=fn.lineno,
            params=names, optional_params=optional,
            forwards_to=forwards_to, forwarded_params=forwarded))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def extract_protocol(root: Optional[str] = None) -> ProtocolModel:
    """Walk every ``*.py`` under ``root`` (default: the installed
    ``chainermn_tpu_torch`` package) into a :class:`ProtocolModel`."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(root)
    modules: Dict[str, _Module] = {}
    errors: List[dict] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root)
            try:
                with open(path, encoding="utf-8") as fh:
                    tree = ast.parse(fh.read(), filename=path)
            except (SyntaxError, UnicodeDecodeError, OSError) as e:
                errors.append({"file": rel, "error": str(e)})
                continue
            mod = _Module(path, rel, tree)
            mod.rel_key = rel[:-3].replace(os.sep, ".")
            modules[mod.rel_key] = mod
    _resolve_constants(modules)
    model = ProtocolModel(root=root, errors=errors)
    for mod in modules.values():
        ex = _Extractor(mod, root, modules)
        ex.run()
        model.sites.extend(ex.sites)
        model.class_ops.extend(ex.class_ops)
    model.sites.sort(key=lambda s: (s.file, s.line))
    return model


# ---------------------------------------------------------------------------
# replay — project a flight dump against the static model
# ---------------------------------------------------------------------------

def _object_sequences(events_by_rank: Dict[int, Sequence[dict]]):
    """Per-rank (completed op list, open op list) from flight events."""
    out = {}
    for rank, events in events_by_rank.items():
        completed: List[str] = []
        open_spans: Dict[Tuple[str, Any], dict] = {}
        for ev in events:
            kind = ev.get("kind")
            if kind == "object_begin":
                open_spans[(ev.get("op"), ev.get("op_seq"))] = ev
            elif kind == "object_end":
                open_spans.pop((ev.get("op"), ev.get("op_seq")), None)
                completed.append(ev.get("op"))
        out[int(rank)] = (completed, [e.get("op")
                                      for e in open_spans.values()])
    return out


def replay_flight(model: ProtocolModel,
                  events_by_rank: Dict[int, Sequence[dict]]) -> List[dict]:
    """Project recorded per-rank object-plane event sequences against the
    static model.  Returns a list of violation dicts (empty = healthy):

    * ``divergence`` — two ranks completed different op sequences; the
      first differing index is reported with the rank-guarded collective
      sites from the static model as prime suspects.
    * ``straggler`` — a rank is stuck inside an object op (began, never
      finished) while a peer has moved on.
    * ``unknown-op`` — an op name the static model has no call site for
      (a dump from a different build than the tree under analysis).
    """
    seqs = _object_sequences(events_by_rank)
    findings: List[dict] = []
    if not seqs:
        return findings
    known_ops = {s.op for s in model.sites} | set(OBJECT_OPS)
    suspects = [
        {"where": s.where(), "op": s.op,
         "guard": (s.rank_guards or [{}])[-1].get("test", "")}
        for s in model.collectives() if s.rank_guards]
    ranks = sorted(seqs)
    ref_rank = ranks[0]
    ref_completed = seqs[ref_rank][0]
    for rank in ranks[1:]:
        completed = seqs[rank][0]
        n = min(len(ref_completed), len(completed))
        for i in range(n):
            if ref_completed[i] != completed[i]:
                findings.append({
                    "kind": "divergence", "index": i,
                    "ranks": [ref_rank, rank],
                    "ops": [ref_completed[i], completed[i]],
                    "message": (
                        f"rank {ref_rank} completed object op "
                        f"#{i} = {ref_completed[i]!r} but rank {rank} "
                        f"completed {completed[i]!r} — the ranks are "
                        f"running different object-plane programs"),
                    "suspect_sites": suspects,
                })
                break
        else:
            if len(ref_completed) != len(completed):
                ahead, behind = ((ref_rank, rank)
                                 if len(ref_completed) > len(completed)
                                 else (rank, ref_rank))
                longer = max(ref_completed, completed, key=len)
                findings.append({
                    "kind": "divergence", "index": n,
                    "ranks": [behind, ahead],
                    "ops": [None, longer[n]],
                    "message": (
                        f"rank {ahead} completed {abs(len(ref_completed) - len(completed))} "
                        f"more object op(s) than rank {behind} "
                        f"(next: {longer[n]!r}) — rank {behind} never "
                        f"reached a collective its peer entered"),
                    "suspect_sites": suspects,
                })
    for rank in ranks:
        completed, open_ops = seqs[rank]
        peers_ahead = [r for r in ranks
                       if len(seqs[r][0]) > len(completed)]
        if open_ops and peers_ahead:
            findings.append({
                "kind": "straggler", "ranks": [rank],
                "ops": list(open_ops),
                "message": (
                    f"rank {rank} is blocked inside object op(s) "
                    f"{open_ops} while rank(s) {peers_ahead} moved on"),
                "suspect_sites": suspects,
            })
        for op in completed:
            if op not in known_ops:
                findings.append({
                    "kind": "unknown-op", "ranks": [rank], "ops": [op],
                    "message": (
                        f"rank {rank} recorded object op {op!r} with no "
                        f"call site in the static model — dump and tree "
                        f"are from different builds"),
                })
                break
    return findings


def load_events_by_rank(dumps: Any) -> Dict[int, List[dict]]:
    """Normalize flight-dump input into ``{rank: [events]}``.  Accepts a
    ``{rank: events}`` map, a ``{rank: dump_doc}`` map (elastic restart
    manifests embed these), a single dump doc, or a flat event list."""
    if isinstance(dumps, dict) and dumps and all(
            isinstance(v, (list, tuple)) for v in dumps.values()):
        return {int(r): list(v) for r, v in dumps.items()}
    if isinstance(dumps, dict) and "events" in dumps:
        return {int(dumps.get("rank", 0)): list(dumps["events"])}
    if isinstance(dumps, dict):
        out = {}
        for r, doc in dumps.items():
            if isinstance(doc, dict):
                out[int(r)] = list(doc.get("events", []))
            else:
                out[int(r)] = list(doc)
        return out
    return {0: list(dumps or [])}


__all__ = [
    "OBJECT_OPS", "P2P_OPS", "COLLECTIVE_OPS",
    "CallSite", "ClassOpDef", "ProtocolModel",
    "extract_protocol", "replay_flight", "load_events_by_rank",
]
