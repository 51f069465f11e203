"""Symbol: the declarative graph API (counterpart of
``mxnet_tpu/symbol/symbol.py``).

A Symbol is an immutable DAG of op nodes over named variables.  Missing
learnable inputs are auto-created as variables with MXNet's names
(``fullyconnected0_weight``), auxiliary states are tracked apart, and
``simple_bind`` infers every argument's shape and binds an
:class:`~mxnet_tpu_torch.executor.Executor`.

Shape and dtype inference runs the registered op bodies on ``meta``
tensors (shapes and dtypes, no data), with per-op hints filling the
shapes of parameter inputs (:mod:`.shape_hints`); the reference runs
``jax.eval_shape`` over the same bodies.

``tojson``/``save`` and :func:`load_json`/:func:`load` read and write the
reference's nnvm JSON (``nodes``/``arg_nodes``/``heads``, attribute values
as strings) byte for byte as the JAX package does, so either package loads
what the other wrote.  One difference: a loaded symbol keeps its hidden
attribute keys (``__lr_mult__``, ``__init__``) as MXNet does, where the
reference's ``load_json`` strips them to ``lr_mult`` and so drops them
from the optimizer and the initializer (fault C5 in ``ROADMAP.md``).  The
graph passes' rewritten symbol lives in the executor only: ``tojson``
writes the symbol the user built.
"""
from __future__ import annotations

import json

import numpy as _np
import torch

from ..attribute import AttrScope
from ..base import MXNetError
from ..name import NameManager
from ..ndarray.ndarray import to_numpy_dtype, to_torch_dtype
from ..ops import get_op
from ..ops.registry import _OP_REGISTRY

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]

_META = torch.device("meta")


class _SymNode:
    """One op application in the graph."""

    __slots__ = ("op", "name", "params", "inputs", "attrs", "is_var",
                 "is_aux_var")

    def __init__(self, op, name, params, inputs, attrs=None, is_var=False,
                 is_aux_var=False):
        self.op = op
        self.name = name
        self.params = params or {}
        self.inputs = inputs  # list of (node, out_index)
        self.attrs = dict(attrs or {})
        self.is_var = is_var
        self.is_aux_var = is_aux_var

    def num_outputs(self):
        if self.is_var:
            return 1
        return self.op.num_outputs(self.params)

    def output_names(self):
        if self.is_var:
            return [self.name]
        n = self.num_outputs()
        if n == 1:
            return ["%s_output" % self.name]
        return ["%s_output%d" % (self.name, i) for i in range(n)]


class Symbol:
    """A handle onto one or more outputs of a graph."""

    __slots__ = ("_node", "_indices")

    def __init__(self, node, indices=None):
        self._node = node
        self._indices = indices  # list of (node, idx); None -> all of _node

    # -- handle helpers ----------------------------------------------------
    @property
    def _outputs(self):
        """List of (node, out_index) this symbol denotes."""
        if self._indices is not None:
            return self._indices
        return [(self._node, i) for i in range(self._node.num_outputs())]

    @property
    def name(self):
        outs = self._outputs
        if len(outs) == 1:
            return outs[0][0].name
        return None  # a grouped symbol has no single name

    def __repr__(self):
        if self._indices is not None and len(self._indices) > 1:
            return "<Symbol group [%s]>" % ", ".join(
                n.name for n, _ in self._indices)
        return "<Symbol %s>" % (self.name,)

    def __iter__(self):
        return (Symbol(n, [(n, i)]) for n, i in self._outputs)

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        outs = self._outputs
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError("Cannot find output %s" % index)
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._node, outs[index])
        return Symbol(outs[index][0], [outs[index]])

    # -- graph traversal ---------------------------------------------------
    def _topo_nodes(self):
        """Topological order of nodes reachable from this symbol."""
        seen = set()
        order = []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for inp, _ in node.inputs:
                visit(inp)
            order.append(node)

        for n, _ in self._outputs:
            visit(n)
        return order

    def list_arguments(self):
        return [n.name for n in self._topo_nodes()
                if n.is_var and not n.is_aux_var]

    def list_outputs(self):
        return [n.output_names()[i] for n, i in self._outputs]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo_nodes() if n.is_aux_var]

    def list_inputs(self):
        return [n.name for n in self._topo_nodes() if n.is_var]

    def get_internals(self):
        outs = []
        for n in self._topo_nodes():
            for i in range(n.num_outputs()):
                outs.append((n, i))
        return Symbol(self._node, outs)

    def get_children(self):
        """The inputs of this symbol's nodes as one symbol, or None for a
        variable."""
        nodes = []
        for n, _ in self._outputs:
            nodes.extend(n.inputs)
        if not nodes:
            return None
        return Symbol(nodes[0][0], nodes)

    # -- attributes --------------------------------------------------------
    def attr(self, key):
        outs = self._outputs
        if len(outs) == 1:
            return outs[0][0].attrs.get(key)
        return None

    def list_attr(self):
        outs = self._outputs
        if len(outs) == 1:
            return dict(outs[0][0].attrs)
        return {}

    def attr_dict(self):
        return {n.name: dict(n.attrs) for n in self._topo_nodes() if n.attrs}

    # -- composition -------------------------------------------------------
    def _binary(self, other, op_name, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _apply_op(get_op(op_name), None, [a, b], {})
        if isinstance(other, (int, float)):
            return _apply_op(get_op(scalar_op), None, [self],
                             {"scalar": float(other)})
        raise TypeError("type %s not supported" % type(other))

    def __add__(self, other):
        return self._binary(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _apply_op(get_op("_rminus_scalar"), None, [self],
                         {"scalar": float(other)})

    def __mul__(self, other):
        return self._binary(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _apply_op(get_op("_rdiv_scalar"), None, [self],
                         {"scalar": float(other)})

    def __pow__(self, other):
        return self._binary(other, "elemwise_power", "_power_scalar")

    def __neg__(self):
        return _apply_op(get_op("negative"), None, [self], {})

    def __eq__(self, other):
        if isinstance(other, (Symbol, int, float)):
            return self._binary(other, "broadcast_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (Symbol, int, float)):
            return self._binary(other, "broadcast_not_equal",
                                "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    __hash__ = object.__hash__

    # the reference's generated op methods that are ported
    def reshape(self, shape, **kwargs):
        return _apply_op(get_op("Reshape"), kwargs.get("name"), [self],
                         {"shape": shape})

    def astype(self, dtype):
        return _apply_op(get_op("Cast"), None, [self], {"dtype": str(dtype)})

    # -- shape/type inference ---------------------------------------------
    def infer_shape(self, *args, **kwargs):
        arg_shapes, out_shapes, aux_shapes, _ = self._infer(args, kwargs)
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        try:
            return self.infer_shape(*args, **kwargs)
        except MXNetError:
            return None, None, None

    def infer_type(self, *args, **kwargs):
        known = {}
        if args:
            for name, t in zip(self.list_arguments(), args):
                if t is not None:
                    known[name] = t
        known.update(kwargs)
        try:
            _, _, _, named = self._infer((), {}, dtype_hint=known,
                                         require_shapes=False)
        except MXNetError:
            return None, None, None
        args_t = [named["arg:" + n][1] for n in self.list_arguments()]
        outs_t = [named["out:%d" % i][1] for i in range(len(self._outputs))]
        aux_t = [named["aux:" + n][1]
                 for n in self.list_auxiliary_states()]
        return args_t, outs_t, aux_t

    def _infer(self, args, kwargs, dtype_hint=None, require_shapes=True):
        """Joint shape and dtype inference: every op body runs on ``meta``
        tensors.  Variables whose shape is not given take it from their
        consumer's shape hint.  Returns ``(arg_shapes, out_shapes,
        aux_shapes, {"arg:<name>"|"aux:<name>"|"out:<i>": (shape,
        dtype)})`` with numpy dtypes."""
        from ..graph.graph import apply_node
        arg_names = self.list_arguments()
        known_shapes = {}
        if args:
            for name, s in zip(arg_names, args):
                if s is not None:
                    known_shapes[name] = tuple(s)
        for k, v in kwargs.items():
            if v is not None:
                known_shapes[k] = tuple(v)
        dtype_hint = dtype_hint or {}

        def var_meta(name, shape):
            return torch.empty(shape, device=_META,
                               dtype=to_torch_dtype(dtype_hint.get(name)))

        meta = {}   # id(node) -> list of meta tensors (None: unknown)

        def node_meta(node):
            if id(node) in meta:
                return meta[id(node)]
            if node.is_var:
                shape = known_shapes.get(node.name)
                meta[id(node)] = [None if shape is None
                                  else var_meta(node.name, shape)]
                return meta[id(node)]
            in_meta = []
            unknown = {}
            for i, (inp, idx) in enumerate(node.inputs):
                t = node_meta(inp)[idx]
                in_meta.append(t)
                if t is None:
                    unknown[i] = inp
            if unknown:
                hint = getattr(node.op, "shape_hint", None)
                if hint is None:
                    missing = [n.name for n in unknown.values()]
                    raise MXNetError(
                        "cannot infer shape of %s (inputs of %s); provide "
                        "shapes or register a shape hint" %
                        (missing, node.name))
                names = node.op.arg_names(node.params) + \
                    node.op.aux_names(node.params)
                shape_map = {names[i]: (tuple(t.shape) if t is not None
                                        else None)
                             for i, t in enumerate(in_meta)}
                hinted = hint(shape_map, node.params)
                for i, vnode in unknown.items():
                    hs = hinted.get(names[i])
                    if hs is None:
                        raise MXNetError("shape hint for %s could not infer "
                                         "%s" % (node.name, names[i]))
                    t = var_meta(vnode.name, tuple(hs))
                    meta[id(vnode)] = [t]
                    in_meta[i] = t
            vis, _ = apply_node(node, in_meta, train=True, device=_META)
            meta[id(node)] = vis
            return vis

        try:
            with torch.no_grad():
                for n, _ in self._outputs:
                    node_meta(n)
        except MXNetError:
            raise
        except (RuntimeError, ValueError, TypeError, IndexError) as e:
            raise MXNetError("shape inference failed: %s: %s"
                             % (type(e).__name__, e)) from e

        def described(t):
            return (tuple(t.shape), to_numpy_dtype(t.dtype))

        named = {}
        for node in self._topo_nodes():
            if node.is_var:
                t = meta.get(id(node), [None])[0]
                if t is None and require_shapes:
                    raise MXNetError("cannot fully infer shape of %s"
                                     % node.name)
                key = ("aux:" if node.is_aux_var else "arg:") + node.name
                named[key] = described(t) if t is not None else (None, None)
        for i, (n, idx) in enumerate(self._outputs):
            named["out:%d" % i] = described(meta[id(n)][idx])

        arg_shapes = [named["arg:" + n][0] for n in arg_names]
        out_shapes = [named["out:%d" % i][0]
                      for i in range(len(self._outputs))]
        aux_shapes = [named["aux:" + n][0]
                      for n in self.list_auxiliary_states()]
        return arg_shapes, out_shapes, aux_shapes, named

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    mesh=None, batch_names=None, partition_rules=None,
                    **kwargs):
        """Infer every argument's shape from ``kwargs`` (name -> shape),
        allocate zeros for arguments, gradients and auxiliary states on
        ``ctx`` (``None``: ``cuda:0``, raising without a card) and bind.
        ``mx.cpu()``/``mx.gpu(i)`` are accepted as ``ctx``.  ``mesh`` (a
        ``dp`` mesh of contexts), ``batch_names`` and ``partition_rules``
        bind one replica a context (see ``executor.py``)."""
        from ..context import resolve_device
        from ..executor import Executor
        from ..ndarray.ndarray import zeros
        ctx = resolve_device(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        type_dict = type_dict or {}
        args = {name: zeros(shape, ctx=ctx,
                            dtype=type_dict.get(name, _np.float32))
                for name, shape in zip(self.list_arguments(), arg_shapes)}
        aux = {name: zeros(shape, ctx=ctx,
                           dtype=type_dict.get(name, _np.float32))
               for name, shape in zip(self.list_auxiliary_states(),
                                      aux_shapes)}
        args_grad = None
        if grad_req != "null":
            args_grad = {name: zeros(a.shape, ctx=ctx, dtype=a.dtype)
                         for name, a in args.items()}
        return Executor(self, ctx, args, args_grad, grad_req, aux,
                        mesh=mesh, batch_names=batch_names,
                        partition_rules=partition_rules)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind to given arrays: ``args`` (and ``args_grad``,
        ``aux_states``) as dicts by name or lists in argument order."""
        from ..context import resolve_device
        from ..executor import Executor
        ctx = resolve_device(ctx)
        arg_names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.list_auxiliary_states(), aux_states))
        return Executor(self, ctx, args or {}, args_grad, grad_req,
                        aux_states or {})

    def eval(self, ctx=None, **kwargs):
        """Bind to the NDArrays in ``kwargs`` (by argument name) with no
        gradients and run a forward; returns the outputs."""
        exe = self.bind(ctx, args=kwargs, grad_req="null")
        return exe.forward()


    # -- serialization -----------------------------------------------------
    #: the reference's tojson schema version (its ``mxtpu_json_schema``)
    JSON_SCHEMA_VERSION = 2

    def tojson(self):
        """nnvm-style JSON (the reference's format: nodes, arg_nodes,
        heads)."""
        nodes = self._topo_nodes()
        nid = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            entry = {
                "op": "null" if n.is_var else n.op.name,
                "name": n.name,
                "inputs": [[nid[id(i)], idx, 0] for i, idx in n.inputs],
            }
            attrs = {k: str(v) for k, v in n.params.items()}
            attrs.update({k if k.startswith("__") else "__%s__" % k: v
                          for k, v in n.attrs.items()})
            if n.is_aux_var:
                attrs["__aux__"] = "True"
            if attrs:
                entry["attrs"] = attrs
            out_nodes.append(entry)
        return json.dumps({
            "nodes": out_nodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_var],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[nid[id(n)], i, 0] for n, i in self._outputs],
            "attrs": {"mxnet_version": ["int", 1100],
                      "mxtpu_json_schema": ["int",
                                            self.JSON_SCHEMA_VERSION]},
        }, indent=2)

    def save(self, fname):
        """Write :meth:`tojson` to ``fname`` atomically."""
        from ..base import atomic_write
        atomic_write(fname, self.tojson().encode("utf-8"))

    def debug_str(self):
        """One line a node in topological order: ``Variable:<name>`` or
        ``Op:<op>, Name=<name>, Inputs=[<input>[<index>], ...]``."""
        lines = []
        for n in self._topo_nodes():
            if n.is_var:
                lines.append("Variable:%s" % n.name)
            else:
                ins = ", ".join("%s[%d]" % (i.name, idx)
                                for i, idx in n.inputs)
                lines.append("Op:%s, Name=%s, Inputs=[%s]"
                             % (n.op.name, n.name, ins))
        return "\n".join(lines)


def _parse_attr_value(v):
    """An op attribute's string as the Python value it spells (a number,
    tuple, bool, None), else the string itself; python-2 long literals
    (``"(2L, 2L)"``) read as ints, as the reference's JSON upgrade does."""
    import ast
    import re
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        if isinstance(v, str) and "L" in v:
            try:
                return ast.literal_eval(re.sub(r"(\d)L\b", r"\1", v))
            except (ValueError, SyntaxError):
                pass
        return v


#: attribute keys older JSON stored bare, moved to the hidden ``__key__``
#: form on load (the reference's ``_upgrade_legacy_attrs``)
_HIDDEN_KEYS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring",
                "mirror_stage")


def _upgrade_legacy_attrs(entry, attrs):
    """Bare hidden keys become ``__key__`` attributes; ``<arg>_<key>`` on
    an op node is moved onto the matching input variable.  Returns
    ``(attrs, {arg_name: {key: value}})``."""
    out, moved = {}, {}
    for k, v in attrs.items():
        hit = False
        for hk in _HIDDEN_KEYS:
            if k == hk:
                out["__%s__" % hk] = v
                hit = True
            elif k.endswith("_" + hk) and entry.get("op") != "null":
                moved.setdefault(k[:-len(hk) - 1], {})["__%s__" % hk] = v
                hit = True
            if hit:
                break
        if not hit:
            out[k] = v
    return out, moved


def load_json(json_str):
    """A Symbol from its JSON (the reference's ``mx.sym.load_json``, with
    its upgrade of older documents: attributes under ``attrs``, ``attr``
    or ``param``, bare hidden keys, python-2 long literals)."""
    data = json.loads(json_str)
    nodes = []
    for entry in data["nodes"]:
        attrs = entry.get("attrs", entry.get("attr",
                                             entry.get("param", {}))) or {}
        attrs, moved = _upgrade_legacy_attrs(entry, attrs)
        # hidden keys stay hidden: the reference strips them to
        # ``lr_mult``, and a loaded symbol then loses its variables'
        # multipliers and initializers (fault C5)
        user_attrs = {k: v for k, v in attrs.items()
                      if k.startswith("__") and k.endswith("__")
                      and k != "__aux__"}
        params = {k: _parse_attr_value(v) for k, v in attrs.items()
                  if not (k.startswith("__") and k.endswith("__"))}
        if entry["op"] == "null":
            node = _SymNode(None, entry["name"], {}, [], attrs=user_attrs,
                            is_var=True,
                            is_aux_var=attrs.get("__aux__") == "True")
        else:
            inputs = [(nodes[i], idx) for i, idx, *_ in entry["inputs"]]
            node = _SymNode(get_op(entry["op"]), entry["name"], params,
                            inputs, attrs=user_attrs)
            for arg_name, kv in moved.items():
                for inp, _ in inputs:
                    if inp.is_var and (inp.name == arg_name or
                                       inp.name.endswith("_" + arg_name)):
                        inp.attrs.update(kv)
                        break
        nodes.append(node)
    heads = data.get("heads", [[len(nodes) - 1, 0, 0]])
    outs = [(nodes[h[0]], h[1]) for h in heads]
    return Symbol(outs[0][0], outs)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """Create a named variable (reference: mx.sym.Variable)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attr = AttrScope.current().get(attr)
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else \
            init.dumps() if hasattr(init, "dumps") else str(init)
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            attrs[k] = str(v)
    node = _SymNode(None, name, {}, [], attrs=attrs, is_var=True)
    return Symbol(node, [(node, 0)])


var = Variable


def Group(symbols):
    """Group symbols into one multi-output symbol (reference:
    mx.sym.Group)."""
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs[0][0], outs)


# ---------------------------------------------------------------------------
# Symbolic op application
# ---------------------------------------------------------------------------

def _apply_op(op, name, sym_args, params, **sym_kwargs):
    hint = op.name.lower().replace("_", "")
    if op.name.startswith("_"):
        hint = "op" + hint
    name = NameManager.current().get(name, hint)
    attrs = AttrScope.current().get(None)

    # variadic ops: fill num_args from the positional inputs, as the
    # reference's generated wrappers do
    if "num_args" in op.param_defaults and "num_args" not in params \
            and len(sym_args) > 0:
        params = dict(params, num_args=len(sym_args))

    arg_names = op.arg_names(params)
    aux_names = op.aux_names(params)

    inputs = [None] * len(arg_names)
    aux_inputs = [None] * len(aux_names)
    # positional then keyword symbol inputs; positionals beyond the
    # learnable args fill the auxiliary-state slots
    for i, s in enumerate(sym_args):
        if i < len(arg_names):
            inputs[i] = s
        elif i < len(arg_names) + len(aux_names):
            aux_inputs[i - len(arg_names)] = s
        else:
            raise MXNetError("too many positional inputs for %s" % op.name)
    for k, v in sym_kwargs.items():
        if k in arg_names:
            inputs[arg_names.index(k)] = v
        elif k in aux_names:
            aux_inputs[aux_names.index(k)] = v
        else:
            raise MXNetError("unknown input %s for %s" % (k, op.name))
    # auto-create variables for missing learnable inputs
    filled = []
    for argname, s in zip(arg_names, inputs):
        if s is None:
            s = Variable("%s_%s" % (name, argname))
        filled.append(s)
    for auxname, s in zip(aux_names, aux_inputs):
        if s is None:
            s = Variable("%s_%s" % (name, auxname))
        outs = s._outputs
        if len(outs) != 1 or not outs[0][0].is_var:
            # aux states are storage the executor writes back by name
            raise MXNetError("auxiliary input %s of %s must be a Variable"
                             % (auxname, op.name))
        outs[0][0].is_aux_var = True
        filled.append(s)

    node_inputs = []
    for s in filled:
        outs = s._outputs
        if len(outs) != 1:
            raise MXNetError("input symbols must have a single output")
        node_inputs.append(outs[0])

    node = _SymNode(op, name, params, node_inputs, attrs=attrs)
    return Symbol(node, [(node, i) for i in range(node.num_outputs())])


def make_symbol_function(op, func_name):
    def creator(*args, **kwargs):
        name = kwargs.pop("name", None)
        kwargs.pop("attr", None)
        sym_kwargs = {}
        params = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                sym_kwargs[k] = v
            else:
                params[k] = v
        return _apply_op(op, name, list(args), params, **sym_kwargs)
    creator.__name__ = func_name
    creator.__doc__ = (op.fn.__doc__ or "") + \
        "\n\nSymbolic version of operator `%s`." % op.name
    return creator


def populate(namespace):
    """Add a creator for every registered op not already in
    ``namespace``."""
    for opname, op in list(_OP_REGISTRY.items()):
        if opname not in namespace:
            namespace[opname] = make_symbol_function(op, opname)
