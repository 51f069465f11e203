"""Graph IR for the rewrite pipeline (counterpart of
``mxnet_tpu/graph/graph.py``).

A :class:`Graph` is ``(nodes, heads)`` over the ``_SymNode`` DAG a
:class:`~mxnet_tpu_torch.symbol.Symbol` denotes:

- ``nodes``: an ordered, topologically sorted node list that MAY hold
  nodes no longer reachable from the heads (fusion and CSE orphan what
  they replace); the DCE pass drops them, so every pass's before/after
  node counts are Graph-level numbers, equal to the reference's.
- ``heads``: the output entries, ``[(node, out_index), ...]``.

Passes are pure ``Graph -> Graph`` functions: :func:`rebuild` clones
exactly the nodes whose inputs changed and shares the rest.
"""
from __future__ import annotations

from ..base import MXNetError
from ..symbol.symbol import Symbol, _SymNode

__all__ = ["Graph", "rebuild", "topo_from_heads", "apply_node"]


def topo_from_heads(heads):
    """Topological order of every node reachable from ``heads``."""
    seen = set()
    order = []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for inp, _ in node.inputs:
            visit(inp)
        order.append(node)

    for n, _ in heads:
        visit(n)
    return order


class Graph:
    """The rewrite pipeline's unit of work."""

    __slots__ = ("nodes", "heads")

    def __init__(self, nodes, heads):
        self.nodes = list(nodes)
        self.heads = list(heads)

    @classmethod
    def from_symbol(cls, symbol):
        if not isinstance(symbol, Symbol):
            raise MXNetError("graph passes run over a Symbol, got %r"
                             % type(symbol).__name__)
        heads = list(symbol._outputs)
        return cls(topo_from_heads(heads), heads)

    def to_symbol(self):
        return Symbol(self.heads[0][0], list(self.heads))

    def reachable(self):
        """ids of nodes reachable from the heads."""
        return {id(n) for n in topo_from_heads(self.heads)}

    def consumers(self):
        """id(node) -> list of (consumer_node, input_slot) over ``nodes``;
        head entries appear with consumer ``None``."""
        out = {id(n): [] for n in self.nodes}
        for node in self.nodes:
            if node.is_var:
                continue
            for slot, (inp, _idx) in enumerate(node.inputs):
                out.setdefault(id(inp), []).append((node, slot))
        for n, _i in self.heads:
            out.setdefault(id(n), []).append((None, -1))
        return out

    def num_ops(self):
        return sum(1 for n in self.nodes if not n.is_var)

    def __len__(self):
        return len(self.nodes)


def _clone_node(node, new_inputs):
    return _SymNode(node.op, node.name, dict(node.params), list(new_inputs),
                    attrs=dict(node.attrs), is_var=node.is_var,
                    is_aux_var=node.is_aux_var)


def rebuild(graph, make=None):
    """Walk ``graph.nodes`` in order, remapping each node's inputs onto the
    rebuilt graph.  ``make(node, remap)``, when given, may return a
    replacement for ``node`` (its inputs already in the NEW graph via
    ``remap((old_node, idx)) -> (new_node, idx)``), or None to keep it.
    Kept nodes are shared when none of their inputs changed and cloned
    otherwise, so the input graph is never mutated; orphans stay in
    ``nodes`` (DCE's job) and the list stays topologically sorted."""
    new_of = {}

    def remap(entry):
        old, idx = entry
        return (new_of[id(old)], idx)

    new_nodes = []
    for node in graph.nodes:
        if node.is_var:
            new_of[id(node)] = node
            new_nodes.append(node)
            continue
        replacement = make(node, remap) if make is not None else None
        if replacement is not None:
            new_of[id(node)] = replacement
            new_nodes.append(replacement)
            continue
        new_inputs = [remap(e) for e in node.inputs]
        if all(n is o[0] for (n, _), o in zip(new_inputs, node.inputs)):
            new_of[id(node)] = node
        else:
            new_of[id(node)] = _clone_node(node, new_inputs)
        new_nodes.append(new_of[id(node)])
    heads = [(new_of[id(n)], i) for n, i in graph.heads]
    return Graph(new_nodes, heads)


def apply_node(node, inputs, train, device):
    """Evaluate ONE op node -- the semantics the executor's plan, constant
    folding and shape inference share: ``_train`` for train-dependent ops,
    ``_device`` for ops with no array inputs, and the split into visible
    outputs and trailing auxiliary-update extras.  Returns ``(vis,
    extra)``.  An op that draws random numbers (``Dropout``) draws from
    :mod:`mxnet_tpu_torch.random`'s generator of its device (the reference
    folds a per-node key in here)."""
    params = dict(node.params)
    if node.op.takes_train:
        params["_train"] = train
    if node.op.takes_device:
        params["_device"] = device
    out = node.op.fn(*inputs, **node.op.canon_params(params))
    flat = list(out) if isinstance(out, (tuple, list)) else [out]
    n_vis = node.op.num_outputs(node.params)
    return flat[:n_vis], flat[n_vis:]

