"""Imperative autograd over torch's own autograd (counterpart of
``mxnet_tpu/autograd.py``).

The reference tapes every op recorded inside ``record()`` and walks the
tape on ``backward()``, one jitted VJP per node.  Here the tape is torch's
graph: an op recorded inside ``record()`` builds it, and ``backward``
applies it.  There is no per-node VJP to compile or cache.  MXNet's laws
stay:

- *recording*: inside :func:`record` an ``nd`` op or a block's forward
  builds a graph (``torch.enable_grad``); outside it, ``nd`` ops and
  :class:`~.gluon.nn.Block` forwards run under ``torch.no_grad()``, as
  MXNet records nothing there, even on marked variables;
- *training*: :func:`is_training` switches dropout on.  ``record()`` turns
  it on by default, :func:`pause` off;
- *leaves*: :func:`mark_variables` (``NDArray.attach_grad``) makes an
  array's tensor a leaf that requires grad, with a zero gradient buffer
  and a ``grad_req``; the buffer is also the leaf's ``.grad``, so a
  torch ``backward()`` of raw tensors computed from the leaf adds into
  the same buffer.  :func:`backward` writes (``write``) or adds
  (``add``) each reached leaf's gradient into that buffer in place
  (``torch.autograd.grad``, so nothing else accumulates behind MXNet's
  back); :func:`grad` returns the gradients and touches no buffer;
- *head gradients* default to ones (``SoftmaxOutput`` ignores them, as
  its backward does); a head that was not recorded reaches nothing, and
  ``backward`` changes no gradient, as the reference's;
  ``retain_graph=False`` frees the graph, and a second ``backward``
  through it raises (the reference keeps its tape nodes reachable from
  the heads and runs it again).

A Gluon block fed NDArrays returns NDArrays, and its loss's
``backward()`` is :func:`backward`; fed raw tensors it returns tensors,
whose ``backward()`` is torch's.  Either way a parameter's gradient lands
in its one buffer (:mod:`.gluon.parameter`), where the
:class:`~.gluon.Trainer` reads it.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad"]

_STATE = threading.local()


def _state():
    if not hasattr(_STATE, "recording"):
        _STATE.recording = False
        _STATE.training = False
        # marked NDArrays by id (a WeakSet would compare arrays with
        # NDArray.__eq__, which is an op)
        _STATE.variables = weakref.WeakValueDictionary()
    return _STATE


def is_recording():
    return _state().recording


def is_training():
    return _state().training


class _RecordingStateScope:
    """Sets (recording, training) for its body and restores them after;
    ``None`` leaves a switch as it is.  Recording scopes also set torch's
    grad mode."""

    def __init__(self, is_record, train_mode):
        self._enter_record = is_record
        self._enter_train = train_mode
        self._prev = None
        self._grad = None

    def __enter__(self):
        st = _state()
        self._prev = (st.recording, st.training)
        if self._enter_record is not None:
            st.recording = self._enter_record
            self._grad = torch.set_grad_enabled(self._enter_record)
            self._grad.__enter__()
        if self._enter_train is not None:
            st.training = self._enter_train
        return self

    def __exit__(self, *args):
        if self._grad is not None:
            self._grad.__exit__(*args)
            self._grad = None
        st = _state()
        st.recording, st.training = self._prev


def record(train_mode=True):
    """Scope whose block forwards build a graph for ``backward()``."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope inside ``record()`` that records nothing."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def set_recording(is_recording):  # noqa: A002 - reference API name
    """Set the recording switch; returns the previous value.  ``nd`` ops
    read it at every call."""
    st = _state()
    prev, st.recording = st.recording, bool(is_recording)
    return prev


def set_training(train_mode):
    st = _state()
    prev, st.training = st.training, bool(train_mode)
    return prev


# ---------------------------------------------------------------------------
# Leaves and backward
# ---------------------------------------------------------------------------

def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Mark NDArrays as leaves: each holds a tensor that requires grad,
    with gradient buffer ``gradients[i]`` (zeros by default) and
    ``grad_reqs[i]`` (``write``, ``add`` or ``null``)."""
    from .ndarray.ndarray import NDArray
    if isinstance(variables, NDArray):
        variables = [variables]
        gradients = [gradients] if gradients is not None else None
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    st = _state()
    for i, v in enumerate(variables):
        if grad_reqs[i] not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (grad_reqs[i],))
        g = gradients[i] if gradients is not None else None
        v._grad = g if g is not None else \
            NDArray(torch.zeros_like(v._data, requires_grad=False), v._device)
        v._grad_req = grad_reqs[i]
        # a leaf: a recorded array stops carrying its history
        v._set_data(v._data)
        st.variables[id(v)] = v


def _head_grads(heads, head_grads):
    out = []
    for h, hg in zip(heads, head_grads):
        if hg is None:
            out.append(torch.ones_like(h._data))
        else:
            t = hg._data if hasattr(hg, "_data") else torch.as_tensor(hg)
            out.append(t.to(h._data.device, h._data.dtype))
    return out


def _gradients(heads, variables, head_grads, retain_graph):
    """torch's gradients of ``heads`` w.r.t. the tensors of ``variables``
    (``None`` where a variable is not reached)."""
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    # only recorded heads carry a graph
    pairs = [(h, hg) for h, hg in zip(heads, head_grads or
                                      [None] * len(heads))
             if h._data.requires_grad]
    live = [i for i, v in enumerate(variables) if v._data.requires_grad]
    grads = [None] * len(variables)
    if not live or not pairs:
        return grads        # nothing recorded reaches a marked variable
    heads, head_grads = zip(*pairs)
    try:
        got = torch.autograd.grad(
            [h._data for h in heads], [variables[i]._data for i in live],
            _head_grads(heads, head_grads), retain_graph=retain_graph,
            allow_unused=True)
    except RuntimeError as e:
        if "second time" in str(e):
            raise MXNetError("backward through a graph that an earlier "
                             "backward freed: pass retain_graph=True to "
                             "the first") from e
        raise
    for i, g in zip(live, got):
        grads[i] = g
    return grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Apply the recorded graph from ``heads`` (head gradients default to
    ones) and write or add each reached marked variable's gradient into
    its ``.grad`` per its ``grad_req``."""
    variables = [v for v in list(_state().variables.values())
                 if v._grad_req in ("write", "add")]
    grads = _gradients(heads, variables, head_grads, bool(retain_graph))
    # one multi-tensor copy (write) and one add (add) over the buffers
    writes, adds = ([], []), ([], [])
    with torch.no_grad():
        for v, g in zip(variables, grads):
            if g is None:
                continue
            buf = v._grad._data
            if (buf.shape, buf.dtype, buf.device) != \
                    (g.shape, g.dtype, g.device):
                if v._grad_req == "add":
                    buf.add_(g)
                else:
                    v._grad._assign(g)
                continue
            pair = adds if v._grad_req == "add" else writes
            pair[0].append(buf)
            pair[1].append(g)
        if writes[0]:
            torch._foreach_copy_(*writes)
        if adds[0]:
            torch._foreach_add_(*adds)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` w.r.t. ``variables`` as new NDArrays (zeros
    where a variable is not reached); no ``.grad`` buffer changes."""
    from .ndarray.ndarray import NDArray
    if isinstance(variables, NDArray):
        variables = [variables]
    grads = _gradients(heads, variables, head_grads, bool(retain_graph))
    return [NDArray(g.detach() if g is not None
                    else torch.zeros_like(v._data, requires_grad=False),
                    v._device) for v, g in zip(variables, grads)]
