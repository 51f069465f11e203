"""First-class precision policy (the PyTorch package's copy of
``mxnet_tpu/precision.py``).

One object answers every "what dtype does X run in?" question: a
:class:`PrecisionPolicy` resolves per-layer **param / compute / output**
dtypes, optionally carries a serving ``kv_dtype``, and owns the
:class:`LossScaler` the fused training steps consult.

Resolution laws (the reference's, held by ``tests/test_torch_precision.py``):

1. ``compute`` defaults to ``param``; ``output`` defaults to ``compute``.
2. Per-layer ``overrides`` are fnmatch patterns checked in declaration
   order; the LAST matching pattern wins **field-wise**, and unset fields
   fall through to the policy-wide defaults, then law 1.
3. Dtype names are canonicalised (``fp32``/``float32`` are one name), so
   two spellings of one policy hash identically.

:meth:`PrecisionPolicy.fingerprint` hashes the same description as the
reference's, so the two packages give one policy the same fingerprint;
the fused update of the Module and the Gluon ``Trainer``
(``optimizer.FusedUpdate``) keys on it.  The loss scaler's dynamic scale stays out of the
hash: it reaches the gradients through the step's ``rescale_grad``
scalar (``1 / scale``), and :meth:`LossScaler.update` consumes the
divergence guard's verdict (back off on a skipped step, grow after a
clean streak), so the guard's skip accounting is unchanged by a scaler.
"""
from __future__ import annotations

import fnmatch
import hashlib
from collections import namedtuple

__all__ = ["PrecisionPolicy", "LossScaler", "Resolved",
           "policy_fingerprint"]

#: canonical dtype names the policy speaks, and every accepted spelling
_CANON = {
    "fp32": "fp32", "float32": "fp32", "f32": "fp32",
    "bf16": "bf16", "bfloat16": "bf16",
    "fp16": "fp16", "float16": "fp16", "f16": "fp16",
}

_TORCH_DTYPES = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}

Resolved = namedtuple("Resolved", ["param", "compute", "output"])


def _canon_dtype(dt, field):
    """Canonical short name for a dtype spelling (law 3)."""
    if dt is None:
        return None
    name = getattr(dt, "__name__", None) or getattr(dt, "name", None) \
        or str(dt)
    key = name.strip().lower()
    if key.startswith("torch."):      # a torch dtype: torch.float32
        key = key[len("torch."):]
    if key not in _CANON:
        raise ValueError(
            "unsupported %s dtype %r (want one of %s)"
            % (field, dt, "/".join(sorted(set(_CANON.values())))))
    return _CANON[key]


def torch_dtype(name):
    """The torch dtype of a canonical policy dtype name."""
    import torch
    return getattr(torch, _TORCH_DTYPES[_canon_dtype(name, "torch")])


class LossScaler:
    """Dynamic (or static) loss scaling, driven by the divergence-guard
    verdict.  ``update(step_ok)`` is called once per fused step with
    the guard's all-finite verdict: a skipped step backs the scale off,
    ``growth_interval`` consecutive good steps grow it.  The scaler
    never decides whether a step is skipped — that stays the guard's
    job, so skip accounting is unchanged by its presence."""

    def __init__(self, init_scale=2.0 ** 15, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=200, dynamic=True,
                 max_scale=2.0 ** 24):
        if init_scale <= 0:
            raise ValueError("init_scale must be positive")
        if not (0.0 < backoff_factor < 1.0):
            raise ValueError("backoff_factor must be in (0, 1)")
        if growth_factor <= 1.0:
            raise ValueError("growth_factor must be > 1")
        self.scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.dynamic = bool(dynamic)
        self.max_scale = float(max_scale)
        self.good_steps = 0
        self.overflows = 0

    @property
    def unscale(self):
        """Multiplier that removes the loss scale from gradients, folded
        into the fused step's ``rescale_grad``."""
        return 1.0 / self.scale

    def scale_loss(self, loss):
        """Scale a loss value/symbol/array by the current scale."""
        return loss * self.scale

    def update(self, step_ok):
        """Consume one divergence-guard verdict.  Returns the (possibly
        updated) scale."""
        if not self.dynamic:
            return self.scale
        if step_ok:
            self.good_steps += 1
            if self.good_steps >= self.growth_interval:
                self.scale = min(self.scale * self.growth_factor,
                                 self.max_scale)
                self.good_steps = 0
        else:
            self.overflows += 1
            self.good_steps = 0
            self.scale = max(self.scale * self.backoff_factor, 1.0)
        return self.scale

    def config_key(self):
        """Static configuration only: the dynamic scale stays out, so a
        scale update never re-keys the fused step."""
        return ("loss_scaler", self.dynamic, self.growth_factor,
                self.backoff_factor, self.growth_interval)


class PrecisionPolicy:
    """Per-layer param/compute/output dtype resolution + optional
    serving ``kv_dtype`` + optional :class:`LossScaler`.

    ``overrides``: ``{fnmatch_pattern: {"param"/"compute"/"output":
    dtype}}`` applied to layer names in declaration order, last match
    winning field-wise (law 2)."""

    def __init__(self, param_dtype="fp32", compute_dtype=None,
                 output_dtype=None, overrides=None, kv_dtype=None,
                 loss_scaler=None):
        self.param_dtype = _canon_dtype(param_dtype, "param")
        self.compute_dtype = _canon_dtype(compute_dtype, "compute")
        self.output_dtype = _canon_dtype(output_dtype, "output")
        self.overrides = []
        for pat, ov in (overrides or {}).items():
            bad = set(ov) - {"param", "compute", "output"}
            if bad:
                raise ValueError("unknown override fields %r for %r"
                                 % (sorted(bad), pat))
            self.overrides.append((str(pat), {
                f: _canon_dtype(v, f) for f, v in ov.items()}))
        # serving KV-page storage mode, validated as the allocator does
        if kv_dtype is None:
            self.kv_dtype = None
        else:
            from .serving.kv_cache import normalize_kv_dtype
            self.kv_dtype = normalize_kv_dtype(kv_dtype)
        self.loss_scaler = loss_scaler

    def resolve(self, name):
        """Resolved (param, compute, output) canonical dtype names for
        layer ``name`` under laws 1–3."""
        got = {"param": None, "compute": None, "output": None}
        for pat, ov in self.overrides:
            if fnmatch.fnmatchcase(str(name), pat):
                got.update(ov)          # later match wins, field-wise
        param = got["param"] or self.param_dtype
        compute = got["compute"] or self.compute_dtype or param
        output = got["output"] or self.output_dtype or compute
        return Resolved(param, compute, output)

    def cast_params(self, tree, name="*"):
        """Every tensor of a (nested dict, list or tuple) parameter tree
        cast to the resolved ``param`` dtype for ``name``."""
        dt = torch_dtype(self.resolve(name).param)

        def cast(x):
            if isinstance(x, dict):
                return {k: cast(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(cast(v) for v in x)
            return x.to(dt)
        return cast(tree)

    def fingerprint(self):
        """Stable hash of everything that alters a fused step: dtype
        layout, overrides, kv_dtype, the scaler's *configuration* (never
        its dynamic scale)."""
        scaler = self.loss_scaler.config_key() \
            if self.loss_scaler is not None else None
        spec = (self.param_dtype, self.compute_dtype, self.output_dtype,
                tuple((p, tuple(sorted(ov.items())))
                      for p, ov in self.overrides),
                self.kv_dtype, scaler)
        return hashlib.sha256(repr(spec).encode("utf-8")).hexdigest()


def policy_fingerprint(policy):
    """Fingerprint of an optional policy ('' for None), which the fused
    steps fold into their keys."""
    return "" if policy is None else policy.fingerprint()
