"""Minimal neural-network module layer for the generator zoo.

Covers exactly the subset of the Flax ``linen`` API the models use,
with Flax's parameter-tree layout, initialisers and per-parameter RNG
derivation, so parameter trees (and checkpoints saved from them) keep
their shapes and names:

- :class:`Module`: an auto-dataclass with a ``name`` field;
  submodules built inside a :func:`compact` method are named
  ``<Class>_<n>`` per class, those assigned in ``setup`` take the
  attribute name;
- ``param``/``make_rng`` (streams ``"params"``, ``"dropout"``,
  ``"latent"``), ``init(rngs, *x)`` -> ``{"params": tree}`` and
  ``apply(variables, *x, rngs=, method=, deterministic=)``;
- layers: :class:`Conv` (NHWC, kernel ``[kh, kw, cin, cout]``),
  :class:`Dense`, :class:`GroupNorm`, :class:`LayerNorm`,
  :class:`Dropout`, :class:`Sequential`, :func:`avg_pool`;
- activations from ``jax.nn`` and ``initializers = jax.nn.initializers``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import threading
from collections.abc import Callable, Sequence
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

initializers = jax.nn.initializers
relu = jax.nn.relu
sigmoid = jax.nn.sigmoid
leaky_relu = jax.nn.leaky_relu
gelu = jax.nn.gelu
tanh = jnp.tanh

# Modules whose compact method or setup is running on this thread,
# innermost last, as (module, kind).  A module constructed while its
# would-be parent is on top of this stack is bound to that parent.
_frames = threading.local()


def _stack() -> list:
    if not hasattr(_frames, "stack"):
        _frames.stack = []
    return _frames.stack


def _fold_in_path(key, path: tuple):
    """Fold a path of names and counters into ``key`` by its SHA-1
    hash: Flax's derivation, so a given init key yields the same
    parameters as the Flax modules this layer replaced."""
    if not path:
        return key
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


class _Scope:
    """One module's slice of the variables plus its RNG counters."""

    def __init__(self, params: dict, rngs: dict, path: tuple,
                 initializing: bool, parent: _Scope | None = None):
        self.params = params
        self.rngs = rngs
        self.path = path
        self.initializing = initializing
        self.parent = parent
        self.children: dict[str, _Scope] = {}
        self.counters: dict[str, int] = {}

    def child(self, name: str) -> _Scope:
        if name not in self.children:
            sub = {} if self.initializing else self.params.get(name, {})
            self.children[name] = _Scope(sub, self.rngs, self.path + (name,),
                                         self.initializing, self)
        return self.children[name]

    def _attach(self):
        """Link this scope's dict into its parent's, so modules without
        parameters leave no empty entry (as in Flax)."""
        if self.parent is not None and self.path[-1] not in self.parent.params:
            self.parent._attach()
            self.parent.params[self.path[-1]] = self.params

    def make_rng(self, stream: str):
        if stream not in self.rngs:
            if "params" not in self.rngs:
                raise ValueError(
                    f"{'/'.join(self.path) or 'module'} needs an RNG for "
                    f"{stream!r}: pass rngs={{{stream!r}: key}}")
            stream = "params"
        n = self.counters[stream] = self.counters.get(stream, 0) + 1
        return _fold_in_path(self.rngs[stream], self.path + (n,))

    def param(self, name: str, init_fn: Callable, *args):
        if name not in self.params:
            if not self.initializing:
                raise KeyError(f"parameter {'/'.join(self.path + (name,))} "
                               "is missing from the variables")
            self.params[name] = init_fn(self.make_rng("params"), *args)
            self._attach()
        return self.params[name]


def compact(fn):
    """Mark a method whose body creates its submodules inline."""
    fn._nn_compact = True
    return fn


def _wrap_method(fn):
    is_compact = getattr(fn, "_nn_compact", False)

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._scope is None:
            raise RuntimeError(
                f"{type(self).__name__} is unbound: call it through "
                "init/apply or from a parent's compact method or setup")
        self._run_setup()
        if is_compact:
            # a second call reuses the first call's submodule names,
            # hence its parameters
            self._autonames = {}
        stack = _stack()
        stack.append((self, "compact" if is_compact else "method"))
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapped


@dataclasses.dataclass(eq=False)
class Module:
    """Base class: subclasses become dataclasses whose public methods
    run inside the module's variable scope."""

    name: str | None = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for attr, fn in list(vars(cls).items()):
            if (inspect.isfunction(fn) and attr != "setup"
                    and (attr == "__call__" or not attr.startswith("_"))):
                setattr(cls, attr, _wrap_method(fn))
        dataclasses.dataclass(cls, eq=False)

    def __post_init__(self):
        self._scope = None
        self._setup_done = False
        self._autonames: dict[str, int] = {}
        stack = _stack()
        if stack and stack[-1][1] == "compact":
            parent = stack[-1][0]
            if self.name is None:
                prefix = type(self).__name__
                n = parent._autonames.get(prefix, 0)
                parent._autonames[prefix] = n + 1
                self.name = f"{prefix}_{n}"
            self._scope = parent._scope.child(self.name)

    def __setattr__(self, attr: str, value: Any):
        stack = _stack()
        if (stack and stack[-1][0] is self and stack[-1][1] == "setup"
                and isinstance(value, Module)):
            value.name = attr
            value._scope = self._scope.child(attr)
        object.__setattr__(self, attr, value)

    def setup(self):
        """Assign submodules as attributes (named after them)."""

    def _run_setup(self):
        if self._setup_done:
            return
        self._setup_done = True
        stack = _stack()
        stack.append((self, "setup"))
        try:
            self.setup()
        finally:
            stack.pop()

    def param(self, name: str, init_fn: Callable, *args):
        """This module's parameter ``name``, created at init time as
        ``init_fn(key, *args)``."""
        return self._scope.param(name, init_fn, *args)

    def make_rng(self, stream: str = "params"):
        """A fresh key from ``stream`` (falls back to ``"params"``)."""
        return self._scope.make_rng(stream)

    def _run_root(self, params: dict, rngs: dict, initializing: bool,
                  method, args, kwargs):
        stack = _stack()
        stack.append((None, "root"))  # keep the copy unbound
        try:
            root = dataclasses.replace(self)
        finally:
            stack.pop()
        root._scope = _Scope(params, dict(rngs), (), initializing)
        if method is None:
            method = type(self).__call__
        method = getattr(method, "__func__", method)
        return method(root, *args, **kwargs)

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        """Create the parameters by running the module once."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        params: dict = {}
        self._run_root(params, rngs, True, method, args, kwargs)
        return {"params": params}

    def apply(self, variables: dict, *args, rngs: dict | None = None,
              method=None, **kwargs):
        """Run ``method`` (default ``__call__``) with ``variables``."""
        return self._run_root(variables["params"], rngs or {}, False,
                              method, args, kwargs)


def _tuple(v, n: int) -> tuple:
    return (v,) * n if isinstance(v, int) else tuple(v)


class Dense(Module):
    features: int

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", initializers.lecun_normal(),
                            (x.shape[-1], self.features), jnp.float32)
        bias = self.param("bias", initializers.zeros, (self.features,),
                          jnp.float32)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        return y + bias


class Conv(Module):
    """2D convolution over NHWC inputs."""

    features: int
    kernel_size: Sequence[int]
    strides: int | Sequence[int] = 1
    padding: str = "SAME"
    kernel_dilation: int | Sequence[int] = 1

    @compact
    def __call__(self, x):
        ks = tuple(self.kernel_size)
        kernel = self.param("kernel", initializers.lecun_normal(),
                            ks + (x.shape[-1], self.features), jnp.float32)
        bias = self.param("bias", initializers.zeros, (self.features,),
                          jnp.float32)
        y = lax.conv_general_dilated(
            x, kernel, _tuple(self.strides, len(ks)), self.padding,
            rhs_dilation=_tuple(self.kernel_dilation, len(ks)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y + bias


def _normalize(mdl: Module, x, mean, var, epsilon: float):
    c = x.shape[-1]
    mul = lax.rsqrt(var + epsilon) * mdl.param(
        "scale", initializers.ones, (c,), jnp.float32)
    return (x - mean) * mul + mdl.param(
        "bias", initializers.zeros, (c,), jnp.float32)


class GroupNorm(Module):
    """Statistics over all non-batch axes within each channel group;
    variance as E[x^2] - E[x]^2 clamped at 0."""

    num_groups: int = 32
    epsilon: float = 1e-6

    @compact
    def __call__(self, x):
        c = x.shape[-1]
        if c % self.num_groups:
            raise ValueError(f"{self.num_groups} groups do not divide "
                             f"{c} channels")
        g = x.reshape(x.shape[:-1] + (self.num_groups, c // self.num_groups))
        axes = tuple(range(1, x.ndim - 1)) + (x.ndim,)
        mean = jnp.mean(g, axes)
        var = jnp.maximum(0.0, jnp.mean(g * g, axes) - mean * mean)
        size = c // self.num_groups
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (c,)
        mean = jnp.repeat(mean, size, axis=-1).reshape(shape)
        var = jnp.repeat(var, size, axis=-1).reshape(shape)
        return _normalize(self, x, mean, var, self.epsilon)


class LayerNorm(Module):
    """Statistics over the last axis."""

    epsilon: float = 1e-6

    @compact
    def __call__(self, x):
        mean = jnp.mean(x, -1, keepdims=True)
        var = jnp.maximum(0.0, jnp.mean(x * x, -1, keepdims=True)
                          - mean * mean)
        return _normalize(self, x, mean, var, self.epsilon)


class Dropout(Module):
    rate: float

    @compact
    def __call__(self, x, *, deterministic: bool):
        if self.rate == 0.0 or deterministic:
            return x
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep, x.shape)
        return lax.select(mask, x / keep, jnp.zeros_like(x))


class Sequential(Module):
    """Apply ``layers`` in order (modules or plain functions)."""

    layers: Sequence[Callable]

    def __call__(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


def avg_pool(x, window_shape: Sequence[int],
             strides: Sequence[int] | None = None, padding: str = "VALID"):
    """Mean over windows of the spatial axes of an NHWC array."""
    window = tuple(window_shape)
    strides = tuple(strides) if strides is not None else (1,) * len(window)
    y = lax.reduce_window(x, 0.0, lax.add, (1,) + window + (1,),
                          (1,) + strides + (1,), padding)
    return y / np.prod(window)
