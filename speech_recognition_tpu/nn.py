"""A small functional module system: the subset of the Flax Linen API the
model families use, with no dependency beyond JAX.

Models are dataclasses whose methods read and create variables through a
per-call *frame* (``init`` / ``apply``), exactly like Linen:

- ``Module`` subclasses become dataclasses with keyword-only ``name`` and
  ``parent`` fields.  A module built inside another module's ``setup`` or
  ``@compact`` method is that module's child: explicitly named, named after
  the attribute it is assigned to in ``setup``, or auto-named
  ``{Class}_{n}`` inside a compact method.  Variables live at the child's
  path of names, so parameter trees are the nested dicts Linen produces.
- ``init(rngs, *args, method=None)`` returns every collection written;
  ``apply(variables, *args, rngs=None, method=None, mutable=False)``
  returns the output, or ``(output, mutated collections)``.
- ``param``, ``variable``, ``make_rng``, ``has_rng``, ``sow`` and
  ``is_initializing`` behave as in Linen, and ``make_rng`` derives keys the
  way Linen does, so initial values equal Linen's (tests/test_nn.py checks
  trees, values and outputs against Flax for every model family).  Inside
  ``scan`` and ``remat`` the random streams differ from Linen's lifted ones.
- Layers: ``Dense``, ``Embed``, ``LayerNorm``, ``BatchNorm``, ``Dropout``.
- Transforms: ``scan`` (stacked variables, split or broadcast rngs,
  ``broadcast`` arguments), ``remat`` (``jax.checkpoint`` around a module
  call) and ``cond`` (``lax.cond`` over two functions of the module).
"""

import dataclasses
import hashlib
import threading
import types
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

# activations and initializers re-exported under their Linen names
from jax.nn import glu, log_sigmoid, log_softmax, logsumexp, one_hot, relu, sigmoid, softmax, swish  # noqa: F401
from jax.nn import initializers  # noqa: F401

__all__ = [
    "Module", "compact", "Dense", "Embed", "LayerNorm", "BatchNorm", "Dropout",
    "scan", "remat", "cond", "broadcast", "initializers",
]


class _Unspecified:
    def __repr__(self):
        return "<unspecified>"


_UNSPECIFIED = _Unspecified()
# marks an in_axes entry of ``scan`` whose argument is passed unchanged to
# every iteration
broadcast = object()

_context = threading.local()


def _module_stack():
    if not hasattr(_context, "stack"):
        _context.stack = []
    return _context.stack


def compact(fn):
    """Mark a method whose body may create submodules inline."""
    fn._compact = True
    return fn


class _Frame:
    """Variables, rngs and mutability of one ``init`` / ``apply`` call."""

    def __init__(self, variables, rngs, mutable, initializing: bool):
        self.variables = _copy_tree(variables)
        self.rngs = dict(rngs)
        self.mutable = mutable  # True, or a set of collection names
        self.initializing = initializing
        self.rng_counters: Dict[Tuple, int] = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable

    def get(self, col: str, path: Tuple[str, ...]):
        node = self.variables.get(col)
        for key in path:
            if not isinstance(node, dict) or key not in node:
                return None
            node = node[key]
        return node

    def node(self, col: str, path: Tuple[str, ...]) -> dict:
        """The dict at ``path`` in ``col``, created on the way if absent."""
        node = self.variables.setdefault(col, {})
        for key in path:
            node = node.setdefault(key, {})
        return node

    def make_rng(self, name: str, path: Tuple[str, ...]):
        """Fold the SHA-1 of (path names, per-module call count) into the
        frame's key — Linen's derivation, so initial values match Linen's."""
        if name not in self.rngs:
            if "params" not in self.rngs:
                raise ValueError(f"no '{name}' rng was passed to init/apply (module {'/'.join(path)})")
            name = "params"
        count = self.rng_counters.get((name, path), 0) + 1
        self.rng_counters[(name, path)] = count
        digest = hashlib.sha1()
        for part in path:
            digest.update(part.encode("utf-8"))
        digest.update(count.to_bytes((count.bit_length() + 7) // 8, byteorder="big"))
        folded = int.from_bytes(digest.digest()[:4], byteorder="big")
        return jax.random.fold_in(self.rngs[name], jnp.uint32(folded))


def _copy_tree(tree):
    """Copy the dict structure (not the arrays) so writes never reach the caller."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


class _State:
    def __init__(self):
        self.frame: Optional[_Frame] = None
        self.path: Tuple[str, ...] = ()
        self.setup_done = False
        self.in_setup = False
        self.autoname: Dict[str, int] = {}


class Variable:
    """Handle on one variable of a collection (``.value`` reads and writes)."""

    def __init__(self, frame: _Frame, col: str, path: Tuple[str, ...], name: str):
        self._frame, self._col, self._path, self._name = frame, col, path, name

    @property
    def value(self):
        return self._frame.get(self._col, self._path + (self._name,))

    @value.setter
    def value(self, v):
        if not self._frame.is_mutable(self._col):
            raise ValueError(f"collection '{self._col}' is not mutable in this apply")
        self._frame.node(self._col, self._path)[self._name] = v


def _wrap_method(fn):
    is_compact = getattr(fn, "_compact", False)

    def wrapped(self, *args, **kwargs):
        st = self._state
        if st.frame is None:
            return fn(self, *args, **kwargs)
        self._try_setup()
        stack = _module_stack()
        stack.append(self)
        saved = st.autoname
        if is_compact:
            st.autoname = {}
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()
            st.autoname = saved

    wrapped.__name__ = fn.__name__
    wrapped.__qualname__ = getattr(fn, "__qualname__", fn.__name__)
    wrapped.__doc__ = fn.__doc__
    wrapped.__wrapped__ = fn
    return wrapped




class Module:
    """Base class of every layer and model (see the module docstring)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=False, repr=False)
        # methods run with the module bound: setup done, and the module on
        # the stack so that submodules built inside become its children
        for attr, value in list(cls.__dict__.items()):
            if not isinstance(value, types.FunctionType) or attr == "setup":
                continue
            if attr.startswith("__") and attr != "__call__":
                continue
            setattr(cls, attr, _wrap_method(value))

    def __post_init__(self):
        object.__setattr__(self, "_state", _State())
        parent = self.parent
        if parent is _UNSPECIFIED:
            stack = _module_stack()
            parent = stack[-1] if stack else None
            object.__setattr__(self, "parent", parent)
        if parent is None:
            return
        pst = parent._state
        if pst.frame is None:
            # built by an unbound module (e.g. a transform outside init/apply)
            object.__setattr__(self, "parent", None)
            return
        if self.name is None:
            if pst.in_setup:
                return  # named by the attribute it is assigned to
            cls_name = type(self).__name__
            n = pst.autoname.get(cls_name, 0)
            pst.autoname[cls_name] = n + 1
            object.__setattr__(self, "name", f"{cls_name}_{n}")
        self._bind(pst.frame, pst.path + (self.name,))

    def _bind(self, frame: _Frame, path: Tuple[str, ...]):
        self._state.frame = frame
        self._state.path = path

    def __setattr__(self, attr, value):
        st = self.__dict__.get("_state")
        if st is not None and st.in_setup:
            if isinstance(value, Module):
                self._adopt(attr, value)
            elif isinstance(value, (list, tuple)):
                for i, v in enumerate(value):
                    if isinstance(v, Module):
                        self._adopt(f"{attr}_{i}", v)
        object.__setattr__(self, attr, value)

    def _adopt(self, name: str, child: "Module"):
        if child.parent is self and child._state.frame is None and child.name is None:
            object.__setattr__(child, "name", name)
            child._bind(self._state.frame, self._state.path + (name,))

    def __getattr__(self, attr):
        # only reached when normal lookup fails: run a pending setup first
        if attr.startswith("_"):
            raise AttributeError(attr)
        st = self.__dict__.get("_state")
        if st is not None and st.frame is not None and not st.setup_done:
            self._try_setup()
            return object.__getattribute__(self, attr)
        raise AttributeError(f"{type(self).__name__} has no attribute '{attr}'")

    def _try_setup(self):
        st = self._state
        if st.setup_done:
            return
        st.setup_done = True
        st.in_setup = True
        stack = _module_stack()
        stack.append(self)
        try:
            self.setup()
        finally:
            stack.pop()
            st.in_setup = False

    def setup(self):
        """Build submodules and variables (runs lazily, once per bind)."""

    # ------------------------------------------------------------ dataclass
    def _field_values(self) -> Dict[str, Any]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.init and f.name not in ("parent", "name")
        }

    def clone(self, **overrides) -> "Module":
        """A fresh unbound copy with some fields replaced."""
        values = self._field_values()
        values["name"] = self.name
        values.update(overrides)
        values.setdefault("parent", None)
        return type(self)(**values)

    # -------------------------------------------------------------- entry
    def _run(self, frame: _Frame, method, args, kwargs):
        module = self.clone(parent=None)
        module._bind(frame, ())
        if method is None:
            fn = type(module).__call__
        elif isinstance(method, str):
            fn = getattr(type(module), method)
        else:
            fn = method
        return fn(module, *args, **kwargs)

    def init_with_output(self, rngs, *args, method=None, mutable=True, **kwargs):
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        frame = _Frame({}, rngs, mutable if mutable is True else set(mutable), initializing=True)
        out = self._run(frame, method, args, kwargs)
        return out, frame.variables

    def init(self, rngs, *args, method=None, **kwargs):
        """Create every variable; returns ``{collection: tree}``."""
        return self.init_with_output(rngs, *args, method=method, **kwargs)[1]

    def apply(self, variables, *args, rngs=None, method=None, mutable=False, **kwargs):
        """Run ``method`` (default ``__call__``) with the given variables."""
        if mutable is True:
            cols = True
        elif mutable is False or mutable is None:
            cols = set()
        elif isinstance(mutable, str):
            cols = {mutable}
        else:
            cols = set(mutable)
        frame = _Frame(variables, rngs or {}, cols, initializing=False)
        out = self._run(frame, method, args, kwargs)
        if mutable is False or mutable is None:
            return out
        names = frame.variables.keys() if cols is True else [c for c in cols if c in frame.variables]
        return out, {c: frame.variables[c] for c in names}

    # ---------------------------------------------------------- variables
    def _frame(self) -> _Frame:
        frame = self._state.frame
        if frame is None:
            raise ValueError(f"{type(self).__name__} is unbound: call it through init/apply")
        return frame

    def param(self, name: str, init_fn: Callable, *init_args):
        frame = self._frame()
        path = self._state.path
        value = frame.get("params", path + (name,))
        if value is not None:
            return value
        if not (frame.initializing and frame.is_mutable("params")):
            raise ValueError(f"parameter '{'/'.join(path + (name,))}' is missing from the variables")
        value = init_fn(self.make_rng("params"), *init_args)
        frame.node("params", path)[name] = value
        return value

    def variable(self, col: str, name: str, init_fn: Callable, *init_args) -> Variable:
        frame = self._frame()
        path = self._state.path
        if frame.get(col, path + (name,)) is None:
            if not frame.is_mutable(col):
                raise ValueError(f"variable '{col}/{'/'.join(path + (name,))}' is missing and immutable")
            frame.node(col, path)[name] = init_fn(*init_args)
        return Variable(frame, col, path, name)

    def make_rng(self, name: str = "params"):
        return self._frame().make_rng(name, self._state.path)

    def has_rng(self, name: str) -> bool:
        return name in self._frame().rngs

    def is_initializing(self) -> bool:
        return self._frame().initializing

    def sow(self, col: str, name: str, value) -> bool:
        """Append ``value`` to the tuple ``col/<path>/name`` when ``col`` is mutable."""
        frame = self._frame()
        if not frame.is_mutable(col):
            return False
        node = frame.node(col, self._state.path)
        node[name] = node.get(name, ()) + (value,)
        return True


Module.__annotations__ = {"name": Optional[str], "parent": Any}
Module.name = dataclasses.field(default=None, kw_only=True)
Module.parent = dataclasses.field(default=_UNSPECIFIED, kw_only=True, repr=False)
dataclasses.dataclass(Module, eq=False, repr=False)


# ----------------------------------------------------------------- layers
def _promote(*xs, dtype=None):
    dtype = dtype or jnp.result_type(*[x for x in xs if x is not None])
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis (Linen ``Dense``)."""

    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs):
        kernel = self.param("kernel", self.kernel_init, (jnp.shape(inputs)[-1], self.features), self.param_dtype)
        bias = self.param("bias", self.bias_init, (self.features,), self.param_dtype) if self.use_bias else None
        inputs, kernel, bias = _promote(inputs, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(inputs, kernel, (((inputs.ndim - 1,), (0,)), ((), ())), precision=self.precision)
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class Embed(Module):
    """Table lookup ``embedding[ids]`` (Linen ``Embed``)."""

    num_embeddings: int
    features: int
    dtype: Any = None
    param_dtype: Any = jnp.float32
    embedding_init: Callable = initializers.variance_scaling(1.0, "fan_in", "normal", out_axis=0)

    def setup(self):
        self.embedding = self.param(
            "embedding", self.embedding_init, (self.num_embeddings, self.features), self.param_dtype
        )

    def __call__(self, inputs):
        if not jnp.issubdtype(inputs.dtype, jnp.integer):
            raise ValueError("Embed input must be integer ids")
        embedding = self.embedding if self.dtype is None else jnp.asarray(self.embedding, self.dtype)
        if self.num_embeddings == 1:
            return jnp.broadcast_to(embedding, inputs.shape + (self.features,))
        return jnp.take(embedding, inputs, axis=0)


def _stats(x, axes, dtype):
    """Mean and (fast, clipped) variance in at least float32."""
    dtype = jnp.promote_types(dtype or jnp.result_type(x), jnp.float32)
    x = x.astype(dtype)
    mu = x.mean(axes)
    mu2 = jnp.square(x).mean(axes)
    return mu, jnp.maximum(0.0, mu2 - jnp.square(mu))


def _normalize(mdl, x, mean, var, reduction_axes, dtype, param_dtype, epsilon, use_bias, use_scale,
               bias_init, scale_init):
    feature_shape = [1] * x.ndim
    feature_shape[-1] = x.shape[-1]
    mean = jnp.expand_dims(mean, reduction_axes)
    var = jnp.expand_dims(var, reduction_axes)
    y = x - mean
    mul = lax.rsqrt(var + epsilon)
    args = [x]
    if use_scale:
        scale = mdl.param("scale", scale_init, (x.shape[-1],), param_dtype).reshape(feature_shape)
        mul *= scale
        args.append(scale)
    y *= mul
    if use_bias:
        bias = mdl.param("bias", bias_init, (x.shape[-1],), param_dtype).reshape(feature_shape)
        y += bias
        args.append(bias)
    return jnp.asarray(y, dtype or jnp.result_type(*args))


class LayerNorm(Module):
    """Normalization over the last axis (Linen ``LayerNorm``)."""

    epsilon: float = 1e-6
    dtype: Any = None
    param_dtype: Any = jnp.float32
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = initializers.zeros
    scale_init: Callable = initializers.ones

    @compact
    def __call__(self, x):
        mean, var = _stats(x, (x.ndim - 1,), self.dtype)
        return _normalize(self, x, mean, var, (x.ndim - 1,), self.dtype, self.param_dtype, self.epsilon,
                          self.use_bias, self.use_scale, self.bias_init, self.scale_init)


class BatchNorm(Module):
    """Batch normalization over every axis but the last, with running
    statistics in the ``batch_stats`` collection (Linen ``BatchNorm``)."""

    use_running_average: Optional[bool] = None
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Any = None
    param_dtype: Any = jnp.float32
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = initializers.zeros
    scale_init: Callable = initializers.ones

    @compact
    def __call__(self, x, use_running_average: Optional[bool] = None):
        if use_running_average is None:
            use_running_average = self.use_running_average
        axes = tuple(range(x.ndim - 1))
        shape = (x.shape[-1],)
        ra_mean = self.variable("batch_stats", "mean", lambda s: jnp.zeros(s, jnp.float32), shape)
        ra_var = self.variable("batch_stats", "var", lambda s: jnp.ones(s, jnp.float32), shape)
        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            mean, var = _stats(x, axes, self.dtype)
            if not self.is_initializing():
                ra_mean.value = self.momentum * ra_mean.value + (1 - self.momentum) * mean
                ra_var.value = self.momentum * ra_var.value + (1 - self.momentum) * var
        return _normalize(self, x, mean, var, axes, self.dtype, self.param_dtype, self.epsilon,
                          self.use_bias, self.use_scale, self.bias_init, self.scale_init)


class Dropout(Module):
    """Inverted dropout with a threefry mask from the ``dropout`` rng."""

    rate: float
    broadcast_dims: Tuple[int, ...] = ()
    deterministic: Optional[bool] = None

    @compact
    def __call__(self, inputs, deterministic: Optional[bool] = None):
        if deterministic is None:
            deterministic = self.deterministic
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep = 1.0 - self.rate
        shape = list(inputs.shape)
        for dim in self.broadcast_dims:
            shape[dim] = 1
        mask = jax.random.bernoulli(self.make_rng("dropout"), p=keep, shape=shape)
        mask = jnp.broadcast_to(mask, inputs.shape)
        return lax.select(mask, inputs / keep, jnp.zeros_like(inputs))


# ------------------------------------------------------------- transforms
def _sub_variables(module: Module, cols: Iterable[str]):
    frame, path = module._frame(), module._state.path
    out = {}
    for col in cols:
        sub = frame.get(col, path)
        if sub is not None:
            out[col] = sub
    return out


def _store(module: Module, variables: Dict[str, Any]):
    frame, path = module._frame(), module._state.path
    for col, tree in variables.items():
        if not path:
            frame.variables[col] = tree
            continue
        frame.node(col, path[:-1])[path[-1]] = tree


def _rngs_for(module: Module):
    frame = module._frame()
    return {name: module.make_rng(name) for name in sorted(frame.rngs)}


def _mutable_cols(frame: _Frame):
    if frame.mutable is True:
        return True
    return sorted(frame.mutable)


def remat(target, static_argnums: Tuple[int, ...] = ()):
    """``target`` whose ``__call__`` rematerializes its activations in the
    backward pass (``jax.checkpoint``).  ``static_argnums`` count ``self``
    as argument 0, as in Linen."""

    class Remat(target):
        def __call__(self, *args):
            frame = self._frame()
            if frame.initializing:
                # initialization needs no rematerialization: run in place
                inner = target(**self._field_values(), name=self.name, parent=None)
                inner._bind(frame, self._state.path)
                return target.__call__(inner, *args)
            inner = target(**self._field_values(), parent=None)
            static = {i - 1 for i in static_argnums}
            dynamic_idx = [i for i in range(len(args)) if i not in static]
            variables = _sub_variables(self, frame.variables.keys())
            mutable = _mutable_cols(frame)

            def fn(variables, rngs, *dyn):
                full = list(args)
                for i, v in zip(dynamic_idx, dyn):
                    full[i] = v
                return inner.apply(variables, *full, rngs=rngs, mutable=mutable)

            out, updated = jax.checkpoint(fn)(variables, _rngs_for(self), *[args[i] for i in dynamic_idx])
            _store(self, updated)
            return out

    Remat.__name__ = target.__name__
    Remat.__qualname__ = target.__qualname__
    return Remat


def scan(target, variable_axes: Dict[str, int], split_rngs: Dict[str, bool], in_axes=(), length: int = None):
    """``target`` applied ``length`` times in a ``lax.scan``: ``__call__(carry,
    *args) -> (carry, ys)``.  Collections in ``variable_axes`` are stacked on
    axis 0 (only axis 0 is supported), rngs in ``split_rngs`` get one key per
    iteration, and every ``in_axes`` entry must be ``broadcast``."""
    if any(axis != 0 for axis in variable_axes.values()):
        raise NotImplementedError("scan stacks variables on axis 0 only")
    if not all(a is broadcast for a in in_axes):
        raise NotImplementedError("scan supports broadcast arguments only")

    class Scanned(target):
        def __call__(self, carry, *args):
            frame = self._frame()
            inner = target(**self._field_values(), parent=None)
            cols = list(variable_axes)
            rngs = _rngs_for(self)
            split = {k: jax.random.split(v, length) for k, v in rngs.items() if split_rngs.get(k)}
            shared = {k: v for k, v in rngs.items() if not split_rngs.get(k)}
            stacked = _sub_variables(self, cols)
            initializing = frame.initializing and not stacked
            mutable = cols if initializing else [c for c in cols if frame.is_mutable(c)]

            def body(c, xs):
                variables, keys = xs
                step_rngs = dict(shared, **keys)
                if initializing:
                    out, new_vars = inner.init_with_output(step_rngs, c, *args, mutable=set(mutable))
                    new_vars = {col: new_vars.get(col, {}) for col in cols}
                else:
                    out, new_vars = inner.apply(variables, c, *args, rngs=step_rngs, mutable=mutable)
                c, y = out
                return c, (y, new_vars)

            carry, (ys, new_vars) = lax.scan(body, carry, (stacked, split), length=length)
            if mutable:
                _store(self, {c: new_vars[c] for c in mutable if c in new_vars})
            return carry, ys

    Scanned.__name__ = target.__name__
    Scanned.__qualname__ = target.__qualname__
    return Scanned


def cond(pred, true_fun: Callable, false_fun: Callable, module: Module, *operands):
    """``lax.cond`` over ``true_fun(module, *operands)`` and
    ``false_fun(module, *operands)``.  The branches may read variables and
    draw rngs; they must not create or write variables."""
    return lax.cond(pred, lambda ops: true_fun(module, *ops), lambda ops: false_fun(module, *ops), operands)
