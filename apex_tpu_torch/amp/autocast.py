"""The O1 policy: per-op casts through a ``TorchFunctionMode``, the
function registries, the decorators and the weight-cast cache.

Counterpart of ``apex_tpu/amp/autocast.py`` (reference
``apex/amp/amp.py``, ``wrap.py`` and ``lists/``).  The JAX package
patches ``jax.numpy`` / ``jax.lax`` entry points at ``amp.init()``; the
port pushes one :class:`torch.overrides.TorchFunctionMode` instead, which
sees every call of a torch function and casts the floating tensor
arguments of the functions on its four lists (JAX's lists translated
onto the torch functions the port's modules call):

* **half** (``_HALF_LIST``, the MXU / tensor-core ops): ``F.linear``,
  the convolutions and transposed convolutions, the matmul family
  (``torch.matmul``/``mm``/``bmm``/``addmm``/``baddbmm``/``einsum``/
  ``tensordot``/``outer``/``inner``/``kron``, ``Tensor.matmul``, which
  ``a @ b`` calls): arguments to the half dtype (bfloat16 unless
  ``init(half_dtype=)``), so the product comes out in it;
* **fp32** (``_FP32_LIST``): the transcendentals, the reductions
  (``torch.sum``, ``mean``, ``var``, ``std``, ``prod``, ``cumsum``, ...),
  the ``linalg`` solvers and norms, the softmax family and the
  exp-based activations, ``binary_cross_entropy_with_logits``;
* **promote** (``_PROMOTE_LIST``): ``cat``, ``stack``, ``hstack``,
  ``where``, ...: every floating argument to the widest floating dtype
  among them;
* **banned** (``_BANNED_LIST``): probability-space
  ``binary_cross_entropy`` raises under an fp16 policy (unless
  ``allow_banned``) and runs in fp32 under bf16.

As in JAX only the namespace functions are listed (``torch.sum``, not
the method ``x.sum()``; JAX patches ``jnp.sum``, not ``Array.sum``), so
an O1 model gets JAX's dtypes op for op.  The casts are ``.to``, so
autograd's backward follows the forward's dtypes, as JAX's transpose
does.  The port's kernel wrappers are on no list, as JAX's
``pallas_call`` sites are patched by nothing: they see the dtypes their
caller passes.

``init()`` pushes the mode on the calling thread's stack and
``shutdown()`` pops it: a step traced, run under
``torch.func.functional_call`` or captured in a CUDA graph while it is
pushed runs the policy (capture runs the host code once, under the mode).
``disable_casts()`` switches the casts off inside a block.  The
registries add a torch function to a list, or put an overridable
wrapper on a Python function (restored by ``shutdown``); the decorators
return such wrappers.

The weight-cast cache (reference ``utils.py:88-117``): the cast of a
leaf tensor that requires grad (a parameter) is kept, keyed on the
tensor's identity, its ``_version`` (an in-place update makes a new
key), the dtype and the grad mode, until :func:`clear_cast_cache`
(``amp.scale_loss`` clears it on exit, ``make_train_step`` after each
step).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from ._amp_state import _amp_state, maybe_print

__all__ = ["init", "shutdown", "disable_casts",
           "cached_cast", "clear_cast_cache", "register_half_function",
           "register_float_function", "register_promote_function",
           "register_banned_function", "half_function", "float_function",
           "promote_function"]


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


# -- weight-cast cache --------------------------------------------------------
_cast_cache: dict = {}


def clear_cast_cache() -> None:
    _cast_cache.clear()


def cached_cast(dtype: torch.dtype, x):
    """``x`` cast to ``dtype``; a parameter's cast (a leaf that requires
    grad) is cached until :func:`clear_cast_cache`, the tensor kept
    beside it so its ``id`` cannot be reused meanwhile."""
    if not _is_float(x) or x.dtype == dtype:
        return x
    if not (x.is_leaf and x.requires_grad):
        return x.to(dtype)
    key = (id(x), x._version, dtype, torch.is_grad_enabled())
    hit = _cast_cache.get(key)
    if hit is not None and hit[0] is x:
        return hit[1]
    out = x.to(dtype)
    _cast_cache[key] = (x, out)
    return out


def _cast_args(dtype, args, kwargs):
    def one(a):
        if _is_float(a):
            return cached_cast(dtype, a)
        if isinstance(a, (list, tuple)):
            return type(a)(cached_cast(dtype, x) if _is_float(x) else x
                           for x in a)
        return a
    return (tuple(one(a) for a in args),
            {k: one(v) for k, v in kwargs.items()})


def _float_dtypes(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        for x in (a if isinstance(a, (list, tuple)) else (a,)):
            if _is_float(x):
                yield x.dtype


def _run(kind: str, func: Callable, name: str, args, kwargs):
    """``func`` under the policy ``kind`` (the casts, then the call)."""
    if kind == "half":
        dtype = _amp_state.autocast_dtype or torch.bfloat16
    elif kind == "float":
        dtype = torch.float32
    elif kind == "promote":
        dtypes = list(_float_dtypes(args, kwargs))
        if not dtypes:
            return func(*args, **kwargs)
        dtype = functools.reduce(torch.promote_types, dtypes)
    else:                                   # banned
        if (_amp_state.autocast_dtype == torch.float16
                and not _amp_state.allow_banned):
            raise NotImplementedError(
                "amp does not work out-of-the-box with {} under float16 "
                "because it requires the full float range; use bfloat16, "
                "binary_cross_entropy_with_logits, or "
                "amp.init(allow_banned=True).".format(name))
        dtype = torch.float32
    if _amp_state.verbosity >= 2:
        maybe_print(f"amp: casting args of {name} to {dtype}")
    args, kwargs = _cast_args(dtype, args, kwargs)
    return func(*args, **kwargs)


# -- the lists ----------------------------------------------------------------

def _entries(pairs):
    return [getattr(mod, name) for mod, name in pairs if hasattr(mod, name)]


_T, _L, _S = torch, torch.linalg, torch.special

_HALF_LIST = _entries(
    [(F, "linear"), (F, "bilinear"), (F, "conv1d"), (F, "conv2d"),
     (F, "conv3d"), (F, "conv_transpose1d"), (F, "conv_transpose2d"),
     (F, "conv_transpose3d")]
    + [(_T, n) for n in ("matmul", "mm", "bmm", "addmm", "baddbmm",
                         "addbmm", "addmv", "addr", "mv", "dot", "vdot",
                         "einsum", "tensordot", "outer", "inner", "kron",
                         "chain_matmul")]
    + [(_L, "multi_dot"), (_L, "matmul")]
    + [(torch.Tensor, n) for n in ("matmul", "__matmul__", "__rmatmul__")])

_FP32_LIST = _entries(
    # transcendentals
    [(_T, n) for n in ("exp", "exp2", "expm1", "log", "log1p", "log2",
                       "log10", "logaddexp", "logaddexp2", "cosh", "sinh",
                       "tan", "acos", "asin", "acosh", "asinh", "atanh",
                       "arccos", "arcsin", "arccosh", "arcsinh", "arctanh",
                       "pow", "float_power", "reciprocal", "erf", "erfc",
                       "erfinv", "lgamma", "digamma", "rsqrt")]
    + [(_S, n) for n in ("erf", "erfc", "erfinv", "expm1", "exp2",
                         "log1p", "digamma", "gammaln")]
    # reductions
    + [(_T, n) for n in ("sum", "prod", "cumsum", "cumprod", "var", "std",
                         "mean", "median", "trapezoid", "nansum",
                         "nanmean")]
    # norms and solvers
    + [(_T, "norm")]
    + [(_L, n) for n in ("norm", "vector_norm", "matrix_norm", "cholesky",
                         "inv", "pinv", "svd", "eigh", "qr", "solve",
                         "lstsq", "det", "slogdet", "matrix_power",
                         "cond")]
    # the softmax family and the exp-based activations
    + [(F, n) for n in ("softmax", "log_softmax", "softplus", "softsign",
                        "sigmoid", "logsigmoid", "silu", "gelu", "celu",
                        "elu", "selu", "glu",
                        "binary_cross_entropy_with_logits")]
    + [(_T, n) for n in ("softmax", "log_softmax", "logsumexp", "sigmoid",
                         "celu", "selu")]
    + [(_S, n) for n in ("softmax", "log_softmax", "logsumexp", "expit")])

_PROMOTE_LIST = _entries(
    [(_T, n) for n in ("cat", "concat", "concatenate", "stack", "hstack",
                       "vstack", "dstack", "column_stack", "where",
                       "cross")]
    + [(_L, "cross")])

_BANNED_LIST = _entries([(F, "binary_cross_entropy")])


def _port_losses():
    """The port's own losses (``ops.losses``): its logit-space BCE on the
    fp32 list, its probability-space BCE banned; both are overridable
    Python functions, so the mode sees them."""
    from ..ops import losses
    return ([losses.binary_cross_entropy_with_logits],
            [losses.binary_cross_entropy])


#: function -> "half" | "float" | "promote" | "banned"
_POLICY: dict = {}
_registered: list = []      # user entries: (func, kind before, patch)


def _build_policy():
    if _POLICY:
        return
    safe_bce, banned_bce = _port_losses()
    for kind, funcs in (("half", _HALF_LIST),
                        ("float", _FP32_LIST + safe_bce),
                        ("promote", _PROMOTE_LIST),
                        ("banned", _BANNED_LIST + banned_bce)):
        for f in funcs:
            _POLICY[f] = kind


class _O1Mode(TorchFunctionMode):
    """Casts the arguments of the listed functions while the policy is
    enabled; every other call passes through untouched."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _POLICY.get(func)
        if kind is None or not _amp_state.autocast_enabled:
            return func(*args, **kwargs)
        return _run(kind, func, getattr(func, "__name__", str(func)),
                    args, kwargs)


_mode: Optional[_O1Mode] = None


def init(enabled: bool = True, verbose: bool = False,
         allow_banned: bool = False, half_dtype=torch.bfloat16) -> None:
    """Enable the O1 policy: push the mode (once) on this thread's
    torch-function mode stack (reference ``amp.py:68-177``)."""
    global _mode
    _amp_state.autocast_enabled = enabled
    _amp_state.autocast_dtype = half_dtype
    _amp_state.allow_banned = allow_banned
    if verbose:
        _amp_state.verbosity = 2
    _build_policy()
    if _mode is None:
        _mode = _O1Mode()
        _mode.__enter__()


def shutdown() -> None:
    """Undo ``init``: pop the mode, drop the user registrations (putting
    patched Python functions back) and the cast cache."""
    global _mode
    _amp_state.autocast_enabled = False
    if _mode is not None:
        stack = torch.overrides._get_current_function_mode_stack()
        if not stack or stack[-1] is not _mode:
            raise RuntimeError(
                "amp.shutdown: another TorchFunctionMode was pushed after "
                "amp.init() and is still active; leave it first")
        _mode.__exit__(None, None, None)
        _mode = None
    while _registered:
        func, before, patch = _registered.pop()
        if before is None:
            _POLICY.pop(func, None)
        else:
            _POLICY[func] = before
        if patch is not None:
            module, name, orig = patch
            setattr(module, name, orig)
    clear_cast_cache()


class disable_casts:
    """Switch the O1 casts off inside a block (reference
    ``handle.py:160-164``)."""

    def __enter__(self):
        self._saved = _amp_state.autocast_enabled
        _amp_state.autocast_enabled = False
        return self

    def __exit__(self, *exc):
        _amp_state.autocast_enabled = self._saved
        return False


# -- registries and decorators ------------------------------------------------

_OVERRIDABLE: set = set()


def _is_torch_function(fn) -> bool:
    """True if torch routes calls of ``fn`` through ``__torch_function__``
    (so the mode sees them without a wrapper)."""
    if not _OVERRIDABLE:
        _OVERRIDABLE.update(f for fs in torch.overrides
                            .get_overridable_functions().values()
                            for f in fs)
    try:
        return fn in _OVERRIDABLE
    except TypeError:                    # unhashable
        return False


def _tensors(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        for x in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(x, torch.Tensor):
                yield x


def overridable(fn: Callable) -> Callable:
    """``fn`` made visible to torch-function modes (the pattern of
    torch's own Python functions), so the O1 mode can cast its
    arguments when it is on a list."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        tensors = tuple(_tensors(args, kwargs))
        if tensors and torch.overrides.has_torch_function(tensors):
            return torch.overrides.handle_torch_function(
                wrapper, tensors, *args, **kwargs)
        return fn(*args, **kwargs)
    wrapper.__amp_original__ = fn
    return wrapper


def _register(module, name, kind):
    _build_policy()
    orig = getattr(module, name)
    if _is_torch_function(orig):
        _registered.append((orig, _POLICY.get(orig), None))
        _POLICY[orig] = kind
        return
    wrapper = overridable(orig)
    setattr(module, name, wrapper)
    _POLICY[wrapper] = kind
    _registered.append((wrapper, None, (module, name, orig)))


def register_half_function(module, name) -> None:
    """Run ``module.name`` in the half dtype under the policy (reference
    ``amp.py:46-51``)."""
    _register(module, name, "half")


def register_float_function(module, name) -> None:
    _register(module, name, "float")


def register_promote_function(module, name) -> None:
    _register(module, name, "promote")


def register_banned_function(module, name) -> None:
    _register(module, name, "banned")


def _decorate(fn, kind):
    _build_policy()
    wrapper = overridable(fn)
    _POLICY[wrapper] = kind
    return wrapper


def half_function(fn: Callable) -> Callable:
    """Decorator: ``fn``'s floating arguments in the half dtype under the
    policy (reference ``amp.py:30-42``)."""
    return _decorate(fn, "half")


def float_function(fn: Callable) -> Callable:
    return _decorate(fn, "float")


def promote_function(fn: Callable) -> Callable:
    return _decorate(fn, "promote")
