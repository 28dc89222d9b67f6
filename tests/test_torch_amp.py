"""The port's imperative amp surface against the JAX package's, mirroring
``tests/test_amp_core.py``: the presets option for option (with
``cast_model_outputs``), the refusals, ``initialize`` at O0-O3 on a
module, ``wrap_forward``, the scaler's imperative API and ``state_dict``
(read across the two packages), the O1 lists op by op (output dtypes
equal to JAX's, values within one bf16 rounding: rtol 1e-2), the banned
BCE under fp16 and bf16, ``enabled=False`` leaving the mode stack empty,
the registries and decorators, the cast cache, and ``make_train_step``
at O1 (losses and parameters within rtol/atol 2e-2 of JAX's after three
bf16 steps).
"""

import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as TF
from torch import nn

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import training as jtraining
from apex_tpu.amp import autocast as jautocast
from apex_tpu.ops import losses as jlosses
from apex_tpu_torch import amp, ops, training
from apex_tpu_torch.amp import autocast
from apex_tpu_torch.optimizers import FP16_Optimizer, FusedAdam, FusedSGD


@pytest.fixture(autouse=True)
def _clean_amp():
    yield
    amp.shutdown()
    jautocast.shutdown()
    amp.initialize(enabled=False, verbosity=0)
    jamp.initialize(enabled=False, verbosity=0)


def _name(dtype):
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return jnp.dtype(dtype).name


# -- presets -------------------------------------------------------------------

@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "O4"])
def test_presets_match_jax_option_for_option(level):
    got = amp.opt_levels[level]().options
    want = jamp.opt_levels[level]().options
    assert set(got) == set(want)
    for k in want:
        if k in ("cast_model_type", "cast_model_outputs"):
            assert _name(got[k]) == _name(want[k]), k
        else:
            assert got[k] == want[k], k
    assert _name(amp.opt_levels[level]().half_dtype) == _name(
        jamp.opt_levels[level]().half_dtype)


@pytest.mark.parametrize("value", ["fp16", "bfloat16", "float32", None])
def test_cast_model_outputs_follows_jax(value):
    p, jp = amp.opt_levels["O2"](), jamp.opt_levels["O2"]()
    p.cast_model_outputs = value
    jp.cast_model_outputs = value
    assert _name(p.cast_model_outputs) == _name(jp.cast_model_outputs)
    with pytest.raises(amp.AmpOptionError):
        p.cast_model_outputs = "int3"
    with pytest.raises(jamp.AmpOptionError):
        jp.cast_model_outputs = "int3"


def _set(props, name, value):
    setattr(props, name, value)


@pytest.mark.parametrize("level,name,value", [
    ("O1", "cast_model_type", "bf16"),
    ("O2", "patch_functions", True),
    ("O2", "keep_batchnorm_fp32", "maybe"),
    ("O2", "loss_scale", -1.0),
    ("O2", "bogus_option", 3),
    ("O4", "patch_functions", True),
    ("O2", "quantize", "yes"),
])
def test_properties_refuse_what_jax_refuses(level, name, value):
    with pytest.raises(jamp.AmpOptionError):
        _set(jamp.opt_levels[level](), name, value)
    with pytest.raises(amp.AmpOptionError):
        _set(amp.opt_levels[level](), name, value)


# -- initialize on a module ------------------------------------------------------

class Net(nn.Module):
    """conv1 / bn1 / dense with flax-named parameters (the JAX tests'
    ``_params`` tree)."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.conv1 = nn.Module()
        self.conv1.kernel = nn.Parameter(torch.randn(3, 3, 4, 8,
                                                     generator=g))
        self.bn1 = nn.Module()
        self.bn1.scale = nn.Parameter(torch.ones(8))
        self.bn1.bias = nn.Parameter(torch.zeros(8))
        self.dense = nn.Module()
        self.dense.kernel = nn.Parameter(torch.randn(8, 2, generator=g))
        self.dense.bias = nn.Parameter(torch.zeros(2))

    def forward(self, x):
        y = TF.conv2d(x.permute(0, 3, 1, 2),
                      self.conv1.kernel.to(x.dtype).permute(3, 2, 0, 1),
                      padding=1).permute(0, 2, 3, 1)
        y = y * self.bn1.scale.to(y.dtype) + self.bn1.bias.to(y.dtype)
        return y.mean((1, 2)) @ self.dense.kernel + self.dense.bias


def _jax_tree(model):
    tree = {}
    for name, p in model.named_parameters():
        mod, leaf = name.split(".")
        tree.setdefault(mod, {})[leaf] = jnp.asarray(p.detach().numpy())
    return tree


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_initialize_levels_cast_like_jax(level):
    model = Net()
    want = jamp.initialize(_jax_tree(model), opt_level=level, verbosity=0)
    got = amp.initialize(model, opt_level=level, verbosity=0)
    assert got is model
    for name, p in model.named_parameters():
        mod, leaf = name.split(".")
        assert _name(p.dtype) == _name(want[mod][leaf].dtype), name
    out = model(torch.randn(2, 5, 5, 4))
    assert out.dtype == torch.float32
    pushed = bool(torch.overrides._get_current_function_mode_stack())
    assert pushed == (level == "O1")


def test_initialize_o2_outputs_cast_model_outputs():
    model = amp.initialize(Net(), opt_level="O2", verbosity=0,
                           cast_model_outputs=torch.float16)
    assert model(torch.randn(2, 5, 5, 4)).dtype == torch.float16


def test_initialize_refusals():
    with pytest.raises(amp.AmpOptionError):
        amp.initialize(Net(), opt_level="O5", verbosity=0)
    with pytest.raises(amp.AmpOptionError):
        amp.initialize(Net(), opt_level="02", verbosity=0)
    half = Net().to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="expected float32"):
        amp.initialize(half, FusedSGD(half.parameters(), lr=0.1),
                       opt_level="O2", verbosity=0)
    assert amp.initialize(half, opt_level="O3",
                          verbosity=0).conv1.kernel.dtype == torch.bfloat16
    m = Net()
    with pytest.raises(RuntimeError, match="must be bare"):
        amp.initialize(m, FP16_Optimizer(FusedSGD(m.parameters(), lr=0.1)),
                       opt_level="O2", verbosity=0)
    opt = FusedSGD(m.parameters(), lr=0.1)
    amp.initialize(m, opt, opt_level="O0", verbosity=0)
    with pytest.raises(RuntimeError, match="twice"):
        amp.initialize(m, opt, opt_level="O0", verbosity=0)
    with pytest.raises(RuntimeError, match="AFTER"):
        amp.initialize(nn.DataParallel(Net()), opt_level="O2", verbosity=0)


def test_initialize_disabled_passes_through_and_empties_the_stack():
    amp.init()
    assert torch.overrides._get_current_function_mode_stack()
    m1, m2 = Net(), Net()
    o1, o2 = FusedSGD(m1.parameters(), lr=0.1), FusedSGD(m2.parameters(),
                                                        lr=0.1)
    models, opts = amp.initialize([m1, m2], [o1, o2], enabled=False,
                                  verbosity=0)
    assert models == [m1, m2] and opts == [o1, o2]
    assert torch.overrides._get_current_function_mode_stack() == []
    m, o = amp.initialize(m1, o1, enabled=False, verbosity=0)
    assert m is m1 and o is o1
    assert m1.conv1.kernel.dtype == torch.float32


def test_initialize_o2_wires_fp32_masters_per_loss():
    model = Net()
    opt = FusedAdam(model.parameters(), lr=1e-3)
    model, opt = amp.initialize(model, opt, opt_level="O2", num_losses=2,
                                verbosity=0)
    assert len(amp._amp_state.loss_scalers) == 2
    masters = list(amp.master_params(opt))
    assert all(m.dtype == torch.float32 for m in masters)
    assert [n for n in opt.param_groups[0]["param_names"]] == [
        n for n, _ in model.named_parameters()]
    assert model.conv1.kernel.dtype == torch.bfloat16
    assert model.bn1.scale.dtype == torch.float32


# -- wrap_forward, the policy helpers ------------------------------------------------

@pytest.mark.parametrize("out_type", [None, "float32", "bfloat16"])
def test_wrap_forward_like_jax(out_type):
    def f(x, ids, scale=None):
        return {"y": x * 2, "ids": ids, "s": scale}

    x = np.random.RandomState(0).randn(3).astype(np.float32)
    jout = jamp.wrap_forward(f, jnp.bfloat16, out_type and jnp.dtype(
        out_type))(jnp.asarray(x), jnp.arange(3), scale=jnp.ones(2))
    out = amp.wrap_forward(f, torch.bfloat16, out_type and getattr(
        torch, out_type))(torch.from_numpy(x), torch.arange(3),
                          scale=torch.ones(2))
    for k in ("y", "s"):
        assert _name(out[k].dtype) == _name(jout[k].dtype), k
    # integer tensors pass through in their own dtype in both packages
    assert out["ids"].dtype == torch.int64 and jout["ids"].dtype == jnp.int32
    np.testing.assert_array_equal(out["y"].float().numpy(),
                                  np.asarray(jout["y"], np.float32))


def test_make_master_and_master_to_model():
    params = {"w": torch.randn(3).to(torch.bfloat16), "n": torch.arange(3)}
    m = amp.make_master(params)
    assert m["w"].dtype == torch.float32 and m["n"].dtype == torch.int64
    back = amp.master_to_model(m, params)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], params["w"])


# -- the scaler's imperative API and state_dict --------------------------------------

def test_scaler_imperative_api_like_jax():
    s, js = amp.LossScaler("dynamic"), jamp.LossScaler("dynamic")
    g = {"a": np.ones(3, np.float32) * 2 ** 16, "b": np.ones(2, np.float32)}
    stash = {"a": np.ones(3, np.float32), "b": np.zeros(2, np.float32)}
    out, _ = s.unscale_with_stashed({k: torch.from_numpy(v)
                                     for k, v in g.items()},
                                    {k: torch.from_numpy(v)
                                     for k, v in stash.items()})
    jout, _ = js.unscale_with_stashed({k: jnp.asarray(v)
                                       for k, v in g.items()},
                                      {k: jnp.asarray(v)
                                       for k, v in stash.items()})
    for k in g:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    assert s.update_scale_deferred().item() is False
    bad = {"a": torch.tensor([float("inf")])}
    s.unscale(bad)
    js.unscale({"a": jnp.asarray([jnp.inf])})
    assert s.update_scale_sync() and js.update_scale_sync()
    assert s.loss_scale() == js.loss_scale() == 2.0 ** 15
    assert s.state_dict() == js.state_dict()
    s.clear_overflow_state()
    assert not bool(s.state.overflow)


def test_amp_state_dict_round_trips_across_packages():
    model = Net()
    amp.initialize(model, FusedSGD(model.parameters(), lr=0.1),
                   opt_level="O2", loss_scale="dynamic", num_losses=2,
                   verbosity=0)
    jamp.initialize({"w": jnp.ones(2)}, opt_level="O2",
                    loss_scale="dynamic", num_losses=2, verbosity=0)
    src = {"loss_scaler0": {"loss_scale": 512.0, "unskipped": 7},
           "loss_scaler1": {"loss_scale": 2.0 ** 20, "unskipped": 1999}}
    jamp.load_state_dict(src)
    amp.load_state_dict(jamp.state_dict())
    assert amp.state_dict() == src
    amp.load_state_dict({"loss_scaler0": {"loss_scale": 8.0,
                                          "unskipped": 3},
                         "loss_scaler1": {"loss_scale": 4.0,
                                          "unskipped": 0}})
    jamp.load_state_dict(amp.state_dict())
    assert jamp.state_dict() == amp.state_dict()


# -- the O1 lists, op by op --------------------------------------------------------

def _arr(shape, seed, dtype):
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32) + 0.5
    return torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(
        {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
         torch.float16: jnp.float16}[dtype])


def _late(path):
    """The JAX function at ``path`` looked up at call time: ``jamp.init``
    replaces the module attribute, not the function object."""
    mod, name = path.rsplit(".", 1)
    mod = {"jnp": jnp, "jnp.linalg": jnp.linalg, "jax.nn": jax.nn,
           "jax.lax": jax.lax}[mod]
    return lambda *a: getattr(mod, name)(*a)


_OPS = [
    # (name, port op, jax op, arity)
    ("matmul", torch.matmul, _late("jnp.matmul"), 2),
    ("@", lambda a, b: a @ b, lambda a, b: jnp.matmul(a, b), 2),
    ("einsum", lambda a, b: torch.einsum("ij,jk->ik", a, b),
     lambda a, b: jnp.einsum("ij,jk->ik", a, b), 2),
    ("linear", lambda a, b: TF.linear(a, b.T), lambda a, b: jnp.dot(a, b),
     2),
    ("tensordot", lambda a, b: torch.tensordot(a, b, 1),
     lambda a, b: jnp.tensordot(a, b, 1), 2),
    ("sum", torch.sum, _late("jnp.sum"), 1),
    ("mean", torch.mean, _late("jnp.mean"), 1),
    ("var", lambda a: torch.var(a, unbiased=False), _late("jnp.var"), 1),
    ("prod", torch.prod, _late("jnp.prod"), 1),
    ("cumsum", lambda a: torch.cumsum(a, 0), lambda a: jnp.cumsum(a, 0), 1),
    ("exp", torch.exp, _late("jnp.exp"), 1),
    ("log", torch.log, _late("jnp.log"), 1),
    ("log1p", torch.log1p, _late("jnp.log1p"), 1),
    ("pow", lambda a: torch.pow(a, 2.0), lambda a: jnp.power(a, 2.0), 1),
    ("rsqrt", torch.rsqrt, _late("jax.lax.rsqrt"), 1),
    ("norm", torch.linalg.norm, _late("jnp.linalg.norm"), 1),
    ("softmax", lambda a: TF.softmax(a, -1),
     lambda a: jax.nn.softmax(a, -1), 1),
    ("log_softmax", lambda a: TF.log_softmax(a, -1),
     lambda a: jax.nn.log_softmax(a, -1), 1),
    ("logsumexp", lambda a: torch.logsumexp(a, -1),
     lambda a: jax.nn.logsumexp(a, -1), 1),
    ("sigmoid", torch.sigmoid, _late("jax.nn.sigmoid"), 1),
    ("silu", TF.silu, _late("jax.nn.silu"), 1),
    ("gelu", lambda a: TF.gelu(a, approximate="tanh"),
     _late("jax.nn.gelu"), 1),
    ("softplus", TF.softplus, _late("jax.nn.softplus"), 1),
    ("cat", lambda a, b: torch.cat([a, b]),
     lambda a, b: jnp.concatenate([a, b]), 2),
    ("stack", lambda a, b: torch.stack([a, b]),
     lambda a, b: jnp.stack([a, b]), 2),
    ("where", lambda a, b: torch.where(a > 1, a, b),
     lambda a, b: jnp.where(a > 1, a, b), 2),
    ("tanh (no list)", torch.tanh, _late("jnp.tanh"), 1),
    ("relu (no list)", torch.relu, _late("jax.nn.relu"), 1),
]


@pytest.mark.parametrize("name,op,jop,arity", _OPS,
                         ids=[o[0] for o in _OPS])
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16)],
                         ids=["bf16", "fp32", "mixed"])
def test_o1_lists_give_jax_dtypes(name, op, jop, arity, dtypes):
    a, ja = _arr((4, 4), 0, dtypes[0])
    b, jb = _arr((4, 4), 1, dtypes[1])
    args, jargs = ((a, b), (ja, jb)) if arity == 2 else ((a,), (ja,))
    amp.init()
    jamp.init()
    got = op(*args)
    want = jop(*jargs)
    assert _name(got.dtype) == _name(want.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_o1_conv_runs_in_bf16_like_jax():
    x = np.random.RandomState(0).randn(2, 6, 6, 3).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 3, 3, 4).astype(np.float32)
    amp.init()
    jamp.init()
    y = TF.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(w).permute(3, 2, 0, 1), padding=1)
    jy = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert _name(y.dtype) == _name(jy.dtype) == "bfloat16"
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).float().numpy(),
                               np.asarray(jy, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_o1_casts_only_the_forward():
    w = torch.randn(4, 4, requires_grad=True)
    amp.init()
    y = torch.randn(2, 4) @ w
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32
    out = torch.func.functional_call(nn.Linear(4, 3), {}, (torch.ones(
        2, 4),))
    assert out.dtype == torch.bfloat16


# -- banned BCE ---------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["port", "torch"])
def test_banned_bce_raises_under_fp16_runs_in_fp32_under_bf16(fn):
    probs = torch.tensor([0.3, 0.7])
    targets = torch.tensor([0.0, 1.0])
    bce = (ops.binary_cross_entropy if fn == "port"
           else TF.binary_cross_entropy)
    jp, jt = jnp.asarray([0.3, 0.7]), jnp.asarray([0.0, 1.0])

    amp.init(half_dtype=torch.float16)
    jautocast.init(enabled=True, half_dtype=jnp.float16)
    with pytest.raises(NotImplementedError, match="float range"):
        bce(probs.half(), targets.half())
    with pytest.raises(NotImplementedError, match="float range"):
        jlosses.binary_cross_entropy(jp, jt)
    amp.shutdown()
    jautocast.shutdown()

    amp.init()
    jautocast.init(enabled=True)
    out = bce(probs.to(torch.bfloat16), targets.to(torch.bfloat16))
    jout = jlosses.binary_cross_entropy(jp.astype(jnp.bfloat16),
                                        jt.astype(jnp.bfloat16))
    assert out.dtype == torch.float32
    assert _name(jout.dtype) == "float32"
    np.testing.assert_allclose(float(out), float(jout), rtol=1e-5)


def test_safe_bce_runs_in_fp32_like_jax():
    x = np.random.RandomState(0).randn(8).astype(np.float32)
    t = (np.random.RandomState(1).rand(8) > 0.5).astype(np.float32)
    amp.init()
    jamp.init()
    out = ops.binary_cross_entropy_with_logits(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(t))
    jout = jlosses.binary_cross_entropy_with_logits(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(t))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(float(out), float(jout), rtol=1e-6)


# -- registries, decorators, disable_casts --------------------------------------------

def test_register_functions_and_restore():
    mod = types.ModuleType("user_ops")
    mod.scale = lambda x, s=2.0: x * s
    sys.modules["user_ops"] = mod
    try:
        amp.register_half_function(mod, "scale")
        amp.register_float_function(torch, "tanh")
        amp.init()
        x = torch.ones(3)
        assert mod.scale(x).dtype == torch.bfloat16
        assert torch.tanh(x.to(torch.bfloat16)).dtype == torch.float32
        with amp.disable_casts():
            assert mod.scale(x).dtype == torch.float32
        amp.shutdown()
        assert not hasattr(mod.scale, "__amp_original__")
        amp.init()
        assert torch.tanh(x.to(torch.bfloat16)).dtype == torch.bfloat16
    finally:
        del sys.modules["user_ops"]


def test_decorators_like_jax():
    half = amp.half_function(lambda a, b: a + b)
    flt = amp.float_function(lambda a: a * 1)
    prom = amp.promote_function(lambda a, b: a * b)
    jhalf = jautocast.half_function(lambda a, b: a + b)
    jflt = jautocast.float_function(lambda a: a * 1)
    jprom = jautocast.promote_function(lambda a, b: a * b)
    a, ja = _arr((3,), 0, torch.float32)
    b, jb = _arr((3,), 1, torch.bfloat16)
    amp.init()
    jamp.init()
    for got, want in ((half(a, a), jhalf(ja, ja)), (flt(b), jflt(jb)),
                      (prom(a, b), jprom(ja, jb))):
        assert _name(got.dtype) == _name(want.dtype)
    amp.shutdown()
    assert half(a, a).dtype == torch.float32      # off: no casts


def test_register_banned_and_promote():
    amp.register_banned_function(torch, "erfinv")
    amp.register_promote_function(torch, "maximum")
    amp.init(half_dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        torch.erfinv(torch.zeros(2))
    out = torch.maximum(torch.ones(2, dtype=torch.bfloat16), torch.ones(2))
    assert out.dtype == torch.float32
    amp.shutdown()          # erfinv back on the fp32 list, maximum off
    amp.init()
    half = torch.zeros(2, dtype=torch.bfloat16)
    assert torch.erfinv(half).dtype == torch.float32
    assert torch.maximum(half, torch.ones(2)).dtype == torch.float32
    assert torch.maximum(half, half).dtype == torch.bfloat16


# -- the cast cache -------------------------------------------------------------------

def test_cast_cache_keys_on_identity_and_version():
    autocast.clear_cast_cache()
    w = nn.Parameter(torch.ones(3))
    a = autocast.cached_cast(torch.bfloat16, w)
    assert autocast.cached_cast(torch.bfloat16, w) is a
    with torch.no_grad():
        w.add_(1.0)                     # a new version: a new cast
    b = autocast.cached_cast(torch.bfloat16, w)
    assert b is not a and float(b[0]) == 2.0
    x = torch.ones(3) * 2               # not a parameter: never cached
    assert autocast.cached_cast(torch.bfloat16, x) is not \
        autocast.cached_cast(torch.bfloat16, x)
    assert all(v[0] is w for v in autocast._cast_cache.values())
    with torch.no_grad():               # the grad mode is in the key
        c = autocast.cached_cast(torch.bfloat16, w)
    assert c is not b and not c.requires_grad and b.requires_grad
    autocast.clear_cast_cache()
    assert not autocast._cast_cache


def test_scale_loss_clears_the_cast_cache():
    model = nn.Linear(4, 2)
    opt = FusedSGD(model.parameters(), lr=0.1)
    model, opt = amp.initialize(model, opt, opt_level="O1", verbosity=0)
    loss = model(torch.ones(3, 4)).float().sum()
    assert autocast._cast_cache
    with amp.scale_loss(loss, opt) as scaled:
        scaled.backward()
    assert not autocast._cast_cache
    opt.step()


# -- make_train_step under the O1 policy ------------------------------------------------

def test_make_train_step_o1_traces_under_the_policy():
    rng = np.random.RandomState(0)
    params = {"w1": rng.randn(8, 16).astype(np.float32) * 0.3,
              "w2": rng.randn(16, 4).astype(np.float32) * 0.3}
    xs = rng.randn(3, 32, 8).astype(np.float32)
    ys = rng.randn(3, 32, 4).astype(np.float32)

    def loss_fn(p, batch):
        x, y = batch
        h = torch.tanh(torch.matmul(x, p["w1"]))
        return torch.mean((torch.matmul(h, p["w2"]).float() - y) ** 2)

    def jloss_fn(p, batch):
        x, y = batch
        h = jnp.tanh(jnp.matmul(x, p["w1"]))
        return jnp.mean((jnp.matmul(h, p["w2"]).astype(jnp.float32)
                         - y) ** 2)

    amp.init()
    jamp.init()
    init, step = training.make_train_step(loss_fn, training.adam(1e-2),
                                          opt_level="O1")
    jinit, jstep = jtraining.make_train_step(jloss_fn, jtraining.adam(1e-2),
                                             opt_level="O1")
    st = init({k: torch.from_numpy(v) for k, v in params.items()})
    jst = jinit({k: jnp.asarray(v) for k, v in params.items()})
    for i in range(3):
        st, m = step(st, (torch.from_numpy(xs[i]), torch.from_numpy(ys[i])))
        jst, jm = jax.jit(jstep)(jst, (jnp.asarray(xs[i]),
                                       jnp.asarray(ys[i])))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=2e-2)
    assert not autocast._cast_cache          # cleared after each step
    for k in params:
        assert st.params[k].dtype == torch.float32
        np.testing.assert_allclose(st.params[k].numpy(),
                                   np.asarray(jst.params[k]), rtol=2e-2,
                                   atol=2e-2)


# -- the legacy handle API -----------------------------------------------------------

def test_legacy_handle_and_optim_wrapper():
    """``AmpHandle.wrap_optimizer`` over two losses: an overflow on one
    skips the step (one host read a loss, as the reference); the no-op
    handle passes everything through."""
    model = nn.Linear(4, 2)
    opt = FusedSGD(model.parameters(), lr=0.1)
    handle = amp.AmpHandle()
    wrapped = handle.wrap_optimizer(opt, num_loss=2)
    before = [p.clone() for p in model.parameters()]
    x = torch.ones(3, 4)
    for mult in (1.0, float("inf")):
        with wrapped.scale_loss(model(x).sum() * mult) as scaled:
            scaled.backward()
    wrapped.step()
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 model.parameters()))
    for _ in range(2):
        with wrapped.scale_loss(model(x).sum()) as scaled:
            scaled.backward()
    wrapped.step()
    assert not all(torch.equal(a, b) for a, b in zip(before,
                                                     model.parameters()))
    with pytest.raises(NotImplementedError):
        wrapped.loss_scale
    noop = amp.NoOpHandle()
    assert noop.wrap_optimizer(opt) is opt and noop.loss_scale == 1.0
    loss = model(x).sum()
    with noop.scale_loss(loss, opt) as scaled:
        assert scaled is loss


def test_legacy_handle_scale_loss_skips_on_the_device():
    """``AmpHandle.scale_loss`` hands its scaler's overflow flag to the
    optimizer's device skip mask, as ``amp.scale_loss`` does: an inf loss
    leaves the parameters bit-identical and halves the scale, and the next
    finite loss updates them."""
    model = nn.Linear(4, 2)
    opt = FusedSGD(model.parameters(), lr=0.1)
    handle = amp.AmpHandle()
    scale0 = handle.loss_scale
    before = [p.detach().clone() for p in model.parameters()]
    x = torch.ones(3, 4)
    with handle.scale_loss(model(x).sum() * float("inf"), opt) as scaled:
        scaled.backward()
    assert len(opt._pending) == 1
    opt.step()
    opt.zero_grad()
    assert not opt._pending
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 model.parameters()))
    assert handle.loss_scale == scale0 / 2
    with handle.scale_loss(model(x).sum(), opt) as scaled:
        scaled.backward()
    opt.step()
    w_grad = torch.ones(2, 4) * 3.0           # d sum(W x + b) / dW, x = 1
    torch.testing.assert_close(model.weight.detach(),
                               before[0] - 0.1 * w_grad, rtol=0, atol=1e-6)
    torch.testing.assert_close(model.bias.detach(),
                               before[1] - 0.1 * 3.0, rtol=0, atol=1e-6)