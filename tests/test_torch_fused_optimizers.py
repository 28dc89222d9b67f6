"""The port's fused optimizer classes through ``amp.initialize`` +
``amp.scale_loss`` + ``step`` against the JAX package's imperative loop
on the same weights, mirroring ``tests/test_amp_train.py`` and
``tests/test_bf16_utils.py``.

Every class (``FusedAdam``, ``FusedLAMB``, ``FusedNovoGrad``,
``FusedSGD``) at O0 and O2, leafwise and bucketed, four steps with a
dynamic scale and an inf gradient at step 2 (skipped in both packages):
O0 within rtol 5e-5 / atol 5e-6 of JAX's parameters (fp32 end to end;
LAMB's and NovoGrad's norms add in another order, JAX's own tolerance
for them); O2: each fp32 master's change from its start within 3% of
the largest change of that leaf in JAX (the bf16 forward and backward of
the two packages round differently; an update of half the size misses
by half of it; Adam, LAMB and NovoGrad do not see a wrong unscale,
FusedSGD does).  Port-only: the skipped step leaves masters and
state bit-identical and halves the scale; bucketed Adam equals leafwise
bit for bit; ``delay_unscale`` accumulation; three losses and scalers;
``FusedSGD(materialize_master_grads=False)`` with a deferred overflow;
the ``LARC`` class against JAX's; ``FP16_Optimizer`` (both flavors) and
the ``bf16_utils`` helpers; the transforms against JAX's; a JAX
optimizer's state (masters, moments, step, bucketed ``Packed``)
continued in the port.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import bf16_utils as jbf16
from apex_tpu import optimizers as joptim
from apex_tpu.parallel.LARC import LARC as JLARC
from apex_tpu_torch import amp, bf16_utils, convert, fp16_utils, optimizers
from apex_tpu_torch.multi_tensor.buckets import Packed
from apex_tpu_torch.parallel import LARC

TOL_O0 = dict(rtol=5e-5, atol=5e-6)
O2_CHANGE = 3e-2


@pytest.fixture(autouse=True)
def _clean_amp():
    yield
    amp.initialize(enabled=False, verbosity=0)
    jamp.initialize(enabled=False, verbosity=0)


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(8, 16).astype(np.float32) * 0.3,
            "b1": rng.randn(16).astype(np.float32) * 0.1,
            "ln.scale": 1.0 + rng.randn(16).astype(np.float32) * 0.1,
            "w2": rng.randn(16, 4).astype(np.float32) * 0.3,
            "b2": np.zeros(4, np.float32)}


class MLP(nn.Module):
    """``tanh(x @ w1 + b1) * ln.scale @ w2 + b2`` with flax-style names;
    ``ln.scale`` is a norm parameter (fp32 at O2)."""

    def __init__(self, weights):
        super().__init__()
        for k in ("w1", "b1", "w2", "b2"):
            setattr(self, k, nn.Parameter(torch.from_numpy(weights[k])))
        self.ln = nn.Module()
        self.ln.scale = nn.Parameter(torch.from_numpy(weights["ln.scale"]))

    def forward(self, x):
        h = torch.tanh(x @ self.w1 + self.b1) * self.ln.scale
        return h.to(self.w2.dtype) @ self.w2 + self.b2


def _jtree(weights):
    return {"w1": jnp.asarray(weights["w1"]), "b1": jnp.asarray(weights["b1"]),
            "ln": {"scale": jnp.asarray(weights["ln.scale"])},
            "w2": jnp.asarray(weights["w2"]), "b2": jnp.asarray(weights["b2"])}


def _jloss(params, x, y):
    """The JAX loss computing what :class:`MLP` computes under the
    port's ``wrap_forward`` (inputs in the model's dtype, output fp32)."""
    dt = params["w1"].dtype
    x = x.astype(dt)
    h = jnp.tanh(x @ params["w1"] + params["b1"]) * params["ln"]["scale"]
    out = h.astype(dt) @ params["w2"] + params["b2"]
    return jnp.mean((out.astype(jnp.float32) - y) ** 2)


def _batches(n, seed=42):
    rng = np.random.RandomState(seed)
    return [(rng.randn(32, 8).astype(np.float32),
             rng.randn(32, 4).astype(np.float32)) for _ in range(n)]


def _o2_start(weights):
    """The fp32 masters ``initialize`` makes at O2: the weights rounded
    to bf16, the norms' kept."""
    return {k: (w if amp.default_norm_predicate(k) else torch.from_numpy(
        w).to(torch.bfloat16).float().numpy()) for k, w in weights.items()}


def _assert_o2_changes(got, want, start):
    """Each master's change from ``start`` within ``O2_CHANGE`` of the
    largest change of that leaf in JAX."""
    for k in start:
        moved = got[k].detach().numpy() - start[k]
        jmoved = np.asarray(want[k], np.float32) - start[k]
        np.testing.assert_allclose(moved, jmoved, rtol=0, err_msg=k,
                                   atol=O2_CHANGE * np.abs(jmoved).max())


def _flat(tree):
    return {"w1": tree["w1"], "b1": tree["b1"], "ln.scale": tree["ln"]["scale"],
            "w2": tree["w2"], "b2": tree["b2"]}


_CLASSES = [
    ("FusedAdam", dict(lr=1e-3)),
    ("FusedLAMB", dict(lr=1e-3)),
    ("FusedNovoGrad", dict(lr=1e-3)),
    ("FusedSGD", dict(lr=1e-2, momentum=0.9)),
]


def _run_port(cls, kw, level, bucketed, batches, bad=2):
    model = MLP(_weights())
    opt = getattr(optimizers, cls)(model.parameters(), bucketed=bucketed,
                                   **kw)
    model, opt = amp.initialize(model, opt, opt_level=level,
                                loss_scale="dynamic", verbosity=0)
    for i, (x, y) in enumerate(batches):
        out = model(torch.from_numpy(x))
        loss = torch.mean((out.float() - torch.from_numpy(y)) ** 2)
        if i == bad:
            loss = loss * float("inf")
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
    return model, opt


def _run_jax(cls, kw, level, bucketed, batches, bad=2):
    params = _jtree(_weights())
    opt = getattr(joptim, cls)(params, bucketed=bucketed, **kw)
    params, opt = jamp.initialize(params, opt, opt_level=level,
                                  loss_scale="dynamic", verbosity=0)
    for i, (x, y) in enumerate(batches):
        loss, grads = opt.value_and_grad(_jloss)(jnp.asarray(x),
                                                 jnp.asarray(y))
        if i == bad:
            grads = dict(grads, w1=grads["w1"].at[0, 0].set(jnp.inf))
        with jamp.scale_loss(loss, opt):
            opt.backward(grads)
        opt.step()
    return opt


@pytest.mark.parametrize("bucketed", [False, True], ids=["leafwise",
                                                         "bucketed"])
@pytest.mark.parametrize("level", ["O0", "O2"])
@pytest.mark.parametrize("cls,kw", _CLASSES, ids=[c for c, _ in _CLASSES])
def test_imperative_loop_tracks_jax(cls, kw, level, bucketed):
    batches = _batches(4)
    model, opt = _run_port(cls, kw, level, bucketed, batches)
    jopt = _run_jax(cls, kw, level, bucketed, batches)
    want = _flat(jopt.master_params if level == "O2" else jopt.params)
    got = (opt.master_tree() if level == "O2"
           else {k: v for k, v in model.named_parameters()})
    assert all(v.dtype == torch.float32 for v in got.values())
    if level == "O2":
        _assert_o2_changes(got, want, _o2_start(_weights()))
    for k in want if level == "O0" else ():
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k], np.float32),
                                   err_msg=k, **TOL_O0)
    assert amp.state_dict() == jamp.state_dict()
    if level == "O2":
        assert model.w1.dtype == torch.bfloat16
        assert model.ln.scale.dtype == torch.float32
        for k, v in model.named_parameters():      # model = master, cast
            assert torch.equal(v, got[k].to(v.dtype)), k


@pytest.mark.parametrize("bucketed", [False, True])
def test_skipped_step_leaves_masters_and_state_bit_identical(bucketed):
    batches = _batches(3)
    model, opt = _run_port("FusedAdam", dict(lr=1e-3), "O2", bucketed,
                           batches[:2], bad=None)
    before = {k: v.clone() for k, v in opt.master_tree().items()}
    state = jax.tree_util.tree_map(lambda t: t.clone(), opt._fstate[0])
    scale = amp._amp_state.loss_scalers[0].loss_scale()
    x, y = batches[2]
    loss = torch.mean((model(torch.from_numpy(x)).float()
                       - torch.from_numpy(y)) ** 2) * float("inf")
    with amp.scale_loss(loss, opt) as scaled:
        scaled.backward()
    opt.step()
    for k, v in opt.master_tree().items():
        assert torch.equal(v, before[k]), k
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(opt._fstate[0])):
        assert torch.equal(a, b)
    assert int(opt._fstate[0].step) == 2
    assert amp._amp_state.loss_scalers[0].loss_scale() == scale / 2


def test_bucketed_adam_equals_leafwise_bit_for_bit():
    batches = _batches(5)
    _, leaf = _run_port("FusedAdam", dict(lr=1e-3), "O2", False, batches)
    _, buck = _run_port("FusedAdam", dict(lr=1e-3), "O2", True, batches)
    assert isinstance(buck._masters[0], Packed)
    for k, v in leaf.master_tree().items():
        assert torch.equal(v, buck.master_tree()[k]), k
    store = buck.param_groups[0]["_store"]
    m = store.unpack(buck._fstate[0].exp_avg)
    for k, v in leaf._fstate[0].exp_avg.items():
        assert torch.equal(v, m[k]), k


def test_delay_unscale_accumulates_both_micro_batches():
    """Two micro-batches, the first under ``delay_unscale``, one step:
    SGD on the sum of both gradients (the reference's contract; the
    scaled gradients add in the model's dtype, here fp32 at O0)."""
    (x1, y1), (x2, y2) = _batches(2)
    model = MLP(_weights())
    opt = optimizers.FusedSGD(model.parameters(), lr=0.1)
    model, opt = amp.initialize(model, opt, opt_level="O0", loss_scale=128.0,
                                verbosity=0)
    for (x, y), delay in (((x1, y1), True), ((x2, y2), False)):
        loss = torch.mean((model(torch.from_numpy(x)).float()
                           - torch.from_numpy(y)) ** 2)
        with amp.scale_loss(loss, opt, delay_unscale=delay) as scaled:
            scaled.backward()
    opt.step()
    ref = _jtree(_weights())
    ga = jax.grad(_jloss)(ref, jnp.asarray(x1), jnp.asarray(y1))
    gb = jax.grad(_jloss)(ref, jnp.asarray(x2), jnp.asarray(y2))
    want = _flat(jax.tree_util.tree_map(lambda p, a, b: p - 0.1 * (a + b),
                                        ref, ga, gb))
    for k, v in model.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL_O0)


def test_three_losses_three_scalers():
    """Losses 0 and 1 into one optimizer (their unscaled gradients
    summed in fp32), loss 2 into another; an overflow on loss 1 halves
    only scaler 1 and skips only that optimizer's step."""
    batches = _batches(3)
    ma, mb = MLP(_weights(0)), MLP(_weights(1))
    oa = optimizers.FusedAdam(ma.parameters(), lr=1e-3)
    ob = optimizers.FusedAdam(mb.parameters(), lr=1e-3)
    [ma, mb], [oa, ob] = amp.initialize([ma, mb], [oa, ob], opt_level="O2",
                                        loss_scale="dynamic", num_losses=3,
                                        verbosity=0)

    def loss_of(m, b, mult=1.0):
        x, y = batches[b]
        return torch.mean((m(torch.from_numpy(x)).float()
                           - torch.from_numpy(y)) ** 2) * mult

    before_a = {k: v.clone() for k, v in oa.master_tree().items()}
    before_b = {k: v.clone() for k, v in ob.master_tree().items()}
    with amp.scale_loss(loss_of(ma, 0), oa, loss_id=0) as s:
        s.backward()
    with amp.scale_loss(loss_of(ma, 1, float("inf")), oa, loss_id=1) as s:
        s.backward()
    oa.step()
    with amp.scale_loss(loss_of(mb, 2), ob, loss_id=2) as s:
        s.backward()
    ob.step()
    sd = amp.state_dict()
    assert [sd[f"loss_scaler{i}"]["loss_scale"] for i in range(3)] == [
        2.0 ** 16, 2.0 ** 15, 2.0 ** 16]
    assert all(torch.equal(v, before_a[k])
               for k, v in oa.master_tree().items())
    assert not all(torch.equal(v, before_b[k])
                   for k, v in ob.master_tree().items())
    # the next clean D step sums both losses' unscaled gradients
    with amp.scale_loss(loss_of(ma, 0), oa, loss_id=0) as s:
        s.backward()
    g0 = {k: v.clone() for k, v in zip(oa.param_groups[0]["param_names"],
                                       oa._master_grads[0].values())}
    with amp.scale_loss(loss_of(ma, 1), oa, loss_id=1) as s:
        s.backward()
    total = oa._master_grads[0]
    ref = MLP(_weights(0))
    amp.initialize(ref, opt_level="O2", verbosity=0)
    for p, q in zip(ref.parameters(), ma.parameters()):
        p.data = q.data.clone()
    lo = loss_of(ref, 1)
    lo.backward()
    for (k, p) in ref.named_parameters():
        np.testing.assert_array_equal(
            total[k].numpy(), (g0[k] + p.grad.float()).numpy(), err_msg=k)
    oa.step()


def test_fused_sgd_without_master_grads_matches_and_skips():
    batches = _batches(4)
    results = []
    for mat in (True, False):
        model = MLP(_weights())
        opt = optimizers.FusedSGD(model.parameters(), lr=0.1, momentum=0.9,
                                  materialize_master_grads=mat)
        model, opt = amp.initialize(model, opt, opt_level="O2",
                                    loss_scale="dynamic", verbosity=0)
        for i, (x, y) in enumerate(batches):
            loss = torch.mean((model(torch.from_numpy(x)).float()
                               - torch.from_numpy(y)) ** 2)
            if i == 2:
                loss = loss * float("inf")        # a deferred overflow
                before = {k: v.clone() for k, v in opt.master_tree().items()}
            with amp.scale_loss(loss, opt) as scaled:
                scaled.backward()
            opt.step()
            if i == 2:
                for k, v in opt.master_tree().items():
                    assert torch.equal(v, before[k]), k
        results.append(opt.master_tree())
        amp.initialize(enabled=False, verbosity=0)
    for k in results[0]:
        # 1/scale and /scale round alike for a power-of-two scale
        assert torch.equal(results[0][k], results[1][k]), k


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_larc_class_like_jax(level):
    batches = _batches(3)
    model = MLP(_weights())
    opt = optimizers.FusedSGD(model.parameters(), lr=0.1, momentum=0.9,
                              weight_decay=1e-3)
    model, opt = amp.initialize(model, opt, opt_level=level, verbosity=0)
    larc = LARC(opt, trust_coefficient=0.02)
    params = _jtree(_weights())
    jopt = joptim.FusedSGD(params, lr=0.1, momentum=0.9, weight_decay=1e-3)
    params, jopt = jamp.initialize(params, jopt, opt_level=level,
                                   verbosity=0)
    jlarc = JLARC(jopt, trust_coefficient=0.02)
    for x, y in batches:
        loss = torch.mean((model(torch.from_numpy(x)).float()
                           - torch.from_numpy(y)) ** 2)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        larc.step()
        jloss, grads = jopt.value_and_grad(_jloss)(jnp.asarray(x),
                                                   jnp.asarray(y))
        with jamp.scale_loss(jloss, jopt):
            jopt.backward(grads)
        jlarc.step()
    assert opt.param_groups[0]["weight_decay"] == 1e-3      # restored
    if level == "O2":
        _assert_o2_changes(opt.master_tree(), _flat(jopt.master_params),
                           _o2_start(_weights()))
        return
    got = dict(model.named_parameters())
    for k, v in _flat(jopt.params).items():
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(v, np.float32), err_msg=k,
                                   **TOL_O0)


@pytest.mark.parametrize("bucketed", [False, True], ids=["leafwise",
                                                         "bucketed"])
def test_jax_optimizer_state_continues_in_the_port(bucketed):
    """Two JAX steps, the state through ``convert``, two more steps in
    each package: the port's masters track JAX's."""
    batches = _batches(4)
    params = _jtree(_weights())
    jopt = joptim.FusedAdam(params, lr=1e-3, bucketed=bucketed)
    params, jopt = jamp.initialize(params, jopt, opt_level="O2", verbosity=0)

    def jstep(x, y):
        loss, grads = jopt.value_and_grad(_jloss)(jnp.asarray(x),
                                                  jnp.asarray(y))
        with jamp.scale_loss(loss, jopt):
            jopt.backward(grads)
        jopt.step()
    for x, y in batches[:2]:
        jstep(x, y)
    sd = convert.fused_optimizer_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jopt.state_dict()))
    model = MLP(_weights(7))                 # other weights: all replaced
    opt = optimizers.FusedAdam(model.named_parameters(), lr=1e-3,
                               bucketed=bucketed)
    model, opt = amp.initialize(model, opt, opt_level="O2", verbosity=0)
    opt.load_state_dict(sd)
    assert int(opt._fstate[0].step) == 2
    assert isinstance(opt._fstate[0].exp_avg, Packed) == bucketed
    start = {k: np.asarray(v, np.float32)
             for k, v in _flat(jopt.master_params).items()}
    for k, v in start.items():
        np.testing.assert_array_equal(opt.master_tree()[k].numpy(), v,
                                      err_msg=k)
        assert torch.equal(dict(model.named_parameters())[k],
                           opt.master_tree()[k].to(torch.bfloat16)
                           if k != "ln.scale" else opt.master_tree()[k])
    for x, y in batches[2:]:
        jstep(x, y)
        loss = torch.mean((model(torch.from_numpy(x)).float()
                           - torch.from_numpy(y)) ** 2)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
    _assert_o2_changes(opt.master_tree(), _flat(jopt.master_params), start)


def test_state_dict_round_trips_between_leafwise_and_bucketed():
    batches = _batches(3)
    _, src = _run_port("FusedAdam", dict(lr=1e-3), "O2", True, batches,
                       bad=None)
    sd = src.state_dict()
    model = MLP(_weights(3))
    opt = optimizers.FusedAdam(model.parameters(), lr=1e-3, bucketed=True)
    amp.initialize(model, opt, opt_level="O2", verbosity=0)
    opt.load_state_dict(sd)
    for k, v in src.master_tree().items():
        assert torch.equal(opt.master_tree()[k], v), k
    assert torch.equal(opt._fstate[0].exp_avg.data[0],
                       src._fstate[0].exp_avg.data[0])
    assert model.w1.dtype == torch.bfloat16
    assert torch.equal(model.w1, src.master_tree()["w1"].to(torch.bfloat16))


# -- FP16_Optimizer and bf16_utils ----------------------------------------------------

@pytest.mark.parametrize("flavor", ["fused", "general"])
def test_fp16_optimizer_steps_and_skips(flavor):
    model = bf16_utils.convert_network(MLP(_weights()), torch.bfloat16)
    inner = optimizers.FusedAdam(model.parameters(), lr=1e-3)
    cls = (optimizers.FP16_Optimizer if flavor == "fused"
           else bf16_utils.FP16_Optimizer)
    opt = cls(inner, dynamic_loss_scale=True, verbose=False)
    masters = list(inner.param_groups[0]["params"])
    assert all(m.dtype == torch.float32 for m in masters)
    (x, y), = _batches(1)
    scale0 = opt.loss_scale
    loss = torch.mean((model(torch.from_numpy(x).to(torch.bfloat16))
                       .float() - torch.from_numpy(y)) ** 2)
    opt.backward(loss * float("inf"))
    before = [m.clone() for m in masters]
    opt.step()
    assert opt.overflow
    assert all(torch.equal(a, b) for a, b in zip(before, masters))
    assert opt.loss_scale == scale0 / 2
    opt.zero_grad()
    loss = torch.mean((model(torch.from_numpy(x).to(torch.bfloat16))
                       .float() - torch.from_numpy(y)) ** 2)
    opt.backward(loss)
    norm = opt.clip_master_grads(1e9)
    assert norm > 0
    opt.step()
    assert not opt.overflow
    assert not all(torch.equal(a, b) for a, b in zip(before, masters))
    assert torch.equal(model.w1, masters[0].to(torch.bfloat16))
    sd = opt.state_dict()
    opt.load_state_dict(sd)


def test_bf16_utils_like_jax():
    assert fp16_utils.FP16_Optimizer is bf16_utils.FP16_Optimizer
    w = {k: torch.from_numpy(v) for k, v in _weights().items()}
    jw = _jtree(_weights())
    got = bf16_utils.convert_network(w, torch.bfloat16)
    want = _flat(jbf16.convert_network(jw, jnp.bfloat16))
    assert {k: str(v.dtype) for k, v in got.items()} == {
        k: "torch." + jnp.dtype(v.dtype).name for k, v in want.items()}
    back = bf16_utils.BN_convert_float(bf16_utils.convert_module(
        w, torch.bfloat16))
    assert back["ln.scale"].dtype == torch.float32
    assert back["w1"].dtype == torch.bfloat16
    model = MLP(_weights())
    half = bf16_utils.BF16Model(model)
    assert half(torch.ones(2, 8)).dtype == torch.bfloat16
    model_params, masters = bf16_utils.prep_param_lists(half)
    _, flat = bf16_utils.prep_param_lists(half, flat_master=True)
    assert flat[0].numel() == sum(p.numel() for p in model_params)
    half(torch.ones(2, 8)).float().sum().backward()
    bf16_utils.model_grads_to_master_grads(model_params, masters)
    assert all(m.grad.dtype == torch.float32 for m in masters)
    with torch.no_grad():
        for m in masters:
            m.add_(1.0)
    bf16_utils.master_params_to_model_params(model_params, masters)
    assert torch.equal(model_params[0], masters[0].to(torch.bfloat16))
    g = {k: torch.from_numpy(v) * 10 for k, v in _weights().items()}
    clipped, total = bf16_utils.clip_grad_norm(g, 1.0)
    jclipped, jtotal = jbf16.clip_grad_norm(_jtree(_weights()), 1.0)
    np.testing.assert_allclose(float(total), float(jtotal) * 10, rtol=1e-5)
    np.testing.assert_allclose(clipped["w1"].numpy(),
                               np.asarray(jclipped["w1"]), rtol=1e-4)
    scaler = bf16_utils.DynamicLossScaler(init_scale=8.0, scale_window=2)
    jscaler = jbf16.DynamicLossScaler(init_scale=8.0, scale_window=2)
    for ovf in (False, True, False, False, True):
        scaler.update_scale(ovf)
        jscaler.update_scale(ovf)
        assert scaler.loss_scale == jscaler.loss_scale
    assert scaler.has_overflow({"a": torch.tensor([float("nan")])})
    assert not scaler.has_overflow({"a": torch.ones(2)})


@pytest.mark.parametrize("name", ["fused_adam", "fused_lamb",
                                  "fused_novograd", "fused_sgd"])
def test_transforms_like_jax(name):
    kw = dict(momentum=0.9) if name == "fused_sgd" else {}
    tx = getattr(optimizers, name)(lr=1e-2, **kw)
    jtx = getattr(joptim, name)(lr=1e-2, **kw)
    w = {k: torch.from_numpy(v) for k, v in _weights().items()}
    jw = _flat(_jtree(_weights()))
    st, jst = tx.init(w), jtx.init(jw)
    rng = np.random.RandomState(5)
    for _ in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in _weights().items()}
        upd, st = tx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            st, w)
        jupd, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jw)
        w = {k: w[k] + upd[k] for k in w}
        jw = {k: jw[k] + jupd[k] for k in jw}
    for k in w:
        np.testing.assert_allclose(w[k].numpy(), np.asarray(jw[k]),
                                   err_msg=k, **TOL_O0)
