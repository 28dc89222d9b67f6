"""The port's training stack against the JAX package's.

Same numpy inputs and the same weights through the JAX functions and
the port's: ``multi_tensor`` sweeps, the functional Adam and SGD, the
dynamic loss scaler's state machine, the O2 parameter cast, and
``make_train_step`` on gpt_tiny with the LM example's losses (both
``--no-fused-loss`` and the fused default) for three steps (O0 at 1e-5,
O2 at 2e-2: bf16 activations), plus a run continued in the port from a
JAX ``TrainState``.  The ImageNet step: ``make_train_step(
has_model_state=True)`` on a small ResNet (BN statistics as the model
state, SGD, the fused loss) for three steps at O0 (losses rtol 1e-4,
parameters and statistics atol 1e-4), with ``accum_steps=2``, and at O2
(losses 2e-2); a skipped O2 step; a JAX SGD ``TrainState`` continued in
the port; ``synthetic_imagenet``'s bytes; and both trainers' CLIs.  The
CPU runs the kernels' plain versions; the card runs them in
``chip_smoke.py``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import data as jdata
from apex_tpu import multi_tensor as jmta
from apex_tpu import training as jtraining
from apex_tpu.amp import policy as jpolicy
from apex_tpu.amp.loss_scaler import LossScaler as JLossScaler
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JBatchNorm2d_NHWC
from apex_tpu.contrib.xentropy import \
    softmax_cross_entropy_loss as jax_xentropy
from apex_tpu.models import gpt_tiny as jgpt_tiny
from apex_tpu.models import resnet as jresnet
from apex_tpu.ops import PallasConv as JPallasConv
from apex_tpu.optimizers import functional as jF
from apex_tpu_torch import data
from apex_tpu_torch import multi_tensor as mta
from apex_tpu_torch import training
from apex_tpu_torch.amp import (AmpOptionError, LossScaler, convert_params,
                                opt_levels)
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.convert import (gpt_params_from_jax,
                                    resnet_variables_to_jax,
                                    train_state_from_jax)
from apex_tpu_torch.examples.imagenet import main_amp as imagenet_main
from apex_tpu_torch.examples.lm import main_amp
from apex_tpu_torch.models import BasicBlock, ResNet, gpt_tiny
from apex_tpu_torch.ops import PallasConv
from apex_tpu_torch.optimizers import (adam_init, adam_update, sgd_init,
                                       sgd_update)

CFG = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
           mlp_dim=128, max_len=32)
RESNET_SMALL = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=10)


def _tree(seed, shapes=((3, 5), (7,), (2, 2, 4))):
    rng = np.random.RandomState(seed)
    return {f"p{i}": rng.randn(*s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, tol):
    for k in want:
        np.testing.assert_allclose(
            got[k].detach().float().numpy(),
            np.asarray(want[k], np.float32), atol=tol, rtol=tol, err_msg=k)


# -- multi_tensor ------------------------------------------------------------

@pytest.mark.parametrize("poison", [None, np.inf, np.nan])
def test_multi_tensor_scale_axpby_and_finite(poison):
    x, y = _tree(0), _tree(1)
    if poison is not None:
        x["p1"][3] = poison
    out, flag = mta.multi_tensor_scale(_t(x), 0.25)
    jout, jflag = jmta.multi_tensor_scale(_j(x), 0.25)
    _close(out, jout, 0)
    assert bool(flag) == bool(jflag) == (poison is not None)
    out, flag = mta.multi_tensor_axpby(_t(x), _t(y), 0.5, -2.0)
    jout, jflag = jmta.multi_tensor_axpby(_j(x), _j(y), 0.5, -2.0)
    _close(out, jout, 1e-6)
    assert bool(flag) == bool(jflag)
    assert bool(mta.tree_finite(_t(x))) == bool(jmta.tree_finite(_j(x)))


def test_multi_tensor_l2norm_and_list_trees():
    x = _tree(2)
    total, per = mta.multi_tensor_l2norm(list(_t(x).values()),
                                         per_tensor=True)
    jtotal, jper = jmta.multi_tensor_l2norm(list(_j(x).values()),
                                            per_tensor=True)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    np.testing.assert_allclose([float(n) for n in per],
                               [float(n) for n in jper], rtol=1e-6)
    bf = {k: v.to(torch.bfloat16) for k, v in _t(x).items()}
    out, _ = mta.multi_tensor_scale(bf, 2.0, out_dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in out.values())


# -- Adam --------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(weight_decay=0.0),
    dict(weight_decay=0.1),
    dict(weight_decay=0.1, adam_w_mode=False, grad_scale=4.0),
    dict(weight_decay=0.01, bias_correction=False),
], ids=["plain", "adamw", "l2_grad_scale", "no_bias_correction"])
def test_adam_update_matches_jax(kw):
    params, grads = _tree(3), _tree(4)
    jstate = jF.adam_init(_j(params))
    state = adam_init(_t(params))
    for step in range(2):                  # the second step sees moments
        g = {k: v * (step + 1) for k, v in grads.items()}
        jp, jstate = jF.adam_update(_j(g), jstate, _j(params), lr=1e-2, **kw)
        p, state = adam_update(_t(g), state, _t(params), lr=1e-2, **kw)
        _close(p, jp, 1e-6)
        _close(state.exp_avg, jstate.exp_avg, 1e-6)
        _close(state.exp_avg_sq, jstate.exp_avg_sq, 1e-6)
        assert int(state.step) == int(jstate.step) == step + 1
        params = {k: np.asarray(v) for k, v in jp.items()}


def test_adam_apply_mask_skips_and_keeps_dtype():
    params = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in _tree(5).items()}
    state = adam_init(params)
    grads = _t(_tree(6))
    p, s = adam_update(grads, state, params, lr=1e-2,
                       apply_mask=torch.tensor(False))
    assert int(s.step) == 0
    for k in params:
        assert torch.equal(p[k], params[k]) and p[k].dtype == torch.bfloat16
        assert not s.exp_avg[k].any()
    p, s = adam_update(grads, state, params, lr=1e-2,
                       apply_mask=torch.tensor(True))
    assert int(s.step) == 1 and not torch.equal(p["p0"], params["p0"])


# -- amp ---------------------------------------------------------------------

def test_dynamic_loss_scaler_state_machine_matches_jax():
    """Step by step through grow, overflow, floor and cap."""
    kw = dict(scale_window=3, min_loss_scale=2.0 ** 13,
              max_loss_scale=2.0 ** 17)
    jsc, sc = JLossScaler("dynamic", **kw), LossScaler("dynamic", **kw)
    jst, st = jsc.init(), sc.init()
    grads = _tree(7)
    pattern = [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 1, 0]
    for i, bad in enumerate(pattern):
        g = {k: v.copy() for k, v in grads.items()}
        if bad:
            g["p0"][0, 0] = np.inf
        jout, jst = jsc.unscale(_j(g), jst)
        out, st = sc.unscale(_t(g), st)
        assert bool(st.overflow) == bool(jst.overflow) == bool(bad)
        if not bad:
            _close(out, jout, 0)
        jst, st = jsc.update_scale(jst), sc.update_scale(st)
        assert float(st.loss_scale) == float(jst.loss_scale), i
        assert int(st.unskipped) == int(jst.unskipped), i
        assert not bool(st.overflow)
    static = LossScaler(1.0)
    s0 = static.init()
    out, s1 = static.unscale(_t(grads), s0)
    assert not bool(s1.overflow) and float(static.update_scale(s1)
                                          .loss_scale) == 1.0


def test_opt_level_presets():
    o2 = opt_levels["O2"]()
    assert (o2.cast_model_type, o2.master_weights, o2.keep_batchnorm_fp32,
            o2.loss_scale) == (torch.bfloat16, True, True, 1.0)
    o3 = opt_levels["O3"]()
    assert (o3.master_weights, o3.keep_batchnorm_fp32) == (False, False)
    assert opt_levels["O0"]().cast_model_type == torch.float32
    with pytest.raises(AmpOptionError):
        o2.patch_functions = True
    with pytest.raises(AmpOptionError):
        o2.loss_scale = -1
    with pytest.raises(AmpOptionError):
        o2.no_such_option = 1


@pytest.fixture(scope="module")
def flax_params():
    ids = jnp.asarray(np.random.RandomState(0).randint(1, 96, (2, 12)))
    return jgpt_tiny(**CFG).init(jax.random.PRNGKey(3), ids)["params"]


def test_convert_params_keeps_the_same_leaves_fp32(flax_params):
    jcast = jpolicy.convert_params(flax_params, jnp.bfloat16)
    want = {"/".join(str(p.key) for p in path): leaf.dtype == jnp.float32
            for path, leaf in jax.tree_util.tree_leaves_with_path(jcast)}
    sd = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    flax_params))
    got = {k: v.dtype == torch.float32
           for k, v in convert_params(sd, torch.bfloat16).items()}
    assert got == {k.replace("/", "."): v for k, v in want.items()}
    assert got["block_1.ln1.scale"] and got["ln_f.bias"]
    assert not got["wte"] and not got["block_0.attention.query.kernel"]


# -- make_train_step on gpt_tiny ----------------------------------------------

def _batch(seed=1, b=4, t=17):
    ids = np.random.RandomState(seed).randint(1, 96, (b, t))
    return ids[:, :-1], ids[:, 1:]


def _jax_loss(jm, smoothing):
    """The JAX LM example's --no-fused-loss loss."""
    def loss_fn(p, batch):
        xb, yb = batch
        logits = jm.apply({"params": p}, xb)
        flat = logits.reshape(-1, logits.shape[-1])
        labels = yb.reshape(-1)
        logp = jax.nn.log_softmax(flat.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
        smooth = -jnp.mean(logp, axis=-1)
        losses = (1.0 - smoothing) * nll + smoothing * smooth
        return jnp.mean(jnp.where(labels == 0, 0.0, losses))
    return loss_fn


def _port_loss(model, smoothing):
    def loss_fn(p, batch):
        x, y = batch
        return main_amp.lm_loss(torch.func.functional_call(model, p, (x,)),
                                y, smoothing)
    return loss_fn


def _pair(flax_params, opt_level, dtype, loss_scale=None, smoothing=0.1,
          **kw):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = jgpt_tiny(**CFG, dtype=jdt)
    tx_kw = dict(weight_decay=0.1)
    jinit, jstep = jtraining.make_train_step(
        _jax_loss(jm, smoothing), jtraining.adam(1e-3, **tx_kw),
        opt_level=opt_level, loss_scale=loss_scale, **kw)
    tm = gpt_tiny(**CFG, dtype=dtype, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, flax_params)))
    init, step = training.make_train_step(
        _port_loss(tm, smoothing), training.adam(1e-3, **tx_kw),
        opt_level=opt_level, loss_scale=loss_scale, **kw)
    return (jinit(flax_params), jax.jit(jstep)), (init(tm.state_dict()),
                                                 step)


def _flat_jax(params):
    return {"/".join(str(p.key) for p in path).replace("/", "."): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


def _close_params(got, want, tol, lr=1e-3, steps=3):
    """Parameters after ``steps`` Adam steps, at ``tol`` and at least a
    tenth of one step (``0.1 * lr``; a wrong update moves a parameter by
    about ``lr``): Adam divides each gradient element by its own running
    magnitude, so an element whose gradient is near zero turns rounding
    differences into a visible fraction of ``lr``.  The key projection's
    bias has a gradient that is zero in exact arithmetic (it shifts
    every score of a query row alike, which the softmax cancels), so its
    steps are rounding noise throughout and are held to the bound of
    ``steps * lr`` only."""
    zero_grad = [k for k in want if k.endswith("attention.key.bias")]
    for k in zero_grad:
        assert float(got[k].abs().max()) <= steps * lr * 1.01, k
    for k in want:
        if k not in zero_grad:
            np.testing.assert_allclose(
                got[k].detach().float().numpy(),
                np.asarray(want[k], np.float32), rtol=tol,
                atol=max(tol, 0.1 * lr), err_msg=k)


@pytest.mark.parametrize("opt_level,dtype,tol,accum", [
    ("O0", torch.float32, 1e-5, 1),
    ("O0", torch.float32, 1e-5, 2),
    ("O2", torch.bfloat16, 2e-2, 1),
], ids=["O0", "O0_accum2", "O2"])
def test_make_train_step_three_steps_match_jax(flax_params, opt_level,
                                               dtype, tol, accum):
    (jst, jstep), (st, step) = _pair(flax_params, opt_level, dtype,
                                     accum_steps=accum)
    x, y = _batch()
    for i in range(3):
        jst, jm = jstep(jst, (jnp.asarray(x), jnp.asarray(y)))
        st, m = step(st, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=tol, err_msg=f"step {i}")
    _close_params(st.params, _flat_jax(jst.params), tol)
    assert all(v.dtype == torch.float32 for v in st.params.values())
    assert int(st.opt_state.step) == 3


def test_make_train_step_fp16_three_steps_match_jax(flax_params):
    """``cast_model_type=float16`` with a dynamic scale (the JAX
    package's tested fp16 mode, ``tests/test_l1_cross_product.py``) on
    gpt_tiny, three Adam steps against JAX's: fp16 activations keep 11
    bits where bf16 keeps 8, so losses and parameters are held at 5e-3,
    and the loss scale and the skip decisions are equal."""
    tx_kw = dict(weight_decay=0.1)
    jm = jgpt_tiny(**CFG, dtype=jnp.float16)
    jinit, jstep = jtraining.make_train_step(
        _jax_loss(jm, 0.1), jtraining.adam(1e-3, **tx_kw), opt_level="O2",
        cast_model_type=jnp.float16, loss_scale="dynamic")
    tm = gpt_tiny(**CFG, dtype=torch.float16, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, flax_params)))
    init, step = training.make_train_step(
        _port_loss(tm, 0.1), training.adam(1e-3, **tx_kw), opt_level="O2",
        cast_model_type=torch.float16, loss_scale="dynamic")
    jst, jstep, st = jinit(flax_params), jax.jit(jstep), init(tm.state_dict())
    x, y = _batch()
    for i in range(3):
        jst, jmet = jstep(jst, (jnp.asarray(x), jnp.asarray(y)))
        st, met = step(st, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=5e-3, err_msg=f"step {i}")
        assert float(met["loss_scale"]) == float(jmet["loss_scale"])
        assert bool(met["overflow"]) == bool(jmet["overflow"])
    _close_params(st.params, _flat_jax(jst.params), 5e-3)
    assert all(v.dtype == torch.float32 for v in st.params.values())


def test_overflow_skips_the_step_and_halves_the_scale(flax_params):
    """O2 with a dynamic scale and an injected inf in the loss: the step
    is skipped in both packages (parameters and moments unchanged), the
    scale halves, and the next clean step applies."""
    jm = jgpt_tiny(**CFG, dtype=jnp.bfloat16)
    base = _jax_loss(jm, 0.0)
    jinit, jstep = jtraining.make_train_step(
        lambda p, b: base(p, b[:2]) * b[2], jtraining.adam(1e-3),
        opt_level="O2", loss_scale="dynamic")
    tm = gpt_tiny(**CFG, dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, flax_params)))
    tbase = _port_loss(tm, 0.0)
    init, step = training.make_train_step(
        lambda p, b: tbase(p, b[:2]) * b[2], training.adam(1e-3),
        opt_level="O2", loss_scale="dynamic")
    jst, st = jinit(flax_params), init(tm.state_dict())
    x, y = _batch(2)
    before = {k: v.clone() for k, v in st.params.items()}
    for factor, skipped in ((np.inf, True), (1.0, False)):
        jst, jmet = jstep(jst, (jnp.asarray(x), jnp.asarray(y),
                                jnp.float32(factor)))
        st, met = step(st, (torch.from_numpy(x), torch.from_numpy(y),
                            torch.tensor(factor)))
        assert bool(met["overflow"]) == bool(jmet["overflow"]) == skipped
        assert float(met["loss_scale"]) == float(jmet["loss_scale"]) \
            == 2.0 ** 15
        if skipped:
            assert int(st.opt_state.step) == 0
            for k, v in before.items():
                assert torch.equal(st.params[k], v), k
    assert int(st.opt_state.step) == 1
    assert not torch.equal(st.params["wte"], before["wte"])
    _close_params(st.params, _flat_jax(jst.params), 2e-2, steps=1)


def test_port_continues_a_jax_train_state(flax_params):
    """One JAX step, then the state carried into the port
    (``train_state_from_jax``): the next two steps agree at O0."""
    (jst, jstep), (_, step) = _pair(flax_params, "O0", torch.float32)
    x, y = _batch(3)
    jb = (jnp.asarray(x), jnp.asarray(y))
    jst, _ = jstep(jst, jb)
    st = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst))
    assert int(st.opt_state.step) == 1
    for _ in range(2):
        jst, jm = jstep(jst, jb)
        st, m = step(st, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    _close_params(st.params, _flat_jax(jst.params), 1e-5)
    _close(st.opt_state.exp_avg_sq, _flat_jax(jst.opt_state.exp_avg_sq),
           1e-5)


def test_not_ported_arguments_raise():
    """The sharding arguments raise naming their ROADMAP item; the data-
    parallel ones are ported (``tests/test_torch_distributed.py``), and
    ``axis_name="data"`` without a process group says how to make one."""
    with pytest.raises(NotImplementedError, match="item 3"):
        training.make_train_step(lambda p, b: 0, training.adam(),
                                 axis_name="data", reduce_grads=False)
    with pytest.raises(NotImplementedError, match="item 3"):
        training.make_train_step(lambda p, b: 0, training.adam(),
                                 param_view=lambda p: p)
    with pytest.raises(RuntimeError, match="multiproc.initialize"):
        training.make_train_step(lambda p, b: 0, training.adam(),
                                 axis_name="data")
    with pytest.raises(ValueError, match="axis_index_groups"):
        training.make_train_step(lambda p, b: 0, training.adam(),
                                 axis_index_groups=[[0]])
    _, step = training.make_train_step(lambda p, b: 0, training.adam(),
                                       gradient_average=False)
    assert step.process_group is None


# -- the LM trainer entry point ------------------------------------------------

TINY = ["--synthetic", "--device", "cpu", "--vocab", "128", "--hidden",
        "64", "--layers", "2", "--heads", "4", "--seq-len", "33", "-b", "4"]


def test_lm_trainer_runs_on_cpu_and_loss_falls(capsys):
    assert main_amp.main(TINY + ["--steps", "3", "--lr", "3e-3"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    losses = [float(ln.split()[3]) for ln in lines]
    assert len(losses) == 3 and losses[-1] < losses[0]


def test_lm_trainer_options_and_refusals():
    res = main_amp.train(main_amp.parse(
        TINY + ["--steps", "2", "--kv-heads", "2", "--window", "8",
                "--loss-scale", "dynamic", "--smoothing", "0.1"]),
        log=lambda s: None)
    assert res["loss_scales"] == [2.0 ** 16] * 2
    assert all(np.isfinite(res["losses"]))
    # --fused-loss is the default; --no-fused-loss is the composition,
    # the same loss on the same batch and weights
    assert main_amp.parse(TINY).fused_loss
    plain = main_amp.train(main_amp.parse(
        TINY + ["--steps", "1", "--smoothing", "0.1", "--no-fused-loss"]),
        log=lambda s: None)
    fused = main_amp.train(main_amp.parse(
        TINY + ["--steps", "1", "--smoothing", "0.1"]), log=lambda s: None)
    np.testing.assert_allclose(fused["losses"], plain["losses"], rtol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main_amp.main(TINY[:1] + TINY[3:] + ["--steps", "1"])


@pytest.mark.parametrize("attention", ["full", "blockwise", "flash"])
def test_lm_trainer_attention_flag_matches_jax_losses(attention,
                                                      monkeypatch):
    """``--attention`` (JAX's choices; default ``flash``) picks the GPT's
    ``attention_impl``: two O0 steps of the trainer's ``build`` at each
    value give the losses of the JAX LM example's model (the same
    ``attention_impl``), fused loss and Adam step (``main_amp.py:192-243``)
    from the same weights on the same synthetic batch, at rtol 1e-4 (the
    model computes in bf16 on both sides, in different summation orders;
    the worst seen is 3.4e-5); ring, ring_flash and ulysses are refused
    naming the sharding item; ``--window`` needs flash, as in the JAX
    example (``main_amp.py:186-187``)."""
    import importlib.util
    import os
    import sys
    from apex_tpu.models.gpt import GPT as JGPT
    from apex_tpu_torch.models import GPT
    from apex_tpu_torch.convert import gpt_params_to_jax
    spec = importlib.util.spec_from_file_location(
        "_jax_lm_main_amp", os.path.join(os.path.dirname(__file__),
                                         os.pardir, "examples", "lm",
                                         "main_amp.py"))
    jlm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jlm)
    monkeypatch.setattr(sys, "argv", ["main_amp.py"])
    jargs = jlm.parse()
    assert main_amp.parse(TINY).attention == jargs.attention == "flash"
    made = []
    monkeypatch.setattr(main_amp, "GPT", lambda **kw: made.append(
        kw["attention_impl"]) or GPT(**kw))
    args = main_amp.parse(TINY + ["--opt-level", "O0", "--attention",
                                  attention])
    state, step_fn, batch = main_amp.build(args)
    assert made == [attention]
    jm = JGPT(vocab_size=args.vocab, hidden_size=args.hidden,
              num_layers=args.layers, num_heads=args.heads,
              mlp_dim=4 * args.hidden, max_len=args.seq_len,
              dtype=jnp.bfloat16, attention_impl=attention)

    def jloss(p, b):
        logits = jm.apply({"params": p}, b[0])
        flat = logits.reshape(-1, logits.shape[-1])
        return jnp.mean(jax_xentropy(flat, b[1].reshape(-1),
                                     smoothing=args.smoothing))
    jinit, jstep = jtraining.make_train_step(
        jloss, jtraining.adam(args.lr, weight_decay=args.weight_decay),
        opt_level="O0")
    jst = jinit(gpt_params_to_jax(state.params))
    jstep = jax.jit(jstep)
    jbatch = tuple(jnp.asarray(t.numpy()) for t in batch)
    for i in range(2):
        state, met = step_fn(state, batch)
        jst, jmet = jstep(jst, jbatch)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    for impl in ("ring", "ring_flash", "ulysses"):
        with pytest.raises(SystemExit, match="queue 1 item 3"):
            main_amp.build(main_amp.parse(TINY + ["--attention", impl]))
    if attention != "flash":
        with pytest.raises(SystemExit, match="--window needs --attention "
                                             "flash"):
            main_amp.build(main_amp.parse(
                TINY + ["--attention", attention, "--window", "8"]))


# -- SGD -------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(momentum=0.9, weight_decay=1e-2),
    dict(momentum=0.9, nesterov=True, weight_decay=1e-2),
    dict(momentum=0.9, dampening=0.3, weight_decay=1e-2,
         wd_after_momentum=True, grad_scale=4.0),
    dict(momentum=0.0, weight_decay=1e-2),
], ids=["momentum", "nesterov", "dampening_wd_after_scale", "no_momentum"])
def test_sgd_update_matches_jax(kw):
    """Three steps, the first skipped by ``apply_mask``: the skip leaves
    everything (the momentum buffer stays uninitialized), the first
    applied step sets the buffer to the gradient."""
    params, grads = _tree(8), _tree(9)
    jstate = jF.sgd_init(_j(params), kw["momentum"])
    state = sgd_init(_t(params), kw["momentum"])
    for step, mask in enumerate((False, True, True)):
        g = {k: v * (step + 1) for k, v in grads.items()}
        jp, jstate = jF.sgd_update(_j(g), jstate, _j(params), lr=1e-2,
                                   apply_mask=jnp.asarray(mask), **kw)
        p, state = sgd_update(_t(g), state, _t(params), lr=1e-2,
                              apply_mask=torch.tensor(mask), **kw)
        _close(p, jp, 1e-6)
        _close(state.momentum_buf, jstate.momentum_buf, 1e-6)
        assert bool(state.initialized) == bool(jstate.initialized) \
            == (step > 0)
        params = {k: np.asarray(v) for k, v in jp.items()}
    p, _ = sgd_update(_t(grads), sgd_init(_t(params)), _t(params), lr=1e-2)
    assert not torch.equal(p["p0"], _t(params)["p0"])


# -- the ImageNet step: make_train_step(has_model_state=True) ---------------------

def _flat_tree(tree):
    return {k: np.asarray(v) for k, v in _flat_jax(tree).items()}


def _resnet_pair(opt_level, loss_scale=None, inject=False,
                 pallas_conv=False, **kw):
    """The JAX and port ImageNet steps (SGD, BN statistics as the model
    state, fused cross-entropy) on the same small ResNet weights; with
    ``pallas_conv`` the convs of both are their packages' ``PallasConv``
    (the trainers' ``--pallas-conv``)."""
    jdt = jnp.bfloat16 if opt_level == "O2" else jnp.float32
    dtype = torch.bfloat16 if opt_level == "O2" else torch.float32
    jm = jresnet.ResNet(block_cls=jresnet.BasicBlock, dtype=jdt,
                        norm_cls=JBatchNorm2d_NHWC,
                        conv_cls=JPallasConv if pallas_conv else None,
                        **RESNET_SMALL)
    tm = ResNet(block_cls=BasicBlock, dtype=dtype, norm_cls=BatchNorm2d_NHWC,
                conv_cls=PallasConv if pallas_conv else None,
                device="cpu", seed=4, **RESNET_SMALL)
    variables = resnet_variables_to_jax(*tm.variables())

    def jloss(p, ms, batch):
        logits, upd = jm.apply({"params": p, "batch_stats": ms}, batch[0],
                               train=True, mutable=["batch_stats"])
        loss = jnp.mean(jax_xentropy(logits.astype(jnp.float32), batch[1],
                                     0.0, -1))
        return (loss * batch[2] if inject else loss), upd["batch_stats"]

    def tloss(p, ms, batch):
        logits, new_ms = tm.apply(p, ms, batch[0])
        loss = imagenet_main.image_loss(logits, batch[1])
        return (loss * batch[2] if inject else loss), new_ms

    step_kw = dict(opt_level=opt_level, loss_scale=loss_scale,
                   has_model_state=True, **kw)
    jinit, jstep = jtraining.make_train_step(
        jloss, jtraining.sgd(0.02, momentum=0.9, weight_decay=1e-4),
        **step_kw)
    init, step = training.make_train_step(
        tloss, training.sgd(0.02, momentum=0.9, weight_decay=1e-4),
        **step_kw)
    params, stats = tm.variables()
    return ((jinit(variables["params"], variables["batch_stats"]),
             jax.jit(jstep)),
            (init({k: v.detach() for k, v in params.items()},
                  {k: v.clone() for k, v in stats.items()}), step))


def _image_batch(seed=5, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("opt_level,accum,tol,pallas_conv", [
    ("O0", 1, 1e-4, False), ("O0", 2, 1e-4, False), ("O2", 1, 2e-2, False),
    ("O0", 1, 1e-4, True), ("O2", 1, 2e-2, True)],
    ids=["O0", "O0_accum2", "O2", "O0_pallas_conv", "O2_pallas_conv"])
def test_resnet_step_with_model_state_matches_jax(opt_level, accum, tol,
                                                  pallas_conv):
    """Three SGD steps: losses (rtol ``tol``), and at O0 the parameters
    and the BN running statistics (atol 1e-4, fp32 summation order
    through eight layers) and the momentum buffers; with and without
    ``PallasConv`` in both packages."""
    (jst, jstep), (st, step) = _resnet_pair(opt_level, accum_steps=accum,
                                            pallas_conv=pallas_conv)
    x, y = _image_batch()
    for i in range(3):
        jst, jm = jstep(jst, (jnp.asarray(x), jnp.asarray(y)))
        st, m = step(st, (torch.from_numpy(x), torch.from_numpy(y).long()))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=tol, err_msg=f"step {i}")
    assert bool(st.opt_state.initialized)
    assert all(v.dtype == torch.float32 for v in st.params.values())
    if opt_level == "O0":
        _close(st.params, _flat_tree(jst.params), 1e-4)
        _close(st.model_state, _flat_tree(jst.model_state), 1e-4)
        _close(st.opt_state.momentum_buf,
               _flat_tree(jst.opt_state.momentum_buf), 1e-4)


def test_resnet_skipped_step_keeps_params_and_advances_model_state():
    """O2, dynamic scale, an inf injected into the loss: the step is
    skipped (parameters bit-identical, momentum uninitialized), the
    scale halves, and the BN statistics advance as in JAX."""
    (jst, jstep), (st, step) = _resnet_pair("O2", "dynamic", inject=True)
    x, y = _image_batch(6)
    before = {k: v.clone() for k, v in st.params.items()}
    stats0 = {k: v.clone() for k, v in st.model_state.items()}
    jst, jm = jstep(jst, (jnp.asarray(x), jnp.asarray(y),
                          jnp.float32(np.inf)))
    st, m = step(st, (torch.from_numpy(x), torch.from_numpy(y).long(),
                      torch.tensor(np.inf)))
    assert bool(m["overflow"]) and bool(jm["overflow"])
    assert float(m["loss_scale"]) == float(jm["loss_scale"]) == 2.0 ** 15
    assert not bool(st.opt_state.initialized)
    for k, v in before.items():
        assert torch.equal(st.params[k], v), k
    assert any(not torch.equal(st.model_state[k], v)
               for k, v in stats0.items())
    _close(st.model_state, _flat_tree(jst.model_state), 2e-2)


def test_port_continues_a_jax_sgd_train_state():
    """One JAX ImageNet step, then its state (SGD momentum, BN
    statistics) carried into the port: the next step agrees at O0."""
    (jst, jstep), (_, step) = _resnet_pair("O0")
    x, y = _image_batch(7)
    jb = (jnp.asarray(x), jnp.asarray(y))
    jst, _ = jstep(jst, jb)
    st = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst))
    assert bool(st.opt_state.initialized)
    jst, jm = jstep(jst, jb)
    st, m = step(st, (torch.from_numpy(x), torch.from_numpy(y).long()))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    _close(st.params, _flat_tree(jst.params), 1e-4)
    _close(st.model_state, _flat_tree(jst.model_state), 1e-4)


# -- synthetic ImageNet data ------------------------------------------------------

def test_synthetic_imagenet_equals_jax_bytes_and_labels():
    want = list(jdata.synthetic_imagenet(3, 16, num_classes=10, steps=2,
                                         seed=7))
    got = list(data.synthetic_imagenet(3, 16, num_classes=10, steps=2,
                                       seed=7))
    assert len(got) == 2
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == np.uint8 and gl.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    norm = data.normalize_images(torch.from_numpy(got[0][0]))
    assert norm.dtype == torch.float32
    np.testing.assert_allclose(norm.numpy(),
                               jdata.normalize_images(want[0][0]),
                               atol=1e-6)
    assert data.IMAGENET_MEAN == jdata.IMAGENET_MEAN
    assert data.IMAGENET_STD == jdata.IMAGENET_STD


# -- the ImageNet trainer entry point ---------------------------------------------

IMAGENET_TINY = ["--synthetic", "--device", "cpu", "--arch", "resnet18",
                 "-b", "4", "--image-size", "32"]


def test_imagenet_trainer_runs_on_cpu(capsys):
    assert imagenet_main.main(IMAGENET_TINY + ["--prof", "2"]) == 0
    out = capsys.readouterr().out
    assert "iter 1" in out and out.rstrip().endswith("done")
    res = imagenet_main.train(imagenet_main.parse(
        IMAGENET_TINY + ["--prof", "2", "--opt-level", "O2", "--loss-scale",
                         "dynamic", "--no-fused-bn", "--no-fused-loss"]),
        log=lambda s: None)
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["loss_scales"] == [2.0 ** 16] * 2
    assert res["images_per_step"] == 4
    x, y = imagenet_main.synthetic_batch(4, 32, "cpu")
    imgs, labels = next(jdata.synthetic_imagenet(4, 32, steps=1))
    np.testing.assert_array_equal(y.numpy(), labels)
    np.testing.assert_allclose(x.numpy(), jdata.normalize_images(imgs),
                               atol=1e-6)


@pytest.mark.parametrize("flag", ["--pallas-conv", "--no-pallas-conv"])
def test_imagenet_trainer_conv_flag_trains(capsys, flag):
    """Both conv routes train two CPU steps; the run ends with the conv
    sites' count (resnet18: 20 convs a forward, through ``conv2d`` under
    ``--pallas-conv``, none without it)."""
    assert imagenet_main.parse(IMAGENET_TINY).pallas_conv   # the default
    assert imagenet_main.main(IMAGENET_TINY + ["--prof", "2", flag]) == 0
    out = capsys.readouterr().out
    sites = 40 if flag == "--pallas-conv" else 0
    assert f"pallas_conv={flag == '--pallas-conv'}" in out
    assert f"conv sites {sites} kernel / 0 plain-fallback" in out
    assert "iter 1" in out and out.rstrip().endswith("done")


def test_imagenet_trainer_refusals(tmp_path):
    """``--telemetry`` is ported (the stream written, the recorder closed
    at the end), as are ``--sync_bn`` (in one process it syncs nothing;
    two ranks in ``tests/test_torch_multiproc.py``), checkpointing and a
    ``data`` directory (a missing directory fails as a missing
    directory)."""
    stream = str(tmp_path / "t.jsonl")
    assert imagenet_main.main(IMAGENET_TINY + ["--prof", "1", "--telemetry",
                                               stream]) == 0
    with open(stream) as f:
        assert json.loads(f.read().splitlines()[-1])["kind"] == "summary"
    assert imagenet_main.main(IMAGENET_TINY + ["--prof", "1",
                                               "--sync_bn"]) == 0
    with pytest.raises(FileNotFoundError):
        imagenet_main.main([str(tmp_path / "no_such_dir"), "--device",
                            "cpu", "--arch", "resnet18", "-b", "4",
                            "--image-size", "32"])
    assert imagenet_main.main(IMAGENET_TINY + [
        "--prof", "2", "--checkpoint-dir", str(tmp_path / "ck")]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            imagenet_main.main(IMAGENET_TINY[:1] + IMAGENET_TINY[3:]
                               + ["--prof", "1"])


def test_imagenet_trainer_deterministic_flag():
    """``--deterministic`` (JAX's flag; there the highest matmul
    precision, the port's default) turns on torch's deterministic
    algorithms and cuDNN's deterministic kernels without benchmarking; a
    CPU run under it trains the same losses as without.  The process
    state is restored after."""
    assert not imagenet_main.parse(IMAGENET_TINY).deterministic
    argv = IMAGENET_TINY + ["--prof", "2"]
    ref = imagenet_main.train(imagenet_main.parse(argv), log=lambda s: None)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        res = imagenet_main.train(imagenet_main.parse(
            argv + ["--deterministic"]), log=lambda s: None)
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]
        torch.backends.cudnn.benchmark = saved[2]
    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=1e-6)


def _image_tree(root, classes=2, per_class=8, size=48):
    rng = np.random.RandomState(11)
    for c in range(classes):
        d = root / f"n{c:02d}"
        d.mkdir(parents=True)
        for i in range(per_class):
            np.save(d / f"img{i}.npy",
                    rng.randint(0, 256, (size, size, 3)).astype(np.uint8))
    return str(root)


def test_imagenet_trainer_directory_augment_tracks_jax(tmp_path):
    """The trainer on a directory with ``--augment`` (resnet18, 32 px, O0,
    K 2, 2 workers): its losses equal the JAX step's fed by the JAX
    package's own stream over the same directory (``directory_imagenet(
    decode=False)``, ``load_batch``, ``augment_images`` at the JAX
    example's per-batch seed) from the same weights, at rtol 1e-4 as the
    ImageNet step's parity above; the loader state rides in the
    checkpoint at the loop's boundary."""
    import zlib
    root = _image_tree(tmp_path / "data")
    argv = [root, "--device", "cpu", "--arch", "resnet18", "-b", "4",
            "--image-size", "32", "--epochs", "1", "--steps-per-call", "2",
            "--augment", "--workers", "2", "--no-pallas-conv",
            "--checkpoint-dir", str(tmp_path / "ck")]
    res = imagenet_main.train(imagenet_main.parse(argv), log=lambda s: None)
    assert res["step"] == 4 and len(res["losses"]) == 4
    assert res["loader"]["batches"] == 2
    from apex_tpu_torch.checkpoint import load_checkpoint_dir
    got = load_checkpoint_dir(str(tmp_path / "ck"), res["state"])
    assert got.loader_state["cursor"] == 4 and got.step == 4

    tm = imagenet_main.ARCHS["resnet18"](
        num_classes=1000, dtype=torch.float32, norm_cls=BatchNorm2d_NHWC,
        device="cpu", seed=0)
    variables = resnet_variables_to_jax(*tm.variables())
    jm = jresnet.ResNet18(num_classes=1000, dtype=jnp.float32,
                          norm_cls=JBatchNorm2d_NHWC)

    def jloss(p, ms, batch):
        logits, upd = jm.apply({"params": p, "batch_stats": ms}, batch[0],
                               train=True, mutable=["batch_stats"])
        loss = jnp.mean(jax_xentropy(logits.astype(jnp.float32), batch[1],
                                     0.0, -1))
        return loss, upd["batch_stats"]
    jinit, jstep = jtraining.make_train_step(
        jloss, jtraining.sgd(0.1 * 4 / 256, momentum=0.9,
                             weight_decay=1e-4),
        opt_level="O0", has_model_state=True)
    jstep = jax.jit(jstep)
    jst = jinit(variables["params"], variables["batch_stats"])
    want = []
    for task in jdata.directory_imagenet(root, 4, 64, epochs=1,
                                         decode=False):
        imgs, labels = jdata.load_batch(task)
        rng = np.random.RandomState(
            (zlib.crc32("|".join(task.paths).encode())
             ^ (task.seq * 2654435761)) & 0x7FFFFFFF)
        x = jdata.augment_images(imgs, 32, rng)
        jst, m = jstep(jst, (jnp.asarray(x), jnp.asarray(labels)))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(res["losses"], want, rtol=1e-4)


# -- the LM trainer's fused loss --------------------------------------------------

def _jax_fused_loss(jm, smoothing):
    """The JAX LM example's default (--fused-loss) loss."""
    def loss_fn(p, batch):
        logits = jm.apply({"params": p}, batch[0])
        flat = logits.reshape(-1, logits.shape[-1])
        return jnp.mean(jax_xentropy(flat, batch[1].reshape(-1), smoothing))
    return loss_fn


def test_lm_fused_loss_three_steps_match_jax(flax_params):
    jm = jgpt_tiny(**CFG)
    jinit, jstep = jtraining.make_train_step(
        _jax_fused_loss(jm, 0.1), jtraining.adam(1e-3, weight_decay=0.1),
        opt_level="O0")
    tm = gpt_tiny(**CFG, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, flax_params)))

    def loss_fn(p, batch):
        return main_amp.lm_loss(torch.func.functional_call(tm, p, (batch[0],)),
                                batch[1], 0.1, fused=True)
    init, step = training.make_train_step(
        loss_fn, training.adam(1e-3, weight_decay=0.1), opt_level="O0")
    jst, st = jinit(flax_params), init(tm.state_dict())
    x, y = _batch(4)
    y[:, ::3] = 0                                     # padding tokens
    jstep = jax.jit(jstep)
    for i in range(3):
        jst, jmet = jstep(jst, (jnp.asarray(x), jnp.asarray(y)))
        st, met = step(st, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
    _close_params(st.params, _flat_jax(jst.params), 1e-5)
