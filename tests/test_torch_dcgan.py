"""The DCGAN pair and trainer of the port against the JAX package's
(``apex_tpu/models/dcgan.py``, ``examples/dcgan/main_amp.py``), on the
same weights (flax's init, through ``convert.dcgan_params_from_jax``)
and the same inputs:

* each ``ConvTranspose`` alone against flax's (``'SAME'``, unflipped
  kernel), forward and gradients, rtol 1e-5 / atol 1e-5 (fp32 sums);
* the Generator and Discriminator at ngf/ndf 8, batch 4: fp32 forward
  and parameter gradients within rtol 1e-4 / atol 1e-5; under O1 the
  output dtype of every layer equal to JAX's, and the forward within
  atol 3e-2 (the products' bf16 roundings differ between XLA and torch);
* the trainer's pool byte for byte the JAX example's; both modes over 3
  iterations against the JAX example's iteration, rebuilt here from the
  JAX package: the losses within rtol 1e-5 at O0 and 2e-3 at O1 (bf16
  products rounded by XLA and by torch); at O0, 99.9% of every leaf
  within rtol 1e-4 / atol 1e-5 but for the biases that feed a BatchNorm
  (their gradient is rounding noise, which Adam turns into lr-sized
  steps); at O1 (where each package's bf16 products round their own way,
  and Adam turns that into other steps for the small gradients) the
  change of the other leaves, one vector a net, at JAX's length within
  2% and at a cosine of at least 0.85 with JAX's (an update of another
  size fails the length; O1 against O0 is told by the layer dtypes
  above, not by the cosine); every element within 2 x 3 x 1.1 lr (lr
  2e-4, beta1 0.5); the BatchNorm running statistics unchanged; an
  overflow on loss 1 halving only scaler 1 and skipping only D's step;
  the refused flags; the pipelined mode stopped and resumed from its
  checkpoint bit for bit.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from apex_tpu import amp as jamp
from apex_tpu import training as jtraining
from apex_tpu.amp import autocast as jautocast
from apex_tpu.amp.loss_scaler import LossScaler as JLossScaler
from apex_tpu.models import Discriminator as JDiscriminator
from apex_tpu.models import Generator as JGenerator
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu_torch import amp, convert
from apex_tpu_torch.examples.dcgan import main_amp as dcgan
from apex_tpu_torch.models.dcgan import ConvTranspose, Discriminator, Generator

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_dcgan_example", os.path.join(_ROOT, "examples", "dcgan",
                                      "main_amp.py"))
jdcgan = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jdcgan)

B, NZ, NGF, NDF = 4, 100, 8, 8


@pytest.fixture(autouse=True)
def _clean_amp():
    yield
    amp.shutdown()
    amp.initialize(enabled=False, verbosity=0)
    jautocast.shutdown()
    jamp.initialize(enabled=False, verbosity=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def flax_pair():
    netG, netD = JGenerator(ngf=NGF, nc=3), JDiscriminator(ndf=NDF)
    z = jnp.ones((B, NZ))
    gv = netG.init(jax.random.PRNGKey(0), z)
    dv = netD.init(jax.random.PRNGKey(1), netG.apply(gv, z, train=False))
    return netG, netD, gv, dv


def _port_pair(gv, dv):
    g = Generator(ngf=NGF, nz=NZ, device="cpu")
    d = Discriminator(ndf=NDF, device="cpu")
    for net, v in ((g, gv), (d, dv)):
        params, stats = convert.dcgan_params_from_jax(_np(v))
        net.load_state_dict({**params, **stats})
    return g, d


# -- layers -----------------------------------------------------------------------

@pytest.mark.parametrize("hw,cin,cout,k,s", [
    (4, 16, 8, 4, 2), (5, 3, 4, 4, 2), (6, 4, 4, 3, 1), (3, 2, 5, 3, 2),
    (4, 3, 2, 5, 2), (2, 4, 3, 2, 2)])
def test_conv_transpose_layer_matches_flax(hw, cin, cout, k, s):
    layer = fnn.ConvTranspose(cout, (k, k), (s, s), padding="SAME")
    x = np.random.RandomState(0).randn(2, hw, hw, cin).astype(np.float32)
    v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": dict(v["params"], bias=jax.random.normal(
        jax.random.PRNGKey(1), (cout,)))}
    port = ConvTranspose(cin, cout, (k, k), (s, s), device="cpu")
    port.load_state_dict({kk: torch.from_numpy(np.array(a))
                          for kk, a in v["params"].items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port(xt)
    jy = layer.apply(v, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    gy = np.random.RandomState(2).randn(*jy.shape).astype(np.float32)
    (y * torch.from_numpy(gy)).sum().backward()
    jgx, jgv = jax.grad(lambda xx, vv: jnp.sum(layer.apply(vv, xx) * gy),
                        argnums=(0, 1))(jnp.asarray(x), v)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port.kernel.grad.numpy(),
                               np.asarray(jgv["params"]["kernel"]),
                               rtol=1e-5, atol=1e-5)


# -- the models -----------------------------------------------------------------

def _z():
    return np.random.RandomState(0).randn(B, NZ).astype(np.float32)


def test_models_fp32_forward_and_grads_match_flax(flax_pair):
    netG, netD, gv, dv = flax_pair
    g, d = _port_pair(gv, dv)
    z = _z()

    def jloss(gp, dp):
        fake, _ = netG.apply({**gv, "params": gp}, jnp.asarray(z),
                             train=True, mutable=["batch_stats"])
        out, _ = netD.apply({**dv, "params": dp}, fake, train=True,
                            mutable=["batch_stats"])
        return jnp.mean(out ** 2), (fake, out)

    (jl, (jfake, jout)), (jgg, jgd) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(gv["params"], dv["params"])
    fake = g(torch.from_numpy(z))
    out = d(fake)
    np.testing.assert_allclose(fake.detach().numpy(), np.asarray(jfake),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    torch.mean(out ** 2).backward()
    for net, jg in ((g, jgg), (d, jgd)):
        want = convert.dcgan_params_from_jax(_np({"params": jg}))[0]
        for k, p in net.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def _port_dtypes(net, x):
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: seen.__setitem__(name, out.dtype))
        for name, m in net.named_children()]
    out = net(x)
    for h in hooks:
        h.remove()
    seen[""] = out.dtype
    return out, {k: str(v).replace("torch.", "") for k, v in seen.items()}


def _jax_dtypes(net, variables, x):
    out, st = net.apply(variables, x, train=True,
                        mutable=["batch_stats", "intermediates"],
                        capture_intermediates=True)
    inter = st["intermediates"]
    got = {k: jnp.dtype(v["__call__"][0].dtype).name
           for k, v in inter.items() if k != "__call__"}
    got[""] = jnp.dtype(inter["__call__"][0].dtype).name
    return out, got


def test_o1_layer_dtypes_and_values_match_jax(flax_pair):
    netG, netD, gv, dv = flax_pair
    g, d = _port_pair(gv, dv)
    z = _z()
    amp.init()
    jamp.init()
    fake, got_g = _port_dtypes(g, torch.from_numpy(z))
    jfake, want_g = _jax_dtypes(netG, gv, jnp.asarray(z))
    out, got_d = _port_dtypes(d, fake.detach())
    jout, want_d = _jax_dtypes(netD, dv, jfake)
    assert got_g == want_g
    assert got_d == want_d
    np.testing.assert_allclose(fake.detach().numpy(), np.asarray(jfake),
                               atol=3e-2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=3e-2)
    out.float().mean().backward()
    assert all(p.grad.dtype == torch.float32 for p in d.parameters())


# -- the trainer ------------------------------------------------------------------

def _args(**kw):
    argv = ["--device", "cpu", "--batchSize", str(B), "--ngf", str(NGF),
            "--ndf", str(NDF), "--iters-per-epoch", "3", "--data-pool", "2",
            "--warmup", "0", "--steps-per-call", "1", "--print-freq", "1"]
    for k, v in kw.items():
        argv += [f"--{k}"] + ([] if v is True else [str(v)])
    return dcgan.parse(argv)


def test_pool_is_the_jax_examples(flax_pair):
    args = _args()
    pool = dcgan.synthetic_pool(args, "cpu")
    jpool = jdcgan._synthetic_pool(args)
    for (r, n), (jr, jn) in zip(pool, jpool):
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


def _jax_pipelined(args, netG, netD, gv, dv, iters):
    """The JAX example's pipelined iteration (``examples/dcgan/
    main_amp.py:185-258``), built from the JAX package."""
    if args.opt_level == "O1":
        jamp.init()
    g_state = {k: v for k, v in gv.items() if k != "params"}
    d_state = {k: v for k, v in dv.items() if k != "params"}
    bce = jdcgan.bce_with_logits
    dynamic = args.opt_level != "O0"
    scalers = [JLossScaler("dynamic" if dynamic else 1.0) for _ in range(3)]
    tx = jtraining.adam(lr=args.lr, beta1=args.beta1, beta2=0.999)
    state = {"g": gv["params"], "d": dv["params"],
             "g_opt": tx.init(gv["params"]), "d_opt": tx.init(dv["params"]),
             "s0": scalers[0].init(), "s1": scalers[1].init(),
             "s2": scalers[2].init()}

    def d_out(p, x):
        return netD.apply({"params": p, **d_state}, x, train=True,
                          mutable=["batch_stats"])[0]

    def g_out(p, z):
        return netG.apply({"params": p, **g_state}, z, train=True,
                          mutable=["batch_stats"])[0]

    def step(state, real, noise):
        fake = jax.lax.stop_gradient(g_out(state["g"], noise))
        e_r, g_r = jax.value_and_grad(lambda p: jnp.float32(bce(
            d_out(p, real), 1.0)) * state["s0"].loss_scale)(state["d"])
        e_f, g_f = jax.value_and_grad(lambda p: jnp.float32(bce(
            d_out(p, fake), 0.0)) * state["s1"].loss_scale)(state["d"])
        g_r, s0 = scalers[0].unscale(g_r, state["s0"])
        g_f, s1 = scalers[1].unscale(g_f, state["s1"])
        mask_d = (jnp.logical_not(s0.overflow | s1.overflow)
                  if dynamic else None)
        g_d = jax.tree_util.tree_map(lambda a, b: a + b, g_r, g_f)
        d_new, d_opt = tx.update(g_d, state["d_opt"], state["d"],
                                 apply_mask=mask_d)
        e_g, g_g = jax.value_and_grad(lambda p: jnp.float32(bce(
            d_out(d_new, g_out(p, noise)), 1.0))
            * state["s2"].loss_scale)(state["g"])
        g_g, s2 = scalers[2].unscale(g_g, state["s2"])
        mask_g = jnp.logical_not(s2.overflow) if dynamic else None
        g_new, g_opt = tx.update(g_g, state["g_opt"], state["g"],
                                 apply_mask=mask_g)
        losses = (e_r / state["s0"].loss_scale + e_f / state["s1"].loss_scale,
                  e_g / state["s2"].loss_scale)
        return {"g": g_new, "d": d_new, "g_opt": g_opt, "d_opt": d_opt,
                "s0": scalers[0].update_scale(s0),
                "s1": scalers[1].update_scale(s1),
                "s2": scalers[2].update_scale(s2)}, losses

    # the example's window: K pool batches, reused every window
    pool = jdcgan._synthetic_pool(args)
    k = args.steps_per_call
    losses = []
    for i in range(iters):
        state, ls = step(state, *pool[(i % k) % len(pool)])
        losses.append([float(x) for x in ls])
    jautocast.shutdown()
    return state["g"], state["d"], losses


def _jax_imperative(args, netG, netD, gv, dv, iters):
    """The JAX example's ``--imperative`` iteration (``:393-490``)."""
    optG = JFusedAdam(gv["params"], lr=args.lr, betas=(args.beta1, 0.999))
    optD = JFusedAdam(dv["params"], lr=args.lr, betas=(args.beta1, 0.999))
    _, [optG, optD] = jamp.initialize(
        [optG.params, optD.params], [optG, optD], opt_level=args.opt_level,
        num_losses=3, verbosity=0)
    g_state = {k: v for k, v in gv.items() if k != "params"}
    d_state = {k: v for k, v in dv.items() if k != "params"}
    bce = jdcgan.bce_with_logits

    def d_out(p, x):
        return netD.apply({"params": p, **d_state}, x, train=True,
                          mutable=["batch_stats"])[0]

    def g_out(p, z):
        return netG.apply({"params": p, **g_state}, z, train=True,
                          mutable=["batch_stats"])[0]

    pool = jdcgan._synthetic_pool(args)
    losses = []
    for i in range(iters):
        real, noise = pool[i % len(pool)]
        fake = jax.lax.stop_gradient(g_out(optG.params, noise))
        e_r, g_r = jax.value_and_grad(lambda p: bce(d_out(p, real), 1.0))(
            optD.params)
        e_f, g_f = jax.value_and_grad(lambda p: bce(d_out(p, fake), 0.0))(
            optD.params)
        with jamp.scale_loss(e_r, optD, loss_id=0):
            optD.backward(g_r)
        with jamp.scale_loss(e_f, optD, loss_id=1):
            optD.backward(g_f)
        optD.step()
        e_g, g_g = jax.value_and_grad(lambda p: bce(d_out(
            optD.params, g_out(p, noise)), 1.0))(optG.params)
        with jamp.scale_loss(e_g, optG, loss_id=2):
            optG.backward(g_g)
        optG.step()
        losses.append([float(e_r + e_f), float(e_g)])
    return optG.params, optD.params, losses


#: biases that feed a BatchNorm over their channel: their gradient is
#: zero but for rounding, which Adam turns into lr-sized steps of either
#: sign in each package (``project.bias`` is per position and channel,
#: and has a gradient)
_BN_FED = {"deconv1.bias", "deconv2.bias", "deconv3.bias",
           "conv2.bias", "conv3.bias", "conv4.bias"}


def _compare(port_params, jax_params, start, bound, tight):
    """Every element within ``bound`` (what two runs of Adam may part by
    in three steps); with ``tight``, 99.9% of each leaf not fed to a
    BatchNorm within it; else (O1) the change from ``start`` of the
    leaves not fed to a BatchNorm, taken as one vector a net, at the
    length of JAX's within 2% and at a cosine of at least 0.85 with it."""
    want = convert.dcgan_params_from_jax(_np({"params": jax_params}))[0]
    moved, jmoved = [], []
    for k, v in port_params.items():
        got, ref = v.detach().float().numpy(), want[k].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=bound, err_msg=k)
        if k in _BN_FED:
            continue
        if tight is not None:
            close = np.isclose(got, ref, **tight)
            assert close.mean() >= 0.999, (k, close.mean())
        moved.append((got - start[k]).ravel())
        jmoved.append((ref - start[k]).ravel())
    if tight is None:
        a, b = np.concatenate(moved), np.concatenate(jmoved)
        ratio = np.linalg.norm(a) / np.linalg.norm(b)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert abs(ratio - 1) <= 0.02 and cos >= 0.85, (ratio, cos)


@pytest.mark.parametrize("mode,level", [("pipelined", "O0"),
                                        ("pipelined", "O1"),
                                        ("imperative", "O0"),
                                        ("imperative", "O1")])
def test_trainer_tracks_the_jax_example(flax_pair, mode, level):
    netG, netD, gv, dv = flax_pair
    g, d = _port_pair(gv, dv)
    stats = [{k: v.clone() for k, v in net.named_buffers()}
             for net in (g, d)]
    start = [{k: v.detach().float().numpy().copy()
              for k, v in net.named_parameters()} for net in (g, d)]
    args = _args(opt_level=level)
    # Adam moves an element by at most ~1.06 lr a step here (beta1 0.5,
    # beta2 0.999, bias-corrected), so two runs part by at most this
    bound = 2 * 3 * 1.1 * args.lr
    tight = dict(rtol=1e-4, atol=1e-5) if level == "O0" else None
    if mode == "pipelined":
        res = dcgan.train_pipelined(args, g, d, log=lambda *a: None)
        got_g, got_d = res["state"]["g"], res["state"]["d"]
        jg, jd, jl = _jax_pipelined(args, netG, netD, gv, dv, 3)
        assert res["pipeline"]["steps"] == 3
    else:
        res = dcgan.train_imperative(args, g, d, log=lambda *a: None)
        optG, optD = res["optimizers"]
        got_g, got_d = dict(g.named_parameters()), dict(d.named_parameters())
        jg, jd, jl = _jax_imperative(args, netG, netD, gv, dv, 3)
    _compare(got_g, jg, start[0], bound, tight)
    _compare(got_d, jd, start[1], bound, tight)
    np.testing.assert_allclose(res["loss_d"], [x[0] for x in jl],
                               rtol=2e-3 if level == "O1" else 1e-5)
    np.testing.assert_allclose(res["loss_g"], [x[1] for x in jl],
                               rtol=2e-3 if level == "O1" else 1e-5)
    for net, before in zip((g, d), stats):      # statistics discarded
        for k, v in net.named_buffers():
            assert torch.equal(v, before[k]), k


def test_imperative_overflow_on_loss_one_skips_only_d():
    args = _args(opt_level="O1", **{"iters-per-epoch": 2})
    g, d = dcgan.build_models(args, "cpu")
    snap = {}

    def on_iter(i):
        if i == 1:
            snap["d"] = {k: v.clone() for k, v in d.named_parameters()}
            snap["g"] = {k: v.clone() for k, v in g.named_parameters()}
            return (1.0, float("inf"), 1.0)
        return None
    dcgan.train_imperative(args, g, d, log=lambda *a: None, on_iter=on_iter)
    sd = amp.state_dict()
    assert [sd[f"loss_scaler{i}"]["loss_scale"] for i in range(3)] == [
        2.0 ** 16, 2.0 ** 15, 2.0 ** 16]
    assert all(torch.equal(v, snap["d"][k])
               for k, v in d.named_parameters())
    assert not all(torch.equal(v, snap["g"][k])
                   for k, v in g.named_parameters())


@pytest.mark.parametrize("flag", [["--telemetry", "x.jsonl"],
                                  ["--checkpoint-dir", "ckpt"],
                                  ["--resume"], ["--metrics-port", "0"],
                                  ["--metrics-textfile", "m.prom"],
                                  ["--watchdog"]])
def test_trainer_refuses_what_is_not_ported(flag, tmp_path, monkeypatch,
                                            capsys):
    if flag[0] in ("--checkpoint-dir", "--resume"):
        # checkpointing is ported for the pipelined mode; --imperative
        # refuses it, as the JAX example does
        with pytest.raises(SystemExit, match="pipelined"):
            dcgan.main(["--device", "cpu", "--imperative"] + flag)
        return
    # the telemetry flags are ported: each runs, and closes its recorder
    monkeypatch.chdir(tmp_path)
    assert dcgan.main(["--device", "cpu", "--ngf", "8", "--ndf", "8",
                       "--batchSize", "4", "--iters-per-epoch", "2",
                       "--steps-per-call", "2"] + flag) == 0
    out = capsys.readouterr().out
    # the watchdog is on with --telemetry or --watchdog
    assert ("health: ok (0 alerts)" in out) == (
        flag[0] in ("--telemetry", "--watchdog"))
    if flag[0] == "--telemetry":
        assert os.path.exists(tmp_path / "x.jsonl")
    if flag[0] == "--metrics-textfile":
        assert os.path.exists(tmp_path / "m.prom")


def test_pipelined_resume_is_bit_for_bit(tmp_path, capsys):
    """The pipelined mode at K 2: 8 iterations with a checkpoint every 2,
    against 4 iterations, then ``--resume`` to 8 from a fresh process
    state: the whole GAN (both nets, both Adam states, the three
    scalers) bit for bit, in the returned state and in the final
    checkpoint; the resumed run prints the iteration it resumed at."""
    from apex_tpu_torch.checkpoint import load_checkpoint_dir
    base = ["--device", "cpu", "--ngf", "8", "--ndf", "8", "--batchSize",
            "2", "--data-pool", "3", "--steps-per-call", "2",
            "--checkpoint-every", "2", "--opt_level", "O1"]

    def run(ck, ipe, extra=()):
        args = dcgan.parse(base + ["--iters-per-epoch", str(ipe),
                                   "--checkpoint-dir", ck] + list(extra))
        netG, netD = dcgan.build_models(args, torch.device("cpu"))
        try:
            return dcgan.train_pipelined(args, netG, netD)
        finally:
            amp.shutdown()
    full = run(str(tmp_path / "a"), 8)
    part = run(str(tmp_path / "b"), 4)
    assert part["step"] == 4
    resumed = run(str(tmp_path / "b"), 8, ["--resume"])
    assert "resumed at iter 4" in capsys.readouterr().out
    assert resumed["step"] == full["step"] == 8 and resumed["iters"] == 4
    assert resumed["loss_d"] == full["loss_d"][4:]
    leaves = [torch.utils._pytree.tree_leaves(r["state"])
              for r in (full, resumed)]
    assert len(leaves[0]) == len(leaves[1]) > 100
    for a, b in zip(*leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for d in ("a", "b"):
        got = load_checkpoint_dir(str(tmp_path / d), full["state"])
        assert got.step == 8
        for a, b in zip(torch.utils._pytree.tree_leaves(got.state),
                        leaves[0]):
            assert torch.equal(a, b)


def test_trainer_cli_both_modes(capsys):
    base = ["--device", "cpu", "--ngf", "8", "--ndf", "8", "--batchSize",
            "2", "--iters-per-epoch", "2", "--data-pool", "1"]
    assert dcgan.main(base + ["--steps-per-call", "2"]) == 0
    assert dcgan.main(base + ["--imperative"]) == 0
    out = capsys.readouterr().out
    assert out.count("Loss_D") >= 3 and "done: 2 iters" in out
    assert torch.overrides._get_current_function_mode_stack() == []
