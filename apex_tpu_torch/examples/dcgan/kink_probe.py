"""Where the DCGAN's fp32 gradients part between two devices.

Builds the port's DCGAN pair at the reference example's widths (batch 64,
nz 100, ngf/ndf 64, O0), takes one trainer iteration on the CPU, and
then, for the initial discriminator and the one after that iteration,
computes G's loss through D on the same fakes in fp32 on the card, in
fp32 on the CPU, and in fp64 on the CPU.  For each fp32 device it prints
how many of D's leaky-ReLU pre-activations take the other sign than in
fp64 (and how close to 0 they were), how far the gradient with respect
to the fakes lies from fp64's (largest error over largest value, and the
relative L2 error), and how far G's parameter gradients lie from fp64's
(largest error over the net's largest gradient).

    python -m apex_tpu_torch.examples.dcgan.kink_probe   # one CUDA device
    python -m apex_tpu_torch.examples.dcgan.kink_probe --deterministic \
        --repeats 5

``--repeats N`` computes every gradient N times and prints, for each, G's
gradients on the card against the CPU's (largest error over the largest
gradient: the quantity of ``chip_smoke.py`` phase 23's initial-gradient
gate); ``--deterministic`` runs the card under torch's deterministic
algorithms (the ImageNet trainer's ``--deterministic``: cuDNN's
deterministic kernels, cuBLAS's fixed workspace).
"""

import argparse
import os
import sys

import torch
import torch.nn.functional as F

from ...models import dcgan as models
from . import main_amp as dcgan

WIDTHS = ["--batchSize", "64", "--nz", "100", "--ngf", "64", "--ndf", "64",
          "--opt_level", "O0", "--data-pool", "1"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--repeats", type=int, default=1)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kink_probe: no CUDA device is available",
              file=sys.stderr)
        return 2
    if opts.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = dcgan.parse(WIDTHS)
    netG, netD = dcgan.build_models(args, "cpu")
    state, step_fn = dcgan.build_pipelined(args, netG, netD)
    real, noise = dcgan.synthetic_pool(args, "cpu")[0]
    new, _ = step_fn(state, (real, noise))
    casts = {"cuda": lambda t: t.to("cuda"), "cpu": lambda t: t,
             "fp64": lambda t: t.double()}
    nets = {}
    for d in casts:
        g, dn = dcgan.build_models(args, "cuda" if d == "cuda" else "cpu")
        nets[d] = (g.double(), dn.double()) if d == "fp64" else (g, dn)
    seen = []
    leaky = F.leaky_relu

    def spy(x, *a, **k):
        seen.append(x.detach().double().cpu())
        return leaky(x, *a, **k)
    models.F.leaky_relu = spy

    def run(d_params, d):
        cast = casts[d]
        g_net, d_net = nets[d]
        gp = {k: cast(v).requires_grad_(True) for k, v in state["g"].items()}
        fake = dcgan._forward(g_net, gp, cast(noise))
        leaf = fake.detach().requires_grad_(True)
        seen.clear()
        loss = dcgan.bce_with_logits(dcgan._forward(
            d_net, {k: cast(v) for k, v in d_params.items()}, leaf), 1.0)
        d_fake, = torch.autograd.grad(loss, [leaf])
        grads = torch.autograd.grad(fake, list(gp.values()), d_fake)
        return (d_fake.double().cpu(), [g.double().cpu() for g in grads],
                list(seen))
    try:
        for rep_i, (name, d_params) in (
                (i, nd) for i in range(opts.repeats)
                for nd in (("initial D", state["d"]),
                           ("D after one iteration", new["d"]))):
            ref, ref_g, ref_pre = run(d_params, "fp64")
            big = max(g.abs().max().item() for g in ref_g)
            grads_of = {}
            for d in ("cuda", "cpu"):
                got, got_g, pre = run(d_params, d)
                grads_of[d] = got_g
                flips = [int(((a > 0) != (b > 0)).sum())
                         for a, b in zip(pre, ref_pre)]
                near = max([a[(a > 0) != (b > 0)].abs().max().item()
                            for a, b, f in zip(pre, ref_pre, flips) if f]
                           or [0.0])
                err = (got - ref).abs()
                g_err = max((a - b).abs().max().item()
                            for a, b in zip(got_g, ref_g)) / big
                print(f"{name}, {d} fp32 vs fp64: leaky-ReLU sign flips "
                      f"per layer {flips} of "
                      f"{[p.numel() for p in pre]} (|pre-activation| at "
                      f"a flip <= {near:.3g}); d loss / d fake largest "
                      f"error {err.max().item() / ref.abs().max().item():.3g}"
                      f" of its largest, relative L2 "
                      f"{err.norm().item() / ref.norm().item():.3g}; G's "
                      f"gradients largest error {g_err:.3g} of the "
                      f"largest", flush=True)
            card_cpu = max((a - b).abs().max().item() for a, b in zip(
                grads_of["cuda"], grads_of["cpu"])) / max(
                g.abs().max().item() for g in grads_of["cpu"])
            print(f"{name}, repeat {rep_i}: G's gradients card vs CPU "
                  f"largest error {card_cpu:.3g} of the largest"
                  f"{' (deterministic)' if opts.deterministic else ''}",
                  flush=True)
    finally:
        models.F.leaky_relu = leaky
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
