"""The port's bytes ledger (``apex_tpu_torch.prof.ledger``) against the
JAX package's on the same inputs: the intrinsic products' operand and
output bytes, the optimizer term, the forward-to-backward bridge (a
distant consumer spills, a product operand does not), the shape
signature, per-stage grouping, and the measured side over a parsed
trace."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.prof import ledger as jledger
from apex_tpu_torch.ops import conv2d
from apex_tpu_torch.prof import ledger
from apex_tpu_torch.prof.parse import KernelRecord, TraceProfile


def test_intrinsic_counts_dot_operands_and_outputs():
    a = np.zeros((128, 256), np.float32)
    b = np.zeros((256, 512), np.float32)
    want = jledger.intrinsic_ledger(lambda x, y: x @ y,
                                    jnp.asarray(a, jnp.bfloat16),
                                    jnp.asarray(b, jnp.bfloat16))
    led = ledger.intrinsic_ledger(
        lambda x, y: x @ y, torch.from_numpy(a).bfloat16(),
        torch.from_numpy(b).bfloat16())
    gb = (128 * 256 + 256 * 512 + 128 * 512) * 2 / 1e9
    assert led["compute_gb"] == want["compute_gb"] == round(gb, 3)
    assert led["optimizer_gb"] == want["optimizer_gb"] == 0.0
    assert led["by_layer"][0]["gflops"] == want["by_layer"][0]["gflops"]


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_intrinsic_optimizer_term(optimizer):
    led = ledger.intrinsic_ledger(lambda x: x @ x,
                                  torch.zeros(8, 8, dtype=torch.bfloat16),
                                  n_params=1000, optimizer=optimizer)
    want = jledger.intrinsic_ledger(lambda x: x @ x,
                                    jnp.zeros((8, 8), jnp.bfloat16),
                                    n_params=1000, optimizer=optimizer)
    assert led["optimizer_gb"] == want["optimizer_gb"]
    assert led["optimizer_model"] == want["optimizer_model"]


def test_bridge_detects_distant_consumer():
    """y is made by the first op and read ~200 elementwise ops later: it
    spills (one write, one read); the chain itself does not."""
    def tf(x):
        y = torch.sin(x)
        z = y
        for _ in range(200):
            z = z + 1.0
        return z + y

    def jf(x):
        y = jnp.sin(x)
        z = y
        for _ in range(200):
            z = z + 1.0
        return z + y

    b = ledger._bridge_bytes(tf, torch.zeros(256, 256), gap=100)
    want = jledger._bridge_bytes(jf, jnp.zeros((256, 256)), gap=100)
    assert b["gb"] == want["gb"] == round(256 * 256 * 4 * 2 / 1e9, 3)
    assert b["gap_eqns"] == 100


def test_bridge_excludes_conv_operands():
    def tf(x):
        y = torch.sin(x)
        z = y
        for _ in range(200):
            z = z + 1.0
        return z @ y

    b = ledger._bridge_bytes(tf, torch.zeros(128, 128), gap=100)
    assert b["gb"] == 0.0


def test_spatial_sig_picks_largest_nhwc():
    ln = ("%f = (f32[64]{0}, bf16[128,56,56,64]{...}) fusion("
          "bf16[128,112,112,3]{...} %p0, bf16[7,7,3,64]{...} %p1)")
    assert ledger._spatial_sig(ln) == jledger._spatial_sig(ln) == "hw56"
    assert ledger._spatial_sig("%a = f32[8]{0} add(...)") == "other"
    # the port's form: the launching op's recorded input shapes
    assert ledger._spatial_sig([(128, 112, 112, 3), (128, 56, 56, 64),
                                (7, 7, 3, 64)]) == "hw56"
    assert ledger._spatial_sig([(8,), ()]) == "other"


def test_intrinsic_by_shape_groups_convs():
    """The port's NHWC conv (its kernel's entry point: one conv_fwd
    record by its formula) groups at its spatial stage, as JAX's lax
    conv does."""
    x = torch.zeros(2, 16, 16, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 8, 8, dtype=torch.bfloat16)
    rows = ledger.intrinsic_by_shape(lambda x, w: conv2d(x, w), x, w)
    want = jledger.intrinsic_by_shape(
        lambda x, w: jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO",
                                                     "NHWC")),
        jnp.zeros((2, 16, 16, 8), jnp.bfloat16),
        jnp.zeros((3, 3, 8, 8), jnp.bfloat16))
    assert rows == want
    assert rows["hw16"]["count"] == 1


def _trace():
    recs = []
    for i, (name, cat, us, shapes) in enumerate((
            ("conv_gemm_kernel<0>", "conv_fwd_kernel", 40.0,
             ((2, 16, 16, 8), (3, 3, 8, 8))),
            ("conv_gemm_kernel<2>", "conv_wgrad_kernel", 60.0,
             ((2, 16, 16, 8), (2, 16, 16, 8))),
            ("bn_fwd", "bn_epilogue", 10.0, ()),
            ("elementwise_kernel", "other", 5.0, ((2, 8, 8, 8),)))):
        recs.append(KernelRecord(
            name=name, base_op=name, hlo_module="stage1", duration_us=us,
            start_us=float(i), run_id="ProfilerStep#1", device="0",
            category=cat, long_name=name, input_shapes=shapes))
    return TraceProfile(recs)


def test_measured_ledger_and_by_shape():
    tp = _trace()
    meas = ledger.measured_ledger(tp, steps=1)
    assert list(meas["by_category"]) == ["conv_wgrad_kernel",
                                         "conv_fwd_kernel", "bn_epilogue",
                                         "other"]
    assert meas["by_category"]["conv_fwd_kernel"]["us"] == 40.0
    assert meas["top_fusions_by_bytes"][0]["op"] == "conv_gemm_kernel<2>"
    rows = ledger.measured_by_shape(tp)
    assert rows == {"hw16": {"us": 100.0, "gb": 0.0, "count": 2}}
    json.dumps(meas)


def test_bytes_ledger_joins_measured_and_intrinsic():
    # large enough for GB at 4 decimals; the walk allocates nothing
    x = torch.zeros(8, 16, 16, 128, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 128, 128, dtype=torch.bfloat16)
    out = ledger.bytes_ledger(lambda x, w: conv2d(x, w), (x, w), _trace(),
                              n_params=w.numel())
    assert out["intrinsic"]["compute_gb"] >= 0
    assert out["measured"]["by_category"]["conv_fwd_kernel"]["us"] == 40.0
    stages = {r["stage"]: r for r in out["by_stage_joined"]}
    assert stages["hw16"]["fusions"] == 2 and "intrinsic_gb" in stages["hw16"]


def test_loader_ledger_equals_jax():
    stats = {"elapsed_s": 10.0, "producer_stall_s": 1.5, "stage_s": 2.0,
             "staged": 40, "batches": 38, "loader_stall_pct": 3.0}
    assert ledger.loader_ledger(stats, bytes_per_batch=1e8) \
        == jledger.loader_ledger(stats, bytes_per_batch=1e8)
    assert ledger.loader_ledger({}) == jledger.loader_ledger({})


def test_compute_ops_hold_the_product_kernels():
    for name in ("mm", "bmm", "addmm", "convolution", "flash_attention_fwd",
                 "flash_attention_bwd_dq", "conv_wgrad", "qmm"):
        assert name in ledger.COMPUTE_OPS
    for name in ("layer_norm_fwd", "xentropy_fwd", "bn_act_bwd", "add"):
        assert name not in ledger.COMPUTE_OPS
