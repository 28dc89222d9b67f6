"""The port's memory ledger (``apex_tpu_torch.prof.memory``): the
walk's storages against hand-computed sizes (seven of JAX's
``tests/test_memory.py`` fail in the reference itself, so the port is
held to hand counts, as JAX's ``test_matmul_hand_computed_sizes``
holds JAX's), the fallback of ``xla`` on the CPU, region attribution
through the backward, the roofline join, the CLI, and
``record_memory`` of a harvest."""

import io
import json
import sys
import types

import numpy as np
import pytest
import torch

from apex_tpu_torch import telemetry
from apex_tpu_torch.prof import capture, memory, roofline

M, K, N = 128, 256, 64
A_BYTES = M * K * 4
B_BYTES = K * N * 4
OUT_BYTES = M * N * 4


@pytest.fixture(autouse=True)
def _clean_recorder():
    telemetry.set_recorder(None)
    yield
    telemetry.set_recorder(None)


def _mm(x, y):
    with capture.scope("mm"):
        return x @ y


def _mm_args():
    return torch.zeros(M, K), torch.zeros(K, N)


def test_matmul_hand_computed_sizes():
    h = memory.harvest_memory(_mm, *_mm_args())
    assert h.source == "walk"
    assert h.argument_bytes == A_BYTES + B_BYTES
    assert h.output_bytes == OUT_BYTES
    assert h.walk_peak_bytes == h.peak_bytes == A_BYTES + B_BYTES + OUT_BYTES
    assert h.temp_bytes == 0 and h.generated_code_bytes == 0
    assert h.by_region == {"mm": OUT_BYTES,
                           "<arguments>": A_BYTES + B_BYTES}


def test_top_allocations_ranked():
    h = memory.harvest_memory(_mm, *_mm_args())
    sizes = [a["bytes"] for a in h.top_allocations]
    assert sizes == sorted(sizes, reverse=True) == [A_BYTES, B_BYTES,
                                                   OUT_BYTES]
    assert {tuple(a["shape"]) for a in h.top_allocations} == {
        (M, K), (K, N), (M, N)}
    assert h.top_allocations[2]["region"] == "mm"


def test_chain_frees_dead_buffers():
    """y = relu(x @ w) @ v: the product dies after relu reads it, so the
    peak is the arguments, the product and its relu, below the sum of
    every buffer made."""
    def f(x, w, v):
        h1 = torch.relu(x @ w)
        return h1 @ v

    x, w, v = torch.zeros(64, 128), torch.zeros(128, 128), torch.zeros(128, 8)
    h = memory.harvest_memory(f, x, w, v)
    args = (64 * 128 + 128 * 128 + 128 * 8) * 4
    every = args + (64 * 128 * 2 + 64 * 8) * 4
    assert h.walk_peak_bytes == args + 2 * 64 * 128 * 4 < every
    assert h.output_bytes == 64 * 8 * 4


def test_python_scalar_outputs_survive_walk():
    def f(x):
        return x @ x, 1.0, torch.tensor(0.0)

    h = memory.harvest_memory(f, torch.zeros(32, 32))
    assert h.peak_bytes >= 2 * 32 * 32 * 4
    assert h.output_bytes == 32 * 32 * 4 + 4


def test_allocator_source_falls_back_to_the_walk_on_the_cpu():
    """``xla`` asks for the runtime's accounting: the allocator over one
    real call, on the card; with CPU tensors the walk (as JAX falls back
    where no memory_analysis exists)."""
    h = memory.harvest_memory(_mm, *_mm_args(), xla=True)
    assert h.source == "walk"
    assert h.peak_bytes == A_BYTES + B_BYTES + OUT_BYTES


def test_fwd_bwd_share_region():
    def grad(w, x):
        w = w.detach().requires_grad_(True)
        with capture.scope("mm"):
            y = x @ w
        return torch.autograd.grad((y * y).sum(), w)

    h = memory.harvest_memory(grad, torch.zeros(32, 16), torch.zeros(8, 32))
    assert "mm" in h.by_region
    assert not any(r.startswith("transpose") or "jvp" in r
                   for r in h.by_region)
    # the gradient of w is made by the backward of the scoped product
    assert h.by_region["mm"] >= 32 * 16 * 4


def test_the_walk_keeps_a_kernels_outputs_not_its_plain_temporaries():
    """A kernel allocates its outputs only: the walk does not count the
    temporaries of the plain version it runs in the kernel's place (here
    the softmax of [64, 1000] fp32 logits, 256000 bytes).  Hand count of
    the call's own storages: the int32 labels, the kernel's fp32 losses
    and max-log-sum-exp, the padding mask (bool), the 0.0 it selects
    and the masked fp32 losses."""
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
    x = torch.zeros(64, 1000)
    labels = torch.arange(64) % 7 + 1
    w = memory.live_buffer_walk(
        lambda x: softmax_cross_entropy_loss(x, labels, 0.1), x)
    assert w["argument_bytes"] == 64 * 1000 * 4 + 64 * 8
    assert w["peak_bytes"] - w["argument_bytes"] == \
        64 * 4 + 64 * 4 + 64 * 4 + 64 * 1 + 4 + 64 * 4
    assert w["output_bytes"] == 64 * 4


def test_stats_from_snapshot_keys_are_jaxs():
    snap = {"device_traces": [[{"action": "alloc", "size": 512},
                               {"action": "free_requested", "size": 512},
                               {"action": "alloc", "size": 1024}]]}
    st = memory.stats_from_snapshot(snap, peak_bytes=4096,
                                    argument_bytes=2048, output_bytes=1024,
                                    requested_bytes=2000)
    # the history replayed: 2000 live, +512, -512, +1024
    assert st == {"argument_bytes": 2048, "output_bytes": 1024,
                  "temp_bytes": 1024, "generated_code_bytes": 0,
                  "alias_bytes": 0, "peak_bytes": 4096, "allocations": 2,
                  "requested_peak_bytes": 3024}
    assert memory.stats_from_snapshot({}, peak_bytes=0, argument_bytes=0,
                                      output_bytes=0) is None


def test_mfu_ledger_memory_column():
    h_cost = roofline.harvest_costs(_mm, *_mm_args(), xla=False)
    h_mem = memory.harvest_memory(_mm, *_mm_args())
    led = roofline.mfu_ledger(h_cost, step_time_s=1e-3,
                              peaks={"flops": 1e12, "hbm_gb_s": 100.0},
                              memory=h_mem)
    assert led["total"]["peak_hbm_gb"] == round(h_mem.peak_bytes / 1e9, 6)
    assert led["memory"]["source"] == "walk"
    assert led["memory"]["top_allocations"]
    mm = [r for r in led["regions"] if r["region"] == "mm"]
    assert mm and mm[0]["peak_hbm_mb"] == round(OUT_BYTES / 1e6, 3)
    assert "peak HBM" in roofline.format_ledger(led)


def test_mfu_ledger_without_memory_unchanged():
    h_cost = roofline.harvest_costs(_mm, *_mm_args(), xla=False)
    led = roofline.mfu_ledger(h_cost,
                              peaks={"flops": 1e12, "hbm_gb_s": 100.0})
    assert "memory" not in led and "peak_hbm_gb" not in led["total"]


def test_record_memory_takes_a_harvest():
    buf = io.StringIO()
    rec = telemetry.Recorder(buf)
    h = memory.harvest_memory(_mm, *_mm_args())
    ev = memory.record_memory(rec, h, limit_bytes=10 * h.peak_bytes)
    rec.close()
    assert ev["peak_bytes"] == h.peak_bytes and ev["source"] == "walk"
    assert ev["headroom_pct"] == 90.0
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    mem = [e for e in events if e["kind"] == "memory"]
    assert mem and mem[0]["argument_bytes"] == A_BYTES + B_BYTES
    assert memory.record_memory(None, h) is None


def test_cli_json(capsys, monkeypatch):
    mod = types.ModuleType("_torch_memtarget")
    mod.entry = lambda: (_mm, _mm_args())
    monkeypatch.setitem(sys.modules, "_torch_memtarget", mod)
    assert memory.main(["--fn", "_torch_memtarget:entry", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["argument_bytes"] == A_BYTES + B_BYTES
    assert out["by_region"]["mm"] == OUT_BYTES
    assert memory.main(["--fn", "_torch_memtarget:entry"]) == 0
    assert "memory ledger (walk)" in capsys.readouterr().out


def test_trainer_step_walk_attributes_regions():
    """The LM trainer's O2 step at a tiny size: the walk's arguments are
    the state and batch, and the storages live at the peak belong to
    the step's scopes (storages, counted once however many tensors view
    them)."""
    from apex_tpu_torch.examples.lm import main_amp
    state, step, batch = main_amp.build(main_amp.parse(
        ["--synthetic", "--device", "cpu", "--vocab", "128", "--hidden",
         "64", "--layers", "2", "--heads", "4", "--seq-len", "33", "-b",
         "4"]))
    h = memory.harvest_memory(step, state, batch)
    storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in torch.utils._pytree.tree_leaves((state, batch))
                if isinstance(t, torch.Tensor)}
    state_bytes = sum(storages.values())     # x and y view one storage
    assert h.argument_bytes == state_bytes
    assert h.peak_bytes > h.argument_bytes
    assert set(h.by_region) & {"block_0", "block_1", "head", "loss", "cast",
                               "optimizer"}
    np.testing.assert_array_less(0, h.output_bytes)
