"""The port's kernels against their plain versions, on the card.

Imports neither JAX nor the test conftest's JAX set-up, so it runs on a
GPU host without JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Every test is marked ``cuda`` and skips (inside its fixture) where no
CUDA device is visible.
"""

import importlib

import numpy as np
import pytest
import torch

# the packages re-export the functions under the modules' names
fln = importlib.import_module("apex_tpu_torch.normalization.fused_layer_norm")
fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows", [1024, 8])
def test_layer_norm_kernel_matches_plain(cuda_device, dtype, atol, rows):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(rows, 768).astype(np.float32)).to(
        cuda_device, dtype)
    w = torch.from_numpy(1 + 0.1 * rng.randn(768).astype(np.float32)).to(
        cuda_device)
    b = torch.from_numpy(0.1 * rng.randn(768).astype(np.float32)).to(
        cuda_device)
    before = fln.layer_norm_fwd_kernel.launches
    got = fln.layer_norm_fwd_kernel(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert fln.layer_norm_fwd_kernel.launches == before + 1
    want = fln._fwd_ref(x, w, b, 1e-5)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g.float(), wnt.float(), atol=atol,
                                   rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal", "bias", "decode", "gqa",
                                  "window"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(cuda_device, case, dtype, atol):
    """Ragged lengths (200 is no multiple of the 64-key tile), all three
    query-block sizes (q_len 200 and 1), GQA, window and both biases."""
    tq = 1 if case == "decode" else 200
    h_kv = 2 if case == "gqa" else 4
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(2, n, hh, 64).astype(np.float32))
               .to(cuda_device, dtype)
               for n, hh in ((tq, 4), (200, h_kv), (200, h_kv)))
    kw = dict(sm_scale=0.125, causal=case != "bias", q_offset=200 - tq,
              window=64 if case == "window" else None)
    bias = kb = None
    if case == "bias":
        bias = torch.randn(2, tq, 200, device=cuda_device)
    if case == "decode":
        kb = torch.where(torch.arange(200, device=cuda_device) < 150,
                         0.0, -1e9)[None].expand(2, 200)
    before = fa.flash_fwd_kernel.launches
    out, lse = fa.flash_fwd_kernel(q, k, v, kb, bias, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd_kernel.launches == before + 1
    want_out, want_lse = fa._flash_fwd_ref(q, k, v, kb, bias, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_calls_needing_grad_raise(cuda_device):
    x = torch.randn(4, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        fln.fused_layer_norm(x, 64)
    q = torch.randn(1, 8, 2, 32, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention(q, q, q, causal=True)
    with pytest.raises(NotImplementedError, match="per-head"):
        fa.flash_attention(q.detach(), q.detach(), q.detach(),
                           bias=torch.zeros(1, 2, 8, 8, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 128])
@pytest.mark.parametrize("tq", [1, 20, 70])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_flash_kernel_head_dims(cuda_device, head_dim, tq, dtype, atol):
    """The other two head-dim instantiations, causal with suffix
    alignment, at a decode length and at ragged lengths for each of the
    three query-block sizes."""
    rng = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rng.randn(3, n, 4, head_dim)
                                .astype(np.float32)).to(cuda_device, dtype)
               for n in (tq, 130, 130))
    kw = dict(sm_scale=head_dim ** -0.5, causal=True, q_offset=130 - tq)
    out, lse = fa.flash_fwd_kernel(q, k, v, None, None, **kw)
    want_out, want_lse = fa._flash_fwd_ref(q, k, v, None, None, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
