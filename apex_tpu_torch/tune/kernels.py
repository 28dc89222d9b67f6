"""The six builtin specs: each tunable kernel family's tiles on the card.

Counterpart of ``apex_tpu/tune/kernels.py``, with the card's knobs in
place of the TPU's block sizes (none of the TPU's defaults, budgets or
example shapes carries over).  Each ``example_shape`` is the family's
main-path shape on the H100 (the port's kernel table); each default is
the rule the kernels run today for the shape, so it is always a
candidate; each case runs the family's kernels forward and backward
(where they have a backward) with the tile named: flash and conv through
their public functions (their backward kernels run under autograd), LN,
BN and xentropy through their kernel wrappers (their public backward adds
plain column sums no tile touches, which would hide the kernels' time),
qmm its one kernel (its backward is the plain straight-through matmuls).
Off the card (``interpret``) each runs its plain versions on the CPU.

* **flash_attention** — ``block_q``/``block_k``: the tensor-core
  forward's tile (64 x 64 by the rule; 64 x 32, 64 x 128, 128 x 64, 128
  x 128 at widths 64 and 128), and on the split-KV decode path the chunk
  of keys a block reads.  Not exact: the online softmax's sums reorder
  with the tile; tolerance phase 4's bf16 gate, 2e-2.
* **conv2d** — ``block_m`` (128, the one instantiation) / ``block_n``
  (64 or 128) of the implicit-GEMM tile, for forward, dgrad and wgrad.
  Exact: the width moves which block computes an output, not its K sum;
  both widths of a bucket run its forward's route (``_fwd_route``: the
  wgmma kernel for bf16/fp16 with C a multiple of 64).
* **fused_layer_norm** — ``row_block``: rows a program handles, one
  after another.  Exact: each row's arithmetic is unchanged.
* **bn_relu_residual** — ``row_block``: the rows of a program's tile.
  Exact: elementwise.
* **xentropy** — ``col_block``/``num_warps``: the chunk of a row a
  program holds and its warps.  Not exact: both reorder the forward's
  row reductions; tolerance phase 12's, 1e-4 on the losses and ``mlse``
  and 1e-5 on ``dx``.
* **quantized_matmul** — ``block_m``/``block_n``: one of the tiles of
  ``csrc/quant_sm90.cu`` (the wgmma kernel of M > 64) or ``csrc/quant.cu``
  (the decode tiles; ``quant.kernels.tiles``).  Exact: int32 sums at any
  tile, route and K split.

Candidate priority (the ledger hook): a memory-bound verdict visits
small tiles first, a compute-bound one big tiles first, as in JAX.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from . import space as _space
from .registry import KernelSpec, TuneCase, register

__all__ = ["FLASH_ATTENTION", "FUSED_LAYER_NORM", "BN_RELU_RESIDUAL",
           "XENTROPY", "QUANTIZED_MATMUL", "CONV2D"]

#: the H100's multiprocessors (its data sheet): the rules' wave counts
#: off the card
_H100_SMS = 132


def _mod(name):
    # the packages re-export their functions under the modules' names
    return importlib.import_module("apex_tpu_torch." + name)


def _dtype(shape: Mapping, default: str) -> torch.dtype:
    return getattr(torch, str(shape.get("dtype", default)))


def _device(interpret: bool) -> torch.device:
    return torch.device("cpu" if interpret else "cuda")


def _sms() -> int:
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    return _H100_SMS


def _randn(rs, shape, dtype, device, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(
        np.float32)).to(device, dtype)


def _area_priority(area: float, bound: Optional[str]) -> float:
    # ascending visit order: memory-bound -> small tiles first,
    # compute-bound (and None) -> big tiles first
    return area if bound == "memory" else -area


def _grads(loss, inputs):
    return tuple(g.detach() for g in torch.autograd.grad(loss, inputs))


# -- flash attention ------------------------------------------------------------

def _flash_dims(shape: Mapping):
    return (int(shape.get("batch", 1)), int(shape.get("heads", 2)),
            int(shape.get("q_len", 1024)), int(shape.get("kv_len", 1024)),
            int(shape.get("head_dim", 64)), bool(shape.get("causal", True)),
            _dtype(shape, "bfloat16"))


def _flash_decode(shape: Mapping) -> bool:
    return _flash_dims(shape)[2] < _mod("ops.flash_attention")._SPLIT_TQ


def _flash_defaults(shape: Mapping) -> Dict[str, int]:
    # the rule: the wgmma kernel's tile at widths 64 and 128 in bf16 and
    # fp16 (fa.rule_tile), the split-KV chunk on decode
    fa = _mod("ops.flash_attention")
    b, h, tq, tk, d, _, dtype = _flash_dims(shape)
    if tq < fa._SPLIT_TQ:
        return {"block_q": fa._RULE_TILE[0],
                "block_k": fa._kv_split(b, h, tk, _sms())[1]}
    bq, bk = fa.rule_tile(d, dtype)
    return {"block_q": bq, "block_k": bk}


def _flash_candidates(shape: Mapping, bound: Optional[str]
                      ) -> List[Dict[str, int]]:
    fa = _mod("ops.flash_attention")
    _, _, tq, tk, d, _, dtype = _flash_dims(shape)
    if tq < fa._SPLIT_TQ:
        chunks = sorted({c for c in (32, 64, 96, 128, 192, 256, 384, 512)
                         if c <= max(32, tk)})
        return [{"block_q": fa._RULE_TILE[0], "block_k": c} for c in chunks]
    return [{"block_q": bq, "block_k": bk} for bq, bk in fa.tiles(d, dtype)]


def _flash_fits(shape: Mapping, cfg: Dict[str, int]) -> bool:
    # the kernel's own check on the card; off it (interpret) no kernel
    # runs and every candidate stands
    if not torch.cuda.is_available():
        return True
    _, _, tq, _, d, _, dtype = _flash_dims(shape)
    return _mod("ops.flash_attention").tile_fits(
        tq, d, dtype, (int(cfg["block_q"]), int(cfg["block_k"])),
        bool(shape.get("bias", False)))


def _flash_case(shape: Mapping, interpret: bool) -> TuneCase:
    flash_attention = _mod("ops.flash_attention").flash_attention
    b, h, tq, tk, d, causal, dtype = _flash_dims(shape)
    dev = _device(interpret)
    rs = np.random.RandomState(0)
    q, k, v = (_randn(rs, (b, t, h, d), dtype, dev, 0.5).requires_grad_()
               for t in (tq, tk, tk))

    def run(cfg):
        out = flash_attention(q, k, v, causal=causal,
                              block_q=int(cfg["block_q"]),
                              block_k=int(cfg["block_k"]))
        loss = (out.float() ** 2).sum()
        return (out.detach(),) + _grads(loss, (q, k, v))

    return TuneCase(run=run, tol=(0.0, 2e-2))


def _flash_bucket(shape: Mapping) -> str:
    _, _, tq, tk, d, causal, _ = _flash_dims(shape)
    return _mod("ops.flash_attention").tune_bucket(
        tq, tk, d, causal, bool(shape.get("bias", False)), False)


def _flash_effective(shape: Mapping, cfg: Dict[str, int]):
    if _flash_decode(shape):
        return ("chunk", int(cfg["block_k"]))
    return (int(cfg["block_q"]), int(cfg["block_k"]))


FLASH_ATTENTION = register(KernelSpec(
    name="flash_attention",
    version=_mod("ops.flash_attention").TUNE_VERSION,
    params=("block_q", "block_k"), kind="compute", exact=False,
    defaults=_flash_defaults, candidates=_flash_candidates,
    constraint=_flash_fits, build=_flash_case, bucket=_flash_bucket,
    priority=lambda shape, cfg, bound: _area_priority(
        cfg["block_q"] * cfg["block_k"], bound),
    effective=_flash_effective,
    example_shape={"batch": 8, "heads": 12, "q_len": 1023, "kv_len": 1023,
                   "head_dim": 64, "causal": True, "dtype": "bfloat16"},
    small_shape={"batch": 1, "heads": 2, "q_len": 200, "kv_len": 200,
                 "head_dim": 64, "causal": True, "dtype": "bfloat16"},
    regions=("attention", "flash", "attn")))


# -- LayerNorm ------------------------------------------------------------------

def _ln_dims(shape: Mapping):
    return (int(shape.get("n1", 8184)), int(shape.get("n2", 768)),
            _dtype(shape, "bfloat16"))


def _ln_candidates(shape: Mapping, bound: Optional[str]):
    n1, _, _ = _ln_dims(shape)
    fln = _mod("normalization.fused_layer_norm")
    out, seen = [], set()
    for blk in (1, 2, 4, 8, 16, 32, 64):
        eff = fln.rows_per_program(n1, blk)
        if eff not in seen:
            seen.add(eff)
            out.append({"row_block": blk})
    return out


def _ln_constraint(shape: Mapping, cfg: Dict[str, int]) -> bool:
    _, n2, _ = _ln_dims(shape)
    block = 1 << max(0, n2 - 1).bit_length()
    return 1 <= cfg["row_block"] <= 64 and block <= _space.TRITON_MAX_NUMEL


def _ln_case(shape: Mapping, interpret: bool) -> TuneCase:
    fln = _mod("normalization.fused_layer_norm")
    n1, n2, dtype = _ln_dims(shape)
    dev = _device(interpret)
    rs = np.random.RandomState(0)
    x, g = (_randn(rs, (n1, n2), dtype, dev) for _ in range(2))
    w = torch.linspace(0.5, 1.5, n2, device=dev)
    b = torch.linspace(-0.1, 0.1, n2, device=dev)

    def run(cfg):
        if interpret:
            out, mean, invvar = fln._fwd_ref(x, w, b, 1e-5)
            return out, mean, invvar, fln._bwd_input_ref(g, x, mean,
                                                         invvar, w)
        rb = int(cfg["row_block"])
        out, mean, invvar = fln.layer_norm_fwd_kernel(x, w, b, 1e-5, rb)
        return out, mean, invvar, fln.layer_norm_bwd_kernel(
            g, x, mean, invvar, w, rb)

    return TuneCase(run=run)


def _ln_bucket(shape: Mapping) -> str:
    n1, n2, dtype = _ln_dims(shape)
    return _mod("normalization.fused_layer_norm").tune_bucket(
        n1, n2, torch.tensor([], dtype=dtype).element_size())


FUSED_LAYER_NORM = register(KernelSpec(
    name="fused_layer_norm",
    version=_mod("normalization.fused_layer_norm").TUNE_VERSION,
    params=("row_block",), kind="memory", exact=True,
    defaults=lambda shape: {"row_block": 1},
    candidates=_ln_candidates, constraint=_ln_constraint,
    build=_ln_case, bucket=_ln_bucket,
    priority=lambda shape, cfg, bound: _area_priority(cfg["row_block"],
                                                      bound),
    effective=lambda shape, cfg: _mod(
        "normalization.fused_layer_norm").rows_per_program(
            _ln_dims(shape)[0], cfg["row_block"]),
    example_shape={"n1": 8184, "n2": 768, "dtype": "bfloat16"},
    small_shape={"n1": 64, "n2": 128, "dtype": "float32"},
    regions=("layer_norm", "layernorm", "ln")))


# -- the BN epilogue --------------------------------------------------------------

def _bn_dims(shape: Mapping):
    return (int(shape.get("rows", 401408)), int(shape.get("channels", 256)),
            bool(shape.get("residual", True)), _dtype(shape, "bfloat16"))


def _bn_block_c(c: int) -> int:
    return min(128, 1 << max(0, c - 1).bit_length())


def _bn_effective(shape: Mapping, cfg: Dict[str, int]):
    fba = _mod("normalization.fused_bn_act")
    rows, c, _, _ = _bn_dims(shape)
    return fba._grid(rows, c, int(cfg["row_block"]))[1]


def _bn_candidates(shape: Mapping, bound: Optional[str]):
    fba = _mod("normalization.fused_bn_act")
    rows, c, _, _ = _bn_dims(shape)
    blocks = _space.row_block_candidates(
        rows, _bn_block_c(c), fba._TILE_BYTES_PER_ELEM,
        blocks=(8, 16, 32, 64, 128, 256, 512))
    return [{"row_block": b} for b in blocks]


def _bn_constraint(shape: Mapping, cfg: Dict[str, int]) -> bool:
    fba = _mod("normalization.fused_bn_act")
    rows, c, _, _ = _bn_dims(shape)
    rb = int(cfg["row_block"])
    return _space.tile_fits(rb, _bn_block_c(c), fba._TILE_BYTES_PER_ELEM) \
        and rb == _bn_effective(shape, cfg)


def _bn_case(shape: Mapping, interpret: bool) -> TuneCase:
    fba = _mod("normalization.fused_bn_act")
    rows, c, has_z, dtype = _bn_dims(shape)
    dev = _device(interpret)
    rs = np.random.RandomState(0)
    x, g = (_randn(rs, (rows, c), dtype, dev) for _ in range(2))
    z = _randn(rs, (rows, c), dtype, dev) if has_z else None
    vecs = [torch.linspace(lo, hi, c, device=dev)
            for lo, hi in ((-0.2, 0.2), (0.8, 1.2), (0.5, 1.5),
                           (-0.1, 0.1))]

    def run(cfg):
        if interpret:
            return (fba._fwd_ref(x, *vecs, z, True),
                    *fba._bwd_act_ref(g, x, *vecs, z, True))
        rb = int(cfg["row_block"])
        return (fba.bn_act_fwd_kernel(x, *vecs, z, True, rb),
                *fba.bn_act_bwd_kernel(g, x, *vecs, z, True, rb))

    return TuneCase(run=run)


def _bn_bucket(shape: Mapping) -> str:
    rows, c, has_z, dtype = _bn_dims(shape)
    return _mod("normalization.fused_bn_act").tune_bucket(
        rows, c, torch.tensor([], dtype=dtype).element_size(), has_z)


BN_RELU_RESIDUAL = register(KernelSpec(
    name="bn_relu_residual",
    version=_mod("normalization.fused_bn_act").TUNE_VERSION,
    params=("row_block",), kind="memory", exact=True,
    defaults=lambda shape: {
        "row_block": 8192 // _bn_block_c(_bn_dims(shape)[1])},
    candidates=_bn_candidates, constraint=_bn_constraint,
    build=_bn_case, bucket=_bn_bucket,
    priority=lambda shape, cfg, bound: _area_priority(cfg["row_block"],
                                                      bound),
    effective=_bn_effective,
    example_shape={"rows": 401408, "channels": 256, "residual": True,
                   "dtype": "bfloat16"},
    small_shape={"rows": 640, "channels": 128, "residual": True,
                 "dtype": "float32"},
    regions=("bn", "batchnorm", "stage", "downsample")))


# -- softmax cross-entropy ---------------------------------------------------------

def _xe_dims(shape: Mapping):
    return (int(shape.get("rows", 8184)), int(shape.get("vocab", 50257)),
            _dtype(shape, "float32"))


def _xe_candidates(shape: Mapping, bound: Optional[str]):
    xe = _mod("contrib.xentropy")
    _, v, _ = _xe_dims(shape)
    return [{"col_block": blk, "num_warps": w}
            for blk in (512, 1024, 2048, 4096, 8192, 16384)
            for w in (4, 8, 16) if xe.config_legal(v, blk, w)]


def _xe_case(shape: Mapping, interpret: bool) -> TuneCase:
    xe = _mod("contrib.xentropy")
    n, v, dtype = _xe_dims(shape)
    dev = _device(interpret)
    rs = np.random.RandomState(0)
    logits = _randn(rs, (n, v), dtype, dev, 2.0)
    labels = torch.from_numpy(rs.randint(1, v, n).astype(np.int32)).to(dev)
    g = torch.linspace(0.5, 1.5, n, device=dev)

    def run(cfg):
        conf = (int(cfg["col_block"]), int(cfg["num_warps"]))
        if interpret:
            losses, mlse = xe._fwd_ref(logits, labels, 0.1)
            dx = xe._bwd_ref(g, logits, mlse, labels, 0.1)
        else:
            losses, mlse = xe.xentropy_fwd_kernel(logits, labels, 0.1, conf)
            dx = xe.xentropy_bwd_kernel(g, logits, mlse, labels, 0.1, conf)
        return losses, mlse, dx

    return TuneCase(run=run, tol=[(0.0, 1e-4), (0.0, 1e-4), (0.0, 1e-5)])


XENTROPY = register(KernelSpec(
    name="xentropy", version=_mod("contrib.xentropy").TUNE_VERSION,
    params=("col_block", "num_warps"), kind="memory", exact=False,
    defaults=lambda shape: dict(zip(
        ("col_block", "num_warps"),
        _mod("contrib.xentropy").rule_config(_xe_dims(shape)[1]))),
    candidates=_xe_candidates,
    constraint=lambda shape, cfg: _mod("contrib.xentropy").config_legal(
        _xe_dims(shape)[1], int(cfg["col_block"]), int(cfg["num_warps"])),
    build=_xe_case,
    bucket=lambda shape: _mod("contrib.xentropy").tune_bucket(
        *_xe_dims(shape)[:2]),
    priority=lambda shape, cfg, bound: _area_priority(
        cfg["col_block"] * cfg["num_warps"], bound),
    example_shape={"rows": 8184, "vocab": 50257, "dtype": "float32"},
    small_shape={"rows": 32, "vocab": 1000, "dtype": "float32"},
    regions=("xent", "loss", "softmax", "cross_entropy")))


# -- the quantized matmul ------------------------------------------------------------

def _qmm_dims(shape: Mapping):
    return (int(shape.get("m", 8184)), int(shape.get("k", 768)),
            int(shape.get("n", 3072)), _dtype(shape, "bfloat16"))


def _isz(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def _qmm_defaults(shape: Mapping) -> Dict[str, int]:
    # the tile the kernel's plan() picks, asked of the library; off the
    # card (interpret: the plain version, no tile runs) the general 64 x
    # 128 tile stands in for it
    m, k, n, dtype = _qmm_dims(shape)
    qk = _mod("quant.kernels")
    bm, bn = qk.kernel_tile(m, k, n, dtype) if torch.cuda.is_available() \
        else (64, 128)
    return {"block_m": bm, "block_n": bn}


def _qmm_fits(shape: Mapping, cfg: Dict[str, int]) -> bool:
    m, k, n, dtype = _qmm_dims(shape)
    qk = _mod("quant.kernels")
    tile = (int(cfg["block_m"]), int(cfg["block_n"]))
    if not torch.cuda.is_available():
        return tile in qk.tiles(_isz(dtype))
    return qk.kernel_tile(m, k, n, dtype, tile) == tile


def _qmm_case(shape: Mapping, interpret: bool) -> TuneCase:
    qk = _mod("quant.kernels")
    m, k, n, dtype = _qmm_dims(shape)
    dev = _device(interpret)
    rs = np.random.RandomState(0)
    x = _randn(rs, (m, k), dtype, dev, 0.05)
    w = _randn(rs, (k, n), dtype, dev, 0.05)
    # a frozen calibration for the normal(0, 0.05) activations (amax
    # ~5 sigma), not a per-call absmax
    x_scale = torch.tensor(0.25 / 127.0, device=dev)
    w_scale = qk.channel_scale(w)
    qw = qk.weight_layout(w, w_scale)

    def run(cfg):
        # the kernel only: its backward is the straight-through plain
        # matmuls, which no tile touches
        if interpret:
            return qk._qmm_ref(x, qw, x_scale, w_scale, dtype)
        return qk.qmm_kernel(x, qw, x_scale, w_scale, dtype,
                             (int(cfg["block_m"]), int(cfg["block_n"])))

    return TuneCase(run=run)


QUANTIZED_MATMUL = register(KernelSpec(
    name="quantized_matmul", version=_mod("quant.kernels").TUNE_VERSION,
    params=("block_m", "block_n"), kind="compute", exact=True,
    defaults=_qmm_defaults,
    candidates=lambda shape, bound: [
        {"block_m": bm, "block_n": bn} for bm, bn in _mod(
            "quant.kernels").tiles(_isz(_qmm_dims(shape)[3]))],
    constraint=_qmm_fits,
    build=_qmm_case,
    bucket=lambda shape: _mod("quant.kernels").tune_bucket(
        *_qmm_dims(shape)[:3], _isz(_qmm_dims(shape)[3])),
    priority=lambda shape, cfg, bound: _area_priority(
        cfg["block_m"] * cfg["block_n"], bound),
    example_shape={"m": 8184, "k": 768, "n": 3072, "dtype": "bfloat16"},
    small_shape={"m": 100, "k": 128, "n": 256, "dtype": "bfloat16"},
    regions=("quant", "qmm", "dense", "proj", "mlp")))


# -- the conv kernels -----------------------------------------------------------------

def _conv_dims(shape: Mapping):
    return (int(shape.get("batch", 128)), int(shape.get("h", 56)),
            int(shape.get("w", 56)), int(shape.get("cin", 64)),
            int(shape.get("cout", 64)), int(shape.get("kh", 3)),
            int(shape.get("kw", 3)), int(shape.get("stride", 1)),
            _dtype(shape, "bfloat16"), bool(shape.get("epilogue", False)),
            bool(shape.get("residual", False)))


def _conv_case(shape: Mapping, interpret: bool) -> TuneCase:
    conv2d = _mod("ops.conv").conv2d
    n, h, w, cin, cout, kh, kw, s, dtype, epi, res = _conv_dims(shape)
    dev = _device(interpret)
    rs = np.random.RandomState(0)
    x = _randn(rs, (n, h, w, cin), dtype, dev).requires_grad_()
    wt = _randn(rs, (kh, kw, cin, cout), dtype, dev, 0.05).requires_grad_()
    oh, ow = -(-h // s), -(-w // s)
    epilogue = {}
    if epi:
        epilogue = dict(mean=torch.zeros(cout, device=dev),
                        invstd=torch.ones(cout, device=dev), relu=True)
        if res:
            epilogue["z"] = torch.ones((n, oh, ow, cout), device=dev,
                                       dtype=dtype)

    def run(cfg):
        out = conv2d(x, wt, stride=s, padding="SAME",
                     block_m=int(cfg["block_m"]),
                     block_n=int(cfg["block_n"]), **epilogue)
        loss = (out.float() ** 2).sum()
        return (out.detach(),) + _grads(loss, (x, wt))

    return TuneCase(run=run)


def _conv_bucket(shape: Mapping) -> str:
    n, h, w, cin, cout, kh, kw, s, dtype, epi, res = _conv_dims(shape)
    return _mod("ops.conv").tune_bucket(
        n, -(-h // s), -(-w // s), cin, cout, kh, kw, s, s, 1, 1,
        _isz(dtype), epi, epi and res)


CONV2D = register(KernelSpec(
    name="conv2d", version=_mod("ops.conv").TUNE_VERSION,
    params=("block_m", "block_n"), kind="compute", exact=True,
    defaults=lambda shape: {
        "block_m": _mod("ops.conv")._BM,
        "block_n": _mod("ops.conv")._tile_n(_conv_dims(shape)[4])},
    candidates=lambda shape, bound: [
        {"block_m": _mod("ops.conv")._BM, "block_n": bn}
        for bn in _mod("ops.conv")._BN],
    constraint=lambda shape, cfg: _mod("ops.conv")._legal_tile(
        cfg["block_m"], cfg["block_n"]),
    build=_conv_case, bucket=_conv_bucket,
    priority=lambda shape, cfg, bound: _area_priority(
        cfg["block_m"] * cfg["block_n"], bound),
    example_shape={"batch": 128, "h": 56, "w": 56, "cin": 64, "cout": 64,
                   "kh": 3, "kw": 3, "stride": 1, "dtype": "bfloat16",
                   "epilogue": False, "residual": False},
    small_shape={"batch": 2, "h": 8, "w": 8, "cin": 64, "cout": 128,
                 "kh": 3, "kw": 3, "stride": 1, "dtype": "bfloat16",
                 "epilogue": True, "residual": True},
    regions=("conv", "stage", "downsample")))
