"""The BERT encoder — counterpart of ``apex_tpu/models/bert.py``:
self-attention with flax-shaped projections (which the GPT serving and
training paths also run), ``BertLayer``, ``BertEncoder``, ``bert_base``
and ``bert_tiny``.  The forward is differentiable on both devices.

Projections keep flax's DenseGeneral layouts, so one weight set moves
between the two packages unchanged (:mod:`apex_tpu_torch.convert`):
query/key/value kernels ``[d, heads, head_dim]`` with biases ``[heads,
head_dim]``, the output kernel ``[heads, head_dim, d]``.  Parameters are
fp32; a projection with ``dtype=bf16`` casts both its input and its
kernel to bf16, as flax does.

The encoder keeps flax's names and layouts too: ``word_embeddings.
embedding`` ``[vocab, hidden]`` (and the position and token-type
tables), ``embeddings_ln``, ``layer_{i}.attention.*``,
``layer_{i}.attention_ln``, ``layer_{i}.intermediate`` and
``layer_{i}.output`` (Dense kernels ``[in, out]``),
``layer_{i}.output_ln``, ``pooler`` and ``classifier``.  Its numerics
follow the flax module: the embeddings summed in the parameters' dtype,
every LayerNorm the fused kernel (fp32 statistics), GELU the tanh
approximation in fp32, fp32 features with ``num_classes=None``, else
the tanh pooler over the first token and the classifier, fp32 logits.
The padding mask reaches ``flash`` as a key-padding bias and
``blockwise`` and ``full`` as a ``[B, 1, 1, S]`` additive bias.

Ported: the ``flash``, ``blockwise`` and ``full`` attention impls, the
external-cache incremental forward the serving engine drives, the
``decode=True`` one-token step over a cache the caller holds (JAX's flax
``"cache"`` collection as a dict of tensors updated in place,
:meth:`BertSelfAttention.init_cache`), and ``quant=`` (every projection
a :class:`~apex_tpu_torch.quant.layers.QuantDenseGeneral`), and sequence
parallelism: ``sp_axis`` (a process group, or a mesh axis of
:func:`~apex_tpu_torch.parallel.distributed.register_mesh`) with the
``ring``, ``ring_flash`` and ``ulysses`` impls
(:mod:`apex_tpu_torch.parallel.ring_attention`).  Under ``sp_axis`` the
input is this rank's contiguous shard of the sequence: its positions
start at ``rank * shard_len``, and the pooler takes the true first token
from the axis's rank 0 (a ``psum`` of it masked to that rank, whose
transpose is JAX's: the cotangent as it is), so the sharded and unsharded
models compute the same function on the same parameters.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..normalization import FusedLayerNorm
from ..parallel.distributed import axis_index
from ..parallel.tensor_parallel import psum_replicated
from ..prof.capture import scope

#: the sequence-parallel impls (they need ``sp_axis``)
_SP_IMPLS = ("ring", "ring_flash", "ulysses")

# flax's truncated-normal correction: the std of a unit normal truncated
# to [-2, 2] (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's default kernel init (``lecun_normal``): a normal truncated
    at two standard deviations, scaled to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class DenseGeneral(nn.Module):
    """flax ``Dense``/``DenseGeneral``: contracts the trailing
    ``len(in_shape)`` dims of the input with a kernel ``in_shape +
    out_shape`` and adds a bias ``out_shape``.  Parameters are fp32 and
    made on the CPU from ``generator``, then moved to ``device``."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_shape = tuple(int(s) for s in in_shape)
        self.out_shape = tuple(int(s) for s in out_shape)
        self.dtype = dtype
        n_in = math.prod(self.in_shape)
        kernel = lecun_normal_(torch.empty(n_in, math.prod(self.out_shape)),
                               n_in, generator)
        dev = resolve_device(device)
        self.kernel = nn.Parameter(
            kernel.reshape(self.in_shape + self.out_shape).to(dev))
        self.bias = nn.Parameter(torch.zeros(self.out_shape, device=dev))

    def forward(self, x):
        n_in = len(self.in_shape)
        lead = x.shape[:x.dim() - n_in]
        w = self.kernel.reshape(math.prod(self.in_shape), -1)
        y = x.reshape(-1, w.shape[0]).to(self.dtype) @ w.to(self.dtype)
        y = y + self.bias.reshape(-1).to(self.dtype)
        return y.reshape(*lead, *self.out_shape)


def _dense_factory(quant, dtype, *, device, generator):
    """``dense(in_shape, out_shape)`` factory of the JAX
    ``_dense_factory`` hook: with a ``QuantConfig`` every projection is
    the parameter-compatible ``QuantDenseGeneral`` (the int8 kernel on
    calibrated sites, the plain arithmetic elsewhere), without one the
    plain ``DenseGeneral``."""
    if quant is not None:
        from ..quant.layers import QuantDenseGeneral

        def qdense(in_shape, out_shape):
            return QuantDenseGeneral(in_shape, out_shape, dtype, quant=quant,
                                     device=device, generator=generator)
        return qdense

    def dense(in_shape, out_shape):
        return DenseGeneral(in_shape, out_shape, dtype, device=device,
                            generator=generator)
    return dense


class BertSelfAttention(nn.Module):
    """Self-attention with a pluggable compute strategy
    (``attention_impl``): ``"flash"`` (the CUDA kernel of
    :mod:`apex_tpu_torch.ops.flash_attention`, its plain version on the
    CPU), ``"blockwise"`` (online softmax over key blocks in plain torch,
    :func:`~apex_tpu_torch.ops.attention.blockwise_attention`),
    ``"full"`` (materialized scores, the oracle), or over the sequence
    shards of ``sp_axis`` ``"ring"``, ``"ring_flash"`` (the flash kernels
    a ring step) or ``"ulysses"``, which take no padding mask.  ``mask``
    ``[B, S]`` marks the keys to attend to (nonzero or True).

    ``decode=True`` is JAX's autoregressive step: one token a call, its
    key and value written into a cache of ``cache_len`` positions that
    the caller holds (:meth:`init_cache`: ``cached_key`` and
    ``cached_value`` ``[B, cache_len, n_kv, head_dim]`` in the compute
    dtype, and ``cache_index``, a 0-dim int64 tensor on the device, so
    one captured step serves every position) and passes as ``cache=``;
    the step updates it in place.  The attention is JAX's plain fp32
    grouped einsum over the whole buffer with the ``pos <= i`` mask (and
    the ``window`` mask), no kernel; GQA caches only the kv heads.  As
    JAX's ``dynamic_update_slice`` does, a write past ``cache_len``
    lands on the last row without an error: the caller bounds its steps
    (:func:`~apex_tpu_torch.models.gpt.generate` clamps them)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, *,
                 attention_impl: str = "full", causal: bool = False,
                 sp_axis=None, num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None, decode: bool = False,
                 cache_len: int = 0, quant=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attention_impl not in ("flash", "blockwise", "full") + _SP_IMPLS:
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        n_kv = num_kv_heads or num_heads
        if num_heads % n_kv:
            raise ValueError(f"num_kv_heads {n_kv} must divide "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.n_kv = n_kv
        self.head_dim = hidden_size // num_heads
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.causal = causal
        self.sp_axis = sp_axis
        self.window = window
        self.decode = decode
        self.cache_len = int(cache_len)
        dense = _dense_factory(quant, dtype, device=device,
                               generator=generator)
        d, hd = hidden_size, self.head_dim
        self.query = dense((d,), (num_heads, hd))
        self.key = dense((d,), (n_kv, hd))
        self.value = dense((d,), (n_kv, hd))
        self.out = dense((num_heads, hd), (d,))

    def init_cache(self, batch_size: int, *, dtype=None, device=None
                   ) -> dict:
        """A zeroed ``decode=True`` cache for ``batch_size`` sequences:
        flax's ``cached_key``, ``cached_value`` (in ``dtype``, default
        the compute dtype) and ``cache_index``, on ``device`` (default
        the parameters')."""
        dev = self.query.kernel.device if device is None else device
        shape = (batch_size, self.cache_len, self.n_kv, self.head_dim)
        dt = self.dtype if dtype is None else dtype
        return {"cached_key": torch.zeros(shape, dtype=dt, device=dev),
                "cached_value": torch.zeros(shape, dtype=dt, device=dev),
                "cache_index": torch.zeros((), dtype=torch.long,
                                           device=dev)}

    def forward(self, x, mask=None, *, kv_cache=None, positions=None,
                cache=None):
        if mask is not None:
            mask = mask.to(torch.bool)
        if self.decode:
            if not self.causal or mask is not None:
                raise ValueError("decode mode is causal-only and takes no "
                                 "padding mask — batch equal-length "
                                 "prompts (padding is unsupported: cached "
                                 "pad KV would be attended to)")
            if x.shape[1] != 1:
                raise ValueError(f"decode consumes ONE token per call, got "
                                 f"sequence length {x.shape[1]}")
            if cache is None:
                raise ValueError("decode=True needs cache= (init_cache)")
        elif cache is not None:
            raise ValueError("cache= is the decode=True step's")
        q = self.query(x)
        k = self.key(x)
        v = self.value(x)
        if kv_cache is not None:
            ctx, kf, vf = self._incremental(q, k, v, kv_cache, positions,
                                            mask)
            return self.out(ctx.to(x.dtype)), (kf, vf)
        if self.decode:
            return self.out(self._decode_step(q, k, v, cache).to(x.dtype))
        if self.window is not None and (self.attention_impl != "flash"
                                        or not self.causal):
            raise ValueError(
                f"window (sliding-window local attention) needs "
                f"attention_impl='flash' and causal=True; got "
                f"impl={self.attention_impl!r}, causal={self.causal}")
        if self.attention_impl in _SP_IMPLS:
            if mask is not None:
                raise ValueError(
                    "ring/ulysses attention paths take no padding mask; pad "
                    "to shard boundaries or use attention_impl='blockwise'")
            from ..parallel.ring_attention import (ring_attention,
                                                   ring_flash_attention,
                                                   ulysses_attention)
            fn = {"ring": ring_attention,
                  "ring_flash": ring_flash_attention,
                  "ulysses": ulysses_attention}[self.attention_impl]
            ctx = fn(q, k, v, self.sp_axis, causal=self.causal)
        elif self.attention_impl == "flash":
            from ..ops.flash_attention import flash_attention
            kb = None
            if mask is not None:
                kb = torch.where(mask, 0.0, -1e9)
            ctx = flash_attention(q, k, v, causal=self.causal,
                                  window=self.window, key_padding_bias=kb)
        else:
            from ..ops.attention import (blockwise_attention,
                                         dot_product_attention)
            if self.n_kv != self.num_heads:
                grp = self.num_heads // self.n_kv
                k = k.repeat_interleave(grp, dim=2)
                v = v.repeat_interleave(grp, dim=2)
            bias = None
            if mask is not None:
                bias = torch.where(mask[:, None, None, :], 0.0, -1e9)
            attend = (blockwise_attention if self.attention_impl
                      == "blockwise" else dot_product_attention)
            ctx = attend(q, k, v, causal=self.causal, bias=bias)
        return self.out(ctx.to(x.dtype))

    def _decode_step(self, q, k, v, cache: dict) -> torch.Tensor:
        """One token: write its k/v at ``cache_index`` (clamped to the
        last row, as ``dynamic_update_slice`` clamps), advance the index,
        and attend in fp32 over the whole buffer, the positions past the
        index (and before the window) masked; the context ``[B, 1,
        heads, head_dim]`` in fp32."""
        ck, cv, ci = (cache["cached_key"], cache["cached_value"],
                      cache["cache_index"])
        b, hd = q.shape[0], self.head_dim
        cache_len = ck.shape[1]
        i = ci.clone()
        row = i.clamp(max=cache_len - 1).view(1)
        ck.index_copy_(1, row, k.to(ck.dtype))
        cv.index_copy_(1, row, v.to(cv.dtype))
        ci.add_(1)
        # grouped einsums keep the cache un-repeated, as in JAX
        grp = self.num_heads // self.n_kv
        qg = q.reshape(b, 1, self.n_kv, grp, hd)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                         ck.float()) * (hd ** -0.5)
        pos = torch.arange(cache_len, device=q.device)
        live = pos <= i
        if self.window is not None:
            live = live & (pos > i - self.window)
        s = torch.where(live, s, -1e30)
        att = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhgqk,bkhd->bqhgd", att, cv.float())
        return ctx.reshape(b, 1, self.num_heads, hd)

    def _incremental(self, q, k, v, kv_cache: Tuple[torch.Tensor, torch.Tensor],
                     positions, mask):
        """Incremental attention over caller-owned dense cache views
        ``(k, v)`` ``[B, L, n_kv, head_dim]``: write the fresh tokens'
        k/v at each sequence's own position and attend causally over
        everything written so far.  ``positions`` ``[B]`` is the global
        position of each sequence's first fresh token.

        The views are updated IN PLACE (the serving engine gathers fresh
        views every step, so nothing else sees them) and returned as
        ``(ctx, k_full, v_full)``.  As ``dynamic_update_slice`` does in
        the JAX version, a write that would run past the view is moved
        back to end at it; the caller bounds ``positions + T`` by ``L``."""
        from ..ops.flash_attention import flash_attention
        if not self.causal or mask is not None:
            raise ValueError("the external-cache incremental path is "
                             "causal-only and takes no padding mask")
        ck, cv = kv_cache
        b, t = q.shape[0], q.shape[1]
        cache_len = ck.shape[1]
        positions = positions.to(device=q.device, dtype=torch.long)
        start = positions.clamp(0, cache_len - t)
        rows = start[:, None] + torch.arange(t, device=q.device)[None, :]
        batch = torch.arange(b, device=q.device)[:, None]
        ck[batch, rows] = k.to(ck.dtype)
        cv[batch, rows] = v.to(cv.dtype)
        key_pos = torch.arange(cache_len, device=q.device)
        if t == 1:
            # decode: the suffix-aligned decode path of flash_attention;
            # key_padding_bias hides the dead cache tail (and the past
            # outside the window)
            live = key_pos[None, :] <= positions[:, None]
            if self.window is not None:
                live = live & (key_pos[None, :]
                               > positions[:, None] - self.window)
            kb = torch.where(live, 0.0, -1e9)
            ctx = flash_attention(q, ck, cv, causal=True,
                                  key_padding_bias=kb)
        else:
            # prefill: per-sequence offsets need a per-row causal
            # frontier, an explicit [B, T, L] visibility bias
            qpos = positions[:, None] + torch.arange(t, device=q.device)
            visible = key_pos[None, None, :] <= qpos[:, :, None]
            if self.window is not None:
                visible = visible & (key_pos[None, None, :]
                                     > qpos[:, :, None] - self.window)
            bias = torch.where(visible, 0.0, -1e9)
            ctx = flash_attention(q, ck, cv, causal=False, bias=bias)
        return ctx, ck, cv


class BertLayer(nn.Module):
    """One post-LN encoder layer: self-attention, ``attention_ln(x +
    attn)``, the GELU MLP (``intermediate``, ``output``) and
    ``output_ln(x + h)``, each LayerNorm's output in the input's dtype.
    ``hidden_size`` is the JAX layer's inferred input width (torch makes
    parameters at construction)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32, *,
                 attention_impl: str = "full", sp_axis=None,
                 num_kv_heads: Optional[int] = None, quant=None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = hidden_size
        self.attention = BertSelfAttention(
            d, num_heads, dtype, attention_impl=attention_impl,
            sp_axis=sp_axis, num_kv_heads=num_kv_heads, quant=quant,
            device=device, generator=generator)
        self.attention_ln = FusedLayerNorm(d, device=device)
        dense = _dense_factory(quant, dtype, device=device,
                               generator=generator)
        self.intermediate = dense((d,), (mlp_dim,))
        self.output = dense((mlp_dim,), (d,))
        self.output_ln = FusedLayerNorm(d, device=device)

    def forward(self, x, mask=None):
        # the JAX layer's submodule names as profiler scopes, so a roofline
        # ledger's regions name what they hold (the tuner reads them)
        with scope("attention"):
            attn = self.attention(x, mask)
        with scope("attention_ln"):
            x = self.attention_ln(x + attn).to(x.dtype)
        with scope("intermediate"):
            h = self.intermediate(x)
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        with scope("output"):
            h = self.output(h)
        with scope("output_ln"):
            return self.output_ln(x + h).to(x.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: a table ``embedding`` ``[num, features]``,
    normal with variance ``1 / features`` (flax's default init), looked
    up in its own dtype."""

    def __init__(self, num_embeddings: int, features: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        table = torch.randn(num_embeddings, features, generator=generator)
        self.embedding = nn.Parameter(
            (table * features ** -0.5).to(resolve_device(device)))

    def forward(self, ids):
        return self.embedding[ids]


class BertEncoder(nn.Module):
    """BERT: word, position and token-type embeddings, ``embeddings_ln``,
    ``num_layers`` :class:`BertLayer` layers, then fp32 features ``[B, S,
    hidden]`` (``num_classes=None``) or the pooler and classifier's fp32
    logits ``[B, num_classes]``.  ``forward(input_ids, attention_mask=
    None, token_type_ids=None)``.  Parameters are made on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (flax's initializers; the
    numbers differ from JAX's), then moved to ``device``."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 512,
                 type_vocab_size: int = 2,
                 num_classes: Optional[int] = 2,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "full", sp_axis=None,
                 num_kv_heads: Optional[int] = None, quant=None, *,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.sp_axis = sp_axis
        self.num_layers = num_layers
        self.num_classes = num_classes
        self.dtype = dtype
        emb = dict(device=dev, generator=gen)
        self.word_embeddings = Embed(vocab_size, hidden_size, **emb)
        self.position_embeddings = Embed(max_len, hidden_size, **emb)
        self.token_type_embeddings = Embed(type_vocab_size, hidden_size,
                                           **emb)
        self.embeddings_ln = FusedLayerNorm(hidden_size, device=dev)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", BertLayer(
                hidden_size, num_heads, mlp_dim, dtype,
                attention_impl=attention_impl, sp_axis=sp_axis,
                num_kv_heads=num_kv_heads, quant=quant, device=dev,
                generator=gen))
        if num_classes is not None:
            self.pooler = DenseGeneral((hidden_size,), (hidden_size,),
                                       dtype, device=dev, generator=gen)
            self.classifier = DenseGeneral((hidden_size,), (num_classes,),
                                           dtype, device=dev,
                                           generator=gen)
        if quant is not None:
            from ..quant.layers import name_quant_sites
            name_quant_sites(self)

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None]
        if self.sp_axis is not None:
            # this shard's global positions start at rank * shard_len
            pos = pos + axis_index(self.sp_axis) * s
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        with scope("embeddings_ln"):
            x = self.embeddings_ln(
                self.word_embeddings(input_ids)
                + self.position_embeddings(pos)
                + self.token_type_embeddings(token_type_ids))
        x = x.to(self.dtype)
        for i, layer in enumerate(self.layers()):
            with scope(f"layer_{i}"):
                x = layer(x, attention_mask)
        if self.num_classes is None:
            return x.float()
        pool_in = x[:, 0]
        if self.sp_axis is not None:
            # only the axis's rank 0 holds the true first token: a psum
            # of it masked to that rank gives it to every rank (a select,
            # so every rank's encoder stays on the loss's graph and runs
            # its backward's collectives)
            first = x[:, 0].float()
            rank0 = torch.tensor(axis_index(self.sp_axis) == 0,
                                 device=first.device)
            first = torch.where(rank0, first, torch.zeros_like(first))
            pool_in = psum_replicated(first, self.sp_axis).to(x.dtype)
        with scope("pooler"):
            pooled = torch.tanh(self.pooler(pool_in))
        with scope("classifier"):
            return self.classifier(pooled).float()


def bert_base(**kw) -> BertEncoder:
    """BERT-base: hidden 768, 12 layers, 12 heads, MLP 3072, vocab
    30522, max_len 512."""
    return BertEncoder(**kw)


def bert_tiny(**kw) -> BertEncoder:
    kw.setdefault("hidden_size", 128)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("mlp_dim", 512)
    kw.setdefault("vocab_size", 1024)
    kw.setdefault("max_len", 128)
    return BertEncoder(**kw)
