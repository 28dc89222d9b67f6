"""GPT-style decoder-only causal LM — counterpart of
``apex_tpu/models/gpt.py``.

Pre-LN residual blocks, learned positions, an LM head tied to the token
embedding.  The numerics follow the flax model step for step:

* embeddings are summed in the parameters' dtype (fp32, or bf16 when an
  O2 step hands the model bf16 copies) and then cast to the compute
  dtype;
* each projection casts its input and kernel to the compute dtype;
* GELU is the tanh approximation (flax ``nn.gelu``'s default), in fp32;
* the LM head is an fp32 product against ``wte.T``, ``wte`` promoted to
  fp32 whatever its dtype, as JAX promotes it (on the card, TF32 must be
  off for it to be fp32: the entry points turn it off).

The non-cache forward is differentiable on both devices: the LayerNorm
and attention kernels carry their own backward kernels.

Parameter names and shapes are flax's (``wte``, ``wpe``,
``block_{i}.ln1.scale``, ``block_{i}.attention.query.kernel`` ...), so
:mod:`apex_tpu_torch.convert` moves weights between the packages.  The
init mirrors flax's initializers from a ``torch.Generator`` seeded with
``seed``: ``wte`` normal(0.02), ``wpe`` normal(0.01), lecun-normal
kernels, zero biases, LayerNorm ones and zeros (the numbers differ from
JAX's, whose generator is another).

``quant=`` (a :class:`~apex_tpu_torch.quant.layers.QuantConfig`) builds
every q/k/v/out/mlp_up/mlp_down projection as a ``QuantDenseGeneral``
named by its flax path (``block_0/attention/query``), so a calibration
moves between the packages; the LM head is not quantized, as in JAX.
Not ported yet: ``generate()`` and ``decode=True`` (the serving engine's
external-cache forward is the decode path) and ``sp_axis`` sequence
parallelism.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..normalization import FusedLayerNorm
from ..prof.capture import scope
from .bert import BertSelfAttention, _dense_factory


class GPTBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32, *,
                 attention_impl: str = "flash",
                 num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None, quant=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = hidden_size
        self.ln1 = FusedLayerNorm(d, device=device)
        self.attention = BertSelfAttention(
            d, num_heads, dtype, attention_impl=attention_impl, causal=True,
            num_kv_heads=num_kv_heads, window=window, quant=quant,
            device=device, generator=generator)
        self.ln2 = FusedLayerNorm(d, device=device)
        dense = _dense_factory(quant, dtype, device=device,
                               generator=generator)
        self.mlp_up = dense((d,), (mlp_dim,))
        self.mlp_down = dense((mlp_dim,), (d,))

    def forward(self, x, *, kv_cache=None, positions=None):
        if kv_cache is not None:
            h = self.ln1(x).to(x.dtype)
            h, new_cache = self.attention(h, kv_cache=kv_cache,
                                          positions=positions)
            x = x + h
            h = self.ln2(x).to(x.dtype)
            h = F.gelu(self.mlp_up(h).float(), approximate="tanh")
            return x + self.mlp_down(h.to(x.dtype)), new_cache
        # the JAX block's submodule names as profiler scopes, so a
        # roofline ledger's regions name what they hold (the tuner reads
        # them); the incremental forward above opens none
        with scope("ln1"):
            h = self.ln1(x).to(x.dtype)
        with scope("attention"):
            h = self.attention(h)
        x = x + h
        with scope("ln2"):
            h = self.ln2(x).to(x.dtype)
        with scope("mlp_up"):
            h = self.mlp_up(h)
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        with scope("mlp_down"):
            h = self.mlp_down(h)
        return x + h


class GPT(nn.Module):
    """Decoder-only LM.  ``forward(input_ids) -> logits [B, T, V]`` (fp32,
    tied to the token embedding); with ``kv_caches`` it is the
    incremental forward and returns ``(logits, new_caches)``."""

    def __init__(self, vocab_size: int = 50257, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "flash",
                 num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None, decode: bool = False,
                 quant=None, *, device=None, seed: int = 0):
        super().__init__()
        if decode:
            raise NotImplementedError(
                "decode=True (ROADMAP queue 1 item 4) is not ported; decode "
                "through the serving engine's external-cache forward "
                "(kv_caches=, positions=)")
        dev = resolve_device(device)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.mlp_dim = mlp_dim
        self.max_len = max_len
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        self.wte = nn.Parameter(
            (torch.randn(vocab_size, hidden_size, generator=gen) * 0.02)
            .to(dev))
        self.wpe = nn.Parameter(
            (torch.randn(max_len, hidden_size, generator=gen) * 0.01)
            .to(dev))
        for i in range(num_layers):
            self.add_module(f"block_{i}", GPTBlock(
                hidden_size, num_heads, mlp_dim, dtype,
                attention_impl=attention_impl, num_kv_heads=num_kv_heads,
                window=window, quant=quant, device=dev, generator=gen))
        self.ln_f = FusedLayerNorm(hidden_size, device=dev)
        if quant is not None:
            from ..quant.layers import name_quant_sites
            name_quant_sites(self)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def blocks(self) -> List[GPTBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def forward(self, input_ids, kv_caches=None, positions=None):
        b, t = input_ids.shape
        if kv_caches is not None:
            # Incremental forward over caller-owned caches: one (k, v)
            # dense view per layer, [B, L, n_kv, head_dim] (init_cache
            # builds them; the serving engine gathers them from its page
            # pool), and ``positions`` [B], each sequence's position of
            # its first fresh token.  T may be 1 (decode) or a prompt
            # bucket (prefill).
            if len(kv_caches) != self.num_layers:
                raise ValueError(
                    f"kv_caches has {len(kv_caches)} entries for "
                    f"{self.num_layers} layers")
            if positions is None:
                positions = torch.zeros((b,), dtype=torch.long,
                                        device=input_ids.device)
            pos = (positions.to(torch.long)[:, None]
                   + torch.arange(t, device=input_ids.device)[None, :])
            x = (self.wte[input_ids] + self.wpe[pos]).to(self.dtype)
            new_caches = []
            for block, cache in zip(self.blocks(), kv_caches):
                x, c = block(x, kv_cache=cache, positions=positions)
                new_caches.append(c)
            x = self.ln_f(x)
            return x.float() @ self.wte.float().T, new_caches
        if t > self.max_len:
            raise ValueError(f"sequence of {t} tokens exceeds max_len="
                             f"{self.max_len}")
        with scope("embed"):
            pos = torch.arange(t, device=input_ids.device)
            x = (self.wte[input_ids] + self.wpe[pos][None]).to(self.dtype)
        for i, block in enumerate(self.blocks()):
            with scope(f"block_{i}"):
                x = block(x)
        with scope("head"):
            with scope("ln_f"):
                x = self.ln_f(x)
            return x.float() @ self.wte.float().T


def gpt2_small(**kw) -> GPT:
    """GPT-2 small: hidden 768, 12 layers, 12 heads, MLP 3072, vocab
    50257, max_len 1024."""
    return GPT(**kw)


def gpt_tiny(**kw) -> GPT:
    kw.setdefault("vocab_size", 1024)
    kw.setdefault("hidden_size", 128)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("mlp_dim", 256)
    kw.setdefault("max_len", 256)
    return GPT(**kw)


def init_cache(model: GPT, batch_size: int, *,
               cache_len: Optional[int] = None, dtype=None
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Zeroed external KV-cache views for the incremental forward, on the
    model's device: one ``(k, v)`` pair per layer, each ``[batch_size,
    cache_len, n_kv_heads, head_dim]``.  ``cache_len`` defaults to
    ``model.max_len`` and must not exceed it; ``dtype`` defaults to the
    model's compute dtype."""
    cache_len = model.max_len if cache_len is None else int(cache_len)
    if cache_len > model.max_len:
        raise ValueError(f"cache_len {cache_len} exceeds the model's "
                         f"max_len {model.max_len}")
    n_kv = model.num_kv_heads or model.num_heads
    head_dim = model.hidden_size // model.num_heads
    dt = model.dtype if dtype is None else dtype
    shape = (batch_size, cache_len, n_kv, head_dim)
    return [(torch.zeros(shape, dtype=dt, device=model.device),
             torch.zeros(shape, dtype=dt, device=model.device))
            for _ in range(model.num_layers)]
