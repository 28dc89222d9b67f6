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

``decode=True`` is JAX's one-token step over the flax ``"cache"``
collection, here a nested dict of tensors that the caller holds and the
step updates in place (:func:`init_decode_cache`: ``pos_index`` and,
per layer, ``block_{i}/attention/{cached_key, cached_value,
cache_index}``); :func:`generate` drives it, teacher-forcing the prompt
and then feeding back greedy or sampled tokens, with the step captured
once in a CUDA graph on the card.

``sp_axis`` (a process group, or a mesh axis of
:func:`~apex_tpu_torch.parallel.distributed.register_mesh`) with
``attention_impl`` ``ring``, ``ring_flash`` or ``ulysses`` is JAX's
sequence parallelism: the input is this rank's contiguous shard of the
sequence, its positions start at ``rank * shard_len``, and the global
length (shards times the shard's) must fit ``max_len``.  :func:`generate`
refuses such a model, as JAX's does.
"""

from __future__ import annotations

import contextlib
from typing import List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..normalization import FusedLayerNorm
from ..prof.capture import scope
from ..parallel.distributed import axis_index, axis_size
from .bert import BertSelfAttention, _dense_factory


class GPTBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32, *,
                 attention_impl: str = "flash", sp_axis=None,
                 num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None, decode: bool = False,
                 cache_len: int = 0, quant=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = hidden_size
        self.ln1 = FusedLayerNorm(d, device=device)
        self.attention = BertSelfAttention(
            d, num_heads, dtype, attention_impl=attention_impl, causal=True,
            sp_axis=sp_axis, num_kv_heads=num_kv_heads, window=window, decode=decode,
            cache_len=cache_len, quant=quant, device=device,
            generator=generator)
        self.ln2 = FusedLayerNorm(d, device=device)
        dense = _dense_factory(quant, dtype, device=device,
                               generator=generator)
        self.mlp_up = dense((d,), (mlp_dim,))
        self.mlp_down = dense((mlp_dim,), (d,))

    def forward(self, x, *, kv_cache=None, positions=None, cache=None):
        if kv_cache is not None or cache is not None:
            h = self.ln1(x).to(x.dtype)
            if cache is not None:     # the decode step: cache in place
                h = self.attention(h, cache=cache)
            else:
                h, kv_cache = self.attention(h, kv_cache=kv_cache,
                                             positions=positions)
            x = x + h
            h = self.ln2(x).to(x.dtype)
            h = F.gelu(self.mlp_up(h).float(), approximate="tanh")
            x = x + self.mlp_down(h.to(x.dtype))
            return x if cache is not None else (x, kv_cache)
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
    incremental forward and returns ``(logits, new_caches)``; built with
    ``decode=True`` it is the one-token step over ``cache=`` (the module
    docstring) and returns ``(logits, cache)``."""

    def __init__(self, vocab_size: int = 50257, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "flash",
                 num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None, decode: bool = False,
                 quant=None, *, sp_axis=None, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.sp_axis = sp_axis
        self.decode = decode
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
                attention_impl=attention_impl, sp_axis=sp_axis,
                num_kv_heads=num_kv_heads, window=window, decode=decode,
                cache_len=max_len,
                quant=quant, device=dev, generator=gen))
        self.ln_f = FusedLayerNorm(hidden_size, device=dev)
        if quant is not None:
            from ..quant.layers import name_quant_sites
            name_quant_sites(self)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def blocks(self) -> List[GPTBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def forward(self, input_ids, kv_caches=None, positions=None, *,
                cache=None):
        b, t = input_ids.shape
        if self.decode:
            return self._decode_step(input_ids, cache)
        if cache is not None:
            raise ValueError("cache= is the decode=True step's")
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
        sp = 1 if self.sp_axis is None else axis_size(self.sp_axis)
        if sp * t > self.max_len:
            raise ValueError(
                f"global sequence {sp} shard(s) x {t} tokens = {sp * t} "
                f"exceeds max_len={self.max_len}")
        with scope("embed"):
            pos = torch.arange(t, device=input_ids.device)
            if self.sp_axis is not None:
                # this shard's global positions
                pos = pos + axis_index(self.sp_axis) * t
            x = (self.wte[input_ids] + self.wpe[pos][None]).to(self.dtype)
        for i, block in enumerate(self.blocks()):
            with scope(f"block_{i}"):
                x = block(x)
        with scope("head"):
            with scope("ln_f"):
                x = self.ln_f(x)
            return x.float() @ self.wte.float().T

    def _decode_step(self, input_ids, cache):
        """One token a sequence at position ``cache["pos_index"]`` (the
        tokens consumed so far), which advances; returns ``(logits [B, 1,
        V], cache)``, the cache updated in place."""
        if input_ids.shape[1] != 1:
            raise ValueError(f"decode consumes ONE token per call, got "
                             f"{input_ids.shape[1]}")
        if cache is None:
            raise ValueError("decode=True needs cache= (init_decode_cache)")
        pi = cache["pos_index"]
        # JAX's gather clamps an index past the table
        pos = pi.clamp(max=self.max_len - 1).view(1)
        x = (self.wte[input_ids] + self.wpe[pos][None]).to(self.dtype)
        pi.add_(1)
        for i, block in enumerate(self.blocks()):
            x = block(x, cache=cache[f"block_{i}"]["attention"])
        x = self.ln_f(x)
        return x.float() @ self.wte.float().T, cache


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


def init_decode_cache(model: GPT, batch_size: int, *, dtype=None) -> dict:
    """A zeroed ``decode=True`` cache for ``batch_size`` sequences, on the
    model's device: JAX's ``"cache"`` collection as a nested dict,
    ``pos_index`` (a 0-dim int64 tensor) and ``block_{i}`` ->
    ``attention`` -> ``cached_key``, ``cached_value`` ``[batch_size,
    max_len, n_kv_heads, head_dim]`` (``dtype``, default the compute
    dtype) and ``cache_index``."""
    cache = {f"block_{i}": {"attention": block.attention.init_cache(
                 batch_size, dtype=dtype, device=model.device)}
             for i, block in enumerate(model.blocks())}
    cache["pos_index"] = torch.zeros((), dtype=torch.long,
                                     device=model.device)
    return cache


@contextlib.contextmanager
def _decoding(model: GPT):
    """``model`` as its ``decode=True`` twin for the context (the flags of
    the model and its attentions set, the cache length ``max_len``), as
    JAX's ``model.clone(decode=True)`` shares the parameters."""
    attns = [blk.attention for blk in model.blocks()]
    saved = (model.decode, [(a.decode, a.cache_len) for a in attns])
    model.decode = True
    for a in attns:
        a.decode, a.cache_len = True, model.max_len
    try:
        yield model
    finally:
        model.decode = saved[0]
        for a, (d, n) in zip(attns, saved[1]):
            a.decode, a.cache_len = d, n


def generate(model: GPT, params_or_model, prompt_ids, max_new_tokens: int,
             *, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             capture: bool = True) -> torch.Tensor:
    """Autoregressive generation over the ``decode=True`` cache (JAX's
    ``generate``): each step feeds one token, teacher-forced from the
    prompt while it lasts, then the greedy (``temperature == 0``,
    ``argmax``) or sampled (``softmax(logits / temperature)``, drawn with
    ``generator``, default one seeded 0 on the model's device) token.

    ``model`` is the GPT whose configuration runs; ``params_or_model``
    its weights, a ``state_dict``-style mapping (through
    ``torch.func.functional_call``) or a GPT module (often ``model``
    itself).  Returns ``[B, min(P + max_new_tokens, max_len)]`` int64
    token ids on the model's device, the prompt included: the step count
    is clamped so no position passes ``max_len``.

    On CUDA the step is captured once in a CUDA graph
    (:func:`apex_tpu_torch.cache.warmup`, whose warm run works on copies)
    and replayed per token over the cache and the token it holds; the
    next token is chosen outside the graph (``capture=False`` runs the
    step eagerly instead, the same kernels).  On the CPU the step runs
    eagerly.  A sequence-parallel model (``sp_axis``) is refused."""
    from .. import cache as _cache

    if getattr(model, "sp_axis", None) is not None:
        raise ValueError("generate() decodes full sequences; build the "
                         "model without sp_axis for inference")
    module = params_or_model if isinstance(params_or_model, nn.Module) \
        else model
    dev = module.wte.device
    prompt = torch.as_tensor(prompt_ids).to(dev, torch.long)
    b, p = prompt.shape
    total = min(p + int(max_new_tokens), model.max_len)
    if generator is None and temperature != 0.0:
        generator = torch.Generator(dev).manual_seed(0)
    with _decoding(module), torch.no_grad():
        if isinstance(params_or_model, Mapping):
            params = dict(params_or_model)

            def step(cache, tok):
                logits, _ = torch.func.functional_call(
                    module, params, (tok[:, None],), {"cache": cache})
                return logits[:, 0]
        else:
            def step(cache, tok):
                return module(tok[:, None], cache=cache)[0][:, 0]

        args = (init_decode_cache(module, b), prompt[:, 0].clone())
        run = (_cache.warmup(step, *args) if capture and total > 1
               else step)
        toks = [prompt[:, 0]]
        for t in range(total - 1):
            logits = run(*args)
            if t == 0 and run is not step:
                args = run.static_args       # replays copy nothing in
            if t + 1 < p:
                nxt = prompt[:, t + 1]
            elif temperature == 0.0:
                nxt = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            args[1].copy_(nxt)
            toks.append(nxt)
    return torch.stack(toks, dim=1)
