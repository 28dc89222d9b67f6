"""Bucketed inference engine: continuous batching over a paged KV cache —
counterpart of ``apex_tpu/serving/engine.py``.

* **buckets** — prefill and decode run at fixed sequence-length buckets:
  a request takes the smallest bucket holding ``len(prompt) +
  max_new_tokens``; prefill runs the whole padded bucket (pad positions
  write junk K/V that decode later hides with ``key_pos <= position``);
* **continuous batching** — a bounded request queue (``submit`` blocks
  when it is full) feeds a scheduler that admits requests into free KV
  pages at every step boundary, runs ONE batched decode for every active
  sequence whatever their positions (the per-sequence ``positions`` of
  the GPT incremental forward), and evicts finished sequences at once.
  The decode runs at the smallest bucket covering every live sequence's
  next position, so a long-bucket sequence early in its life decodes
  through that bucket's truncated page table; dead slots decode at
  position 0 against the trash page;
* **paged KV cache** — :mod:`apex_tpu_torch.serving.kv_cache`, updated
  in place; ``cache_dtype=torch.int8`` stores it as int8 with one fp32
  scale per (token, head) (``QuantPool``), quantized by the scatters and
  dequantized by the gather;
* **the AOT table** — the counterpart of JAX's ahead-of-time executables:
  on CUDA, prefill and decode of each bucket run as captured CUDA graphs
  (:func:`apex_tpu_torch.cache.warmup`), keyed by
  ``cache.signature(args, static=(kind, bucket))``.  :meth:`warmup`
  captures every bucket's pair before traffic, all from one graph pool;
  :meth:`_dispatch` replays, and a (kind, bucket) never warmed is
  captured at its first use and counted in ``stats["aot_misses"]``, as
  JAX compiles on a miss.  A step's inputs are one int64 vector (prefill:
  the pages, the padded prompt and its length; decode: the page tables,
  positions and tokens), written by the host into pinned memory and
  copied in with one ``copy_``; the graph's token comes back with one
  read.  The graphs are keyed on the weights' identities and versions
  too: after an in-place update (``load_state_dict``, an optimizer step,
  a ``.data`` assignment) or a replaced weight
  (``load_state_dict(assign=True)``, a new ``nn.Parameter``) every graph
  is captured again (``stats["recaptures"]``),
  so new weights always take effect, as JAX passes ``params`` to every
  call.  On the CPU the table holds the plain step bodies;
* **per-request timings** — queue wait, prefill, decode, TTFT (submit to
  first token), TPOT (mean time per later token) and e2e, measured on the
  host around work that ends in the token's copy to the host; each
  prefill and decode step is also a ``torch.profiler`` range
  (``prefill[bucket]``, ``decode[bucket]``) around its dispatch and its
  read, free when no profiler runs.

* **weight hot-swap** — ``watch_dir=`` runs a
  :class:`~apex_tpu_torch.serving.hotswap.WeightWatcher` on a checkpoint
  directory (polled every ``poll_every_s`` on its own thread); a staged
  checkpoint is adopted at the start of a scheduler step, between two
  dispatches, by copying its weights into the model's parameters in
  place (``load_state_dict``).  That moves the weights' versions, so the
  same step captures every graph again (and, at O4, prepares the int8
  weights again) before it dispatches: a request in flight finishes on
  the new weights, and no request sees a half-updated model.
  ``stats["hotswaps"]`` counts adoptions, ``stats["swap_s"]`` holds the
  last one's host seconds (the copy and the recapture).

Decoding is greedy (``argmax``, first maximum on ties, as ``jnp.argmax``)
so the tokens equal the JAX engine's on the same weights.

* **telemetry** — with a recorder (``telemetry=``, else the active
  one) the engine emits JAX's ``serving`` events (``submit``, ``admit``
  with the queue wait, ``decode`` with the batch size, ``done`` with
  every request's ``ttft_s``, ``tpot_s``, ``total_s`` and
  ``queue_wait_s``, ``reject``, ``hotswap``) and the gauges
  ``serving_queue_depth``, ``serving_active_seqs``,
  ``serving_kv_page_occupancy_pct``, ``serving_kv_bytes_per_token`` and
  ``serving_tokens_per_s``; with the recorder's tracer
  (``trace_sample_n``) every sampled request emits a span tree (a
  ``request`` root, ``queue``, ``prefill``, one ``decode_step`` per step
  it decoded in, ``hotswap``).  Every time is a host clock read around
  the replay and the one read of the tokens the step already makes; each
  capture at warmup or after the weights moved is a ``retrace`` event
  (``program`` ``prefill[bucket]`` / ``decode[bucket]``; a recapture is
  not ``first`` and not ``new_sig``).  An untraced request costs one
  counter increment at submit.

Usage::

    from apex_tpu_torch.models import gpt2_small
    from apex_tpu_torch.serving import ServingEngine

    model = gpt2_small(dtype=torch.bfloat16)          # on CUDA
    eng = ServingEngine(model, buckets=(256, 1024), max_seqs=8).warmup()
    results = eng.generate(prompts, max_new_tokens=32)
    eng.close()
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import cache as _cache
from .._device import resolve_device
from ..telemetry import events as _events
from . import kv_cache as _kv
from .hotswap import WeightWatcher

__all__ = ["Request", "ServedResult", "Completion", "ServingEngine"]


class Request(NamedTuple):
    """One generation request: ``prompt`` int token ids ``[T]``,
    ``max_new_tokens`` the decode budget, ``stop_token`` an optional
    early-finish id (checked on sampled tokens)."""
    prompt: np.ndarray
    max_new_tokens: int
    stop_token: Optional[int] = None


class ServedResult(NamedTuple):
    """A finished request: generated ``tokens`` (prompt excluded), timing
    spans, and ``error`` (None on success — a rejection, e.g. a prompt
    that fits no bucket, reports here instead of raising on the serving
    thread)."""
    tokens: np.ndarray
    timings: dict
    bucket: Optional[int] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


class Completion:
    """Future-ish handle for a submitted request."""

    def __init__(self):
        self._done = threading.Event()
        self._result: Optional[ServedResult] = None

    def _set(self, result: ServedResult) -> None:
        self._result = result
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> ServedResult:
        if not self._done.wait(timeout):
            raise TimeoutError("request not finished")
        return self._result


class _Active(NamedTuple):
    """One admitted sequence (a batch slot); ``trace``/``root`` its trace
    id and root span id when the tracer sampled it, else None."""
    request: Request
    completion: Completion
    bucket: int
    pages: List[int]
    t_submit: float
    t_admit: float
    t_prefill_done: float
    trace: Optional[str] = None
    root: Optional[str] = None


class ServingEngine:
    """Continuous-batching engine for a
    :class:`~apex_tpu_torch.models.gpt.GPT` model (see module docstring).

    ``buckets`` are the sequence-length capacities prefill AND decode run
    at (each must divide by ``page_size`` and fit ``model.max_len``);
    ``max_seqs`` is the decode batch width; ``n_pages`` sizes the pool
    (default: enough for ``max_seqs`` sequences of the largest bucket,
    plus the trash page).  ``cache_dtype``: the KV pool's storage dtype,
    default the model's compute dtype, or ``torch.int8``.  ``device``
    defaults to CUDA and raises without a GPU; pass ``device="cpu"`` to
    serve with the plain versions.  The model is moved to ``device``.

    ``watch_dir`` enables weight hot-swap (see the module docstring):
    checkpoints are loaded against ``watch_like`` (default: the model's
    ``state_dict``, i.e. a checkpoint of bare weights; a trainer's
    ``TrainState`` template with ``extract`` mapping the
    :class:`~apex_tpu_torch.checkpoint.Restored` to the weights), and
    ``watch_from_step`` is the step the served weights came from.
    ``telemetry`` pins a recorder (the module docstring's events); None
    takes the active one."""

    def __init__(self, model, *,
                 buckets: Sequence[int] = (128, 256),
                 page_size: int = 16,
                 max_seqs: int = 4,
                 n_pages: Optional[int] = None,
                 max_queue: int = 64,
                 cache_dtype=None,
                 device=None,
                 watch_dir: Optional[str] = None,
                 extract: Optional[Callable] = None,
                 poll_every_s: float = 1.0,
                 watch_from_step: Optional[int] = None,
                 watch_like=None,
                 telemetry=None):
        self.device = resolve_device(device)
        self._telemetry = telemetry
        self._t_rate: Optional[float] = None  # the tokens/s gauge's anchor
        #: with no exporter, the seconds without a decode step after which
        #: the tokens/s gauge reads 0 (with one, its ``every_s``)
        self.rate_idle_s = 5.0
        buckets = sorted(int(b) for b in buckets)
        if not buckets:
            raise ValueError("need at least one sequence-length bucket")
        for b in buckets:
            if b % page_size:
                raise ValueError(f"bucket {b} must divide by page_size "
                                 f"{page_size}")
            if b > model.max_len:
                raise ValueError(f"bucket {b} exceeds model.max_len "
                                 f"{model.max_len}")
        self.model = model.to(self.device).eval()
        self.buckets = tuple(buckets)
        self.page_size = int(page_size)
        self.max_seqs = int(max_seqs)
        if n_pages is None:
            n_pages = 1 + self.max_seqs * (buckets[-1] // page_size)
        self.pool_k, self.pool_v = _kv.make_pool(
            model, n_pages, page_size, device=self.device, dtype=cache_dtype)
        #: the pool's storage dtype ("int8" for an int8 cache)
        self.kv_cache_dtype = _kv.storage_dtype(self.pool_k)
        self.pages = _kv.PageAllocator(n_pages)
        self._slots: List[Optional[_Active]] = [None] * self.max_seqs
        # per-slot decode state (host): current write position, last
        # sampled token, generated tokens so far
        self._pos = np.zeros((self.max_seqs,), np.int64)
        self._tok = np.zeros((self.max_seqs,), np.int64)
        self._gen: List[List[int]] = [[] for _ in range(self.max_seqs)]
        self.max_queue = int(max_queue)
        self._queue: List[tuple] = []   # (Request, Completion, t, trace, root)
        self._qlock = threading.Lock()
        self._qcond = threading.Condition(self._qlock)
        #: ``prefill_s`` / ``decode_s``: host seconds spent in prefills
        #: and decode steps, each ending in its token's copy to the host;
        #: ``captures`` graphs captured, ``replays`` graph replays,
        #: ``aot_misses`` steps that found no table entry, ``recaptures``
        #: graphs captured again after the weights moved
        self.stats = {"submitted": 0, "completed": 0, "rejected": 0,
                      "tokens_out": 0, "decode_steps": 0, "prefills": 0,
                      "prefill_s": 0.0, "decode_s": 0.0,
                      "aot_misses": 0, "captures": 0, "replays": 0,
                      "recaptures": 0, "hotswaps": 0, "swap_s": None,
                      "kv_bytes_per_token": _kv.kv_bytes_per_token(
                          model, cache_dtype)}
        # the AOT table: signature -> (kind, bucket, captured step, or
        # the plain body on the CPU); the host input vector of each
        # (kind, bucket); the weights' versions the table was made for
        self._aot: dict = {}
        self._host: dict = {}
        self._pool = None
        self._captured: dict = {}     # program -> captures (retrace events)
        self._weights, self._weights_seen = self._weight_versions()
        self.watcher: Optional[WeightWatcher] = None
        if watch_dir is not None:
            if watch_like is None:
                watch_like = self.model.state_dict()
            self.watcher = WeightWatcher(
                watch_dir, like=watch_like, extract=extract,
                poll_every_s=poll_every_s,
                initial_step=watch_from_step, telemetry=telemetry).start()
        self._serve_stop = threading.Event()
        self._serve_thread: Optional[threading.Thread] = None
        self._closed = False

    # -- telemetry ------------------------------------------------------------
    def _rec(self):
        return (self._telemetry if self._telemetry is not None
                else _events.get_recorder())

    def _event(self, phase: str, **fields) -> None:
        rec = self._rec()
        if rec is not None:
            rec.event("serving", phase=phase, **fields)

    def _tracer(self):
        rec = self._rec()
        return getattr(rec, "tracer", None) if rec is not None else None

    def _gauges(self) -> None:
        """The serving gauges at a scheduler step's end (JAX's)."""
        rec = self._rec()
        if rec is None:
            return
        with self._qlock:
            depth = len(self._queue)
        rec.metrics.gauge("serving_queue_depth").set(depth)
        rec.metrics.gauge("serving_active_seqs").set(
            sum(1 for s in self._slots if s is not None))
        rec.metrics.gauge("serving_kv_page_occupancy_pct").set(
            self.pages.occupancy_pct)
        rec.metrics.gauge("serving_kv_bytes_per_token").set(
            self.stats["kv_bytes_per_token"])
        # with no decode step within the export interval the rate gauge
        # reads 0, and the next burst's first sample has no anchor
        if self._t_rate is not None:
            exp = getattr(rec, "exporter", None)
            idle_s = exp.every_s if exp is not None else self.rate_idle_s
            if time.perf_counter() - self._t_rate > idle_s:
                rec.metrics.gauge("serving_tokens_per_s").set(0.0)
                self._t_rate = None
        for key in ("aot_misses", "rejected"):
            c = rec.metrics.counter(f"serving_{key}")
            delta = self.stats[key] - c.value
            if delta > 0:
                c.inc(delta)
        rec.run_info["kv_cache_dtype"] = self.kv_cache_dtype

    # -- bucketed step programs ---------------------------------------------
    def _bucket_for(self, total_len: int) -> Optional[int]:
        for b in self.buckets:
            if total_len <= b:
                return b
        return None

    @torch.inference_mode()
    def _prefill(self, bucket: int, pages, tokens, length) -> torch.Tensor:
        """Run one padded ``[1, bucket]`` prompt, write its K/V into
        ``pages``, return the greedy next token (a device scalar).
        ``length``, the prompt's length, is a device tensor, so the last
        position is an ``index_select`` (clamped into the bucket, as
        JAX's ``dynamic_index_in_dim`` clamps)."""
        model = self.model
        shape = (1, bucket) + self.pool_k.shape[3:]
        zeros = [(torch.zeros(shape, dtype=self.pool_k.dtype,
                              device=self.device),
                  torch.zeros(shape, dtype=self.pool_v.dtype,
                              device=self.device))
                 for _ in range(model.num_layers)]
        logits, caches = model(
            tokens, kv_caches=zeros,
            positions=torch.zeros((1,), dtype=torch.long,
                                  device=self.device))
        _kv.scatter_prefill(self.pool_k, pages,
                            torch.stack([k[0] for k, _ in caches]))
        _kv.scatter_prefill(self.pool_v, pages,
                            torch.stack([v[0] for _, v in caches]))
        last = (length.reshape(1) - 1).clamp(0, bucket - 1)
        return torch.argmax(logits[0].index_select(0, last)[0], dim=-1)

    @torch.inference_mode()
    def _decode(self, tables, positions, tokens) -> torch.Tensor:
        """One batched single-token step over every slot; returns the
        greedy next token per slot ``[S]``."""
        caches = _kv.gather_views(self.pool_k, self.pool_v, tables)
        logits, new = self.model(tokens[:, None], kv_caches=caches,
                                 positions=positions)
        slot = torch.arange(positions.shape[0], device=self.device)
        k_tok = torch.stack([k[slot, positions] for k, _ in new])
        v_tok = torch.stack([v[slot, positions] for _, v in new])
        pid = tables[slot, positions // self.page_size]
        off = positions % self.page_size
        _kv.scatter_token(self.pool_k, pid, off, k_tok)
        _kv.scatter_token(self.pool_v, pid, off, v_tok)
        return torch.argmax(logits[:, -1, :], dim=-1)

    # -- the AOT table ---------------------------------------------------------
    def _args_len(self, kind: str, bucket: int) -> int:
        n_pages_b = bucket // self.page_size
        if kind == "prefill":
            return n_pages_b + bucket + 1
        return self.max_seqs * (n_pages_b + 2)

    def _host_args(self, kind: str, bucket: int) -> torch.Tensor:
        """The (kind, bucket) step's int64 input vector on the host,
        pinned on CUDA, made once and rewritten by every step (the step
        before it ended in a read that waited for its copy)."""
        buf = self._host.get((kind, bucket))
        if buf is None:
            buf = self._host[(kind, bucket)] = torch.zeros(
                self._args_len(kind, bucket), dtype=torch.int64,
                pin_memory=self.device.type == "cuda")
        return buf

    def _body(self, kind: str, bucket: int):
        """The step function of (kind, bucket) on its input vector:
        :meth:`_prefill` or :meth:`_decode` on views of it (moved to the
        device first; in a graph it is there already)."""
        n_pages_b = bucket // self.page_size
        s = self.max_seqs

        def prefill(packed):
            packed = packed.to(self.device, non_blocking=True)
            return self._prefill(
                bucket, packed[:n_pages_b],
                packed[n_pages_b:n_pages_b + bucket].reshape(1, bucket),
                packed[n_pages_b + bucket:])

        def decode(packed):
            packed = packed.to(self.device, non_blocking=True)
            at = s * n_pages_b
            return self._decode(packed[:at].reshape(s, n_pages_b),
                                packed[at:at + s], packed[at + s:])
        return prefill if kind == "prefill" else decode

    def _capture(self, kind: str, bucket: int):
        """(kind, bucket)'s step captured on a template input that touches
        only the trash page (all-zero pages and tables, prompt length 1);
        the plain body on the CPU."""
        if self.device.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        template = torch.zeros(self._args_len(kind, bucket),
                               dtype=torch.int64)
        if kind == "prefill":
            template[-1] = 1
        t0 = time.perf_counter()
        step = _cache.warmup(self._body(kind, bucket), template,
                             device=self.device, pool=self._pool)
        if isinstance(step, _cache.Captured):
            self.stats["captures"] += 1
            rec = self._rec()
            if rec is not None:
                # a capture is the engine's compile: the first of a
                # (kind, bucket), or again after the weights moved (the
                # same signature)
                program = f"{kind}[{bucket}]"
                seen = self._captured.get(program, 0)
                self._captured[program] = seen + 1
                rec.event("retrace", program=program,
                          step=self.stats["decode_steps"],
                          n_traces=seen + 1, first=seen == 0,
                          new_sig=seen == 0,
                          sig=f"int64[{self._args_len(kind, bucket)}]",
                          dur=round(time.perf_counter() - t0, 6))
        return step

    def _weight_versions(self) -> tuple:
        """The model's parameters and buffers as they are now, and the key
        of each: its identity, version and data address.  The engine
        holds the tensors of the last key, so an identity stays unique
        while it is compared."""
        weights = [*self.model.parameters(), *self.model.buffers()]
        return weights, tuple((id(w), w._version, w.data_ptr())
                              for w in weights)

    def _check_weights(self) -> None:
        """Capture every graph again when a weight moved since the table
        was made: updated in place, or replaced by another tensor
        (``load_state_dict(assign=True)``, a new ``nn.Parameter``).  A
        graph reads the tensors it captured, and at O4 the int8 weights
        prepared from them."""
        weights, seen = self._weight_versions()
        if seen == self._weights_seen:
            return
        self._weights, self._weights_seen = weights, seen
        if self.device.type != "cuda":
            return
        entries = [(key, kind, bucket)
                   for key, (kind, bucket, _) in self._aot.items()]
        self._aot.clear()              # free the old graphs first
        for key, kind, bucket in entries:
            self._aot[key] = (kind, bucket, self._capture(kind, bucket))
            self.stats["recaptures"] += 1

    def _dispatch(self, kind: str, bucket: int, args: tuple):
        """Replay (kind, bucket)'s captured step on ``args`` (the host
        input vector), as JAX's ``_dispatch`` calls the compiled
        executable; a (kind, bucket) not in the table is captured now and
        counted in ``stats["aot_misses"]``.  Returns the step's token(s)
        on the device."""
        self._check_weights()
        key = _cache.signature(args, static=(kind, bucket))
        entry = self._aot.get(key)
        if entry is None:
            self.stats["aot_misses"] += 1
            entry = self._aot[key] = (kind, bucket,
                                      self._capture(kind, bucket))
        step = entry[2]
        if isinstance(step, _cache.Captured):
            self.stats["replays"] += 1
        return step(*args)

    def warmup(self, buckets: Optional[Sequence[int]] = None
               ) -> "ServingEngine":
        """Capture prefill and decode of every bucket before traffic
        (each run once on the trash page, then captured), so serving
        captures nothing.  On the CPU it fills the table with the plain
        bodies."""
        self._check_weights()
        for b in (self.buckets if buckets is None else buckets):
            for kind in ("prefill", "decode"):
                key = _cache.signature((self._host_args(kind, b),),
                                       static=(kind, b))
                if key not in self._aot:
                    self._aot[key] = (kind, b, self._capture(kind, b))
        return self

    # -- request intake ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               stop_token: Optional[int] = None,
               block: bool = True,
               timeout: Optional[float] = None) -> Completion:
        """Enqueue one request; returns its :class:`Completion`.  The
        queue is bounded (``max_queue``): when full, ``block=True`` waits
        and ``block=False`` raises ``RuntimeError``."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        req = Request(prompt, int(max_new_tokens), stop_token)
        comp = Completion()
        # trace sampling: one counter step a request; a sampled request
        # gets its trace id and root span id here, so every later phase
        # parents to it
        tracer = self._tracer()
        trace = tracer.sample() if tracer is not None else None
        root = tracer.next_span_id() if trace is not None else None
        with self._qcond:
            if self._closed:
                raise RuntimeError("ServingEngine is closed")
            while len(self._queue) >= self.max_queue:
                if not block:
                    raise RuntimeError(
                        f"request queue full ({self.max_queue})")
                if not self._qcond.wait(timeout=timeout or 30.0):
                    raise TimeoutError("request queue stayed full")
                if self._closed:
                    raise RuntimeError("ServingEngine is closed")
            self._queue.append((req, comp, time.perf_counter(), trace,
                                root))
            depth = len(self._queue)
        self.stats["submitted"] += 1
        rec = self._rec()
        if rec is not None:
            fields = {} if trace is None else {"trace": trace}
            rec.event("serving", phase="submit", prompt_len=int(prompt.size),
                      max_new=int(max_new_tokens), queue_depth=depth,
                      **fields)
            rec.metrics.gauge("serving_queue_depth").set(depth)
        return comp

    # -- scheduler ----------------------------------------------------------
    def step(self) -> bool:
        """One scheduler iteration: adopt staged weights, admit what
        fits, run one batched decode step.  Returns True when any work
        was done."""
        did = self._adopt_weights()
        did = self._admit() or did
        did = self._decode_once() or did
        self._gauges()
        return did

    def _adopt_weights(self) -> bool:
        """Copy the watcher's staged weights into the model in place and
        capture the graphs again (between two dispatches)."""
        if self.watcher is None:
            return False
        staged = self.watcher.take()
        if staged is None:
            return False
        t0 = time.perf_counter()
        step, weights = staged
        self.model.load_state_dict(weights)
        self._check_weights()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["swap_s"] = time.perf_counter() - t0
        self.stats["hotswaps"] += 1
        self._event("hotswap", step=step,
                    in_flight=sum(1 for s in self._slots if s is not None))
        tracer = self._tracer()
        if tracer is not None:
            # the swap joins every traced request in flight
            for act in self._slots:
                if act is not None and act.trace is not None:
                    tracer.emit("hotswap", act.trace, parent=act.root,
                                step=step)
        return True

    def run_until_idle(self, max_steps: int = 100000) -> None:
        """Drive :meth:`step` until queue and slots are empty.  Refuses
        to run beside an active :meth:`start` thread (two loops would
        race the scheduler state and the pool)."""
        if self._serve_thread is not None and self._serve_thread.is_alive():
            raise RuntimeError(
                "run_until_idle() cannot drive the scheduler while the "
                "start() serve thread is running — submit() and wait on "
                "the Completions instead")
        for _ in range(max_steps):
            with self._qlock:
                queued = len(self._queue)
            active = any(s is not None for s in self._slots)
            if not queued and not active:
                return
            self.step()
        raise RuntimeError(f"not idle after {max_steps} scheduler steps")

    def generate(self, prompts: Sequence, max_new_tokens: int, *,
                 timeout: Optional[float] = 600.0,
                 **kw) -> List[ServedResult]:
        """Closed-loop convenience: submit every prompt, wait for all,
        return results in order.  With the :meth:`start` thread running
        it only submits and waits; otherwise it drives the scheduler on
        this thread."""
        threaded = (self._serve_thread is not None
                    and self._serve_thread.is_alive())
        comps = [self.submit(p, max_new_tokens, **kw) for p in prompts]
        if not threaded:
            self.run_until_idle()
        return [c.result(timeout=timeout if threaded else 0)
                for c in comps]

    def _admit(self) -> bool:
        admitted = False
        while True:
            free_slot = next((i for i, s in enumerate(self._slots)
                              if s is None), None)
            if free_slot is None:
                break
            with self._qcond:
                if not self._queue:
                    break
                req, comp, t_submit, trace, root = self._queue[0]
                bucket = self._bucket_for(req.prompt.size
                                          + req.max_new_tokens)
                if bucket is None:
                    # fits no bucket: reject (never silently truncate)
                    self._queue.pop(0)
                    self._qcond.notify_all()
                    reject = True
                else:
                    pages = self.pages.alloc(bucket // self.page_size)
                    if pages is None:
                        break           # no pages free: wait for evictions
                    self._queue.pop(0)
                    self._qcond.notify_all()
                    reject = False
            if reject:
                self.stats["rejected"] += 1
                self._event("reject", prompt_len=int(req.prompt.size),
                            max_new=req.max_new_tokens)
                comp._set(ServedResult(
                    tokens=np.zeros((0,), np.int64), timings={},
                    error=f"prompt {req.prompt.size} + max_new "
                          f"{req.max_new_tokens} fits no bucket "
                          f"(max {self.buckets[-1]})"))
                continue
            self._prefill_into(free_slot, req, comp, t_submit, bucket, pages,
                               trace, root)
            admitted = True
        return admitted

    def _prefill_into(self, slot: int, req: Request, comp: Completion,
                      t_submit: float, bucket: int, pages: List[int],
                      trace: Optional[str] = None,
                      root: Optional[str] = None) -> None:
        t_admit = time.perf_counter()
        tracer = self._tracer() if trace is not None else None
        if tracer is not None:
            # ends now and starts back at submit: the waterfall's first bar
            tracer.emit("queue", trace, parent=root, dur=t_admit - t_submit,
                        slot=slot, bucket=bucket)
        host = self._host_args("prefill", bucket)
        args = host.numpy()
        n_pages_b = len(pages)
        args[:n_pages_b] = pages
        args[n_pages_b:n_pages_b + bucket] = 0
        args[n_pages_b:n_pages_b + req.prompt.size] = req.prompt
        args[-1] = req.prompt.size
        with torch.profiler.record_function(f"prefill[{bucket}]"):
            nxt = self._dispatch("prefill", bucket, (host,))
            # response boundary: the first token must reach the host — it
            # seeds the decode batch and may already finish the request
            first = int(nxt)
        t_done = time.perf_counter()
        self.stats["prefills"] += 1
        self.stats["prefill_s"] += t_done - t_admit
        rec = self._rec()
        if rec is not None:
            rec.event("serving", phase="admit", slot=slot, bucket=bucket,
                      prompt_len=int(req.prompt.size),
                      queue_wait=round(t_admit - t_submit, 6),
                      prefill_dur=round(t_done - t_admit, 6))
            if tracer is not None:
                tracer.emit("prefill", trace, parent=root,
                            dur=t_done - t_admit, slot=slot, bucket=bucket,
                            prompt_len=int(req.prompt.size))
            rec.metrics.histogram("serving_queue_wait_s").observe(
                t_admit - t_submit)
            rec.metrics.histogram("serving_prefill_s").observe(
                t_done - t_admit)
        self._slots[slot] = _Active(req, comp, bucket, pages, t_submit,
                                    t_admit, t_done, trace, root)
        self._pos[slot] = req.prompt.size
        self._tok[slot] = first
        self._gen[slot] = [first]
        if req.max_new_tokens == 1 or first == req.stop_token:
            self._finish(slot)

    def _decode_once(self) -> bool:
        live = [i for i, s in enumerate(self._slots) if s is not None]
        if not live:
            return False
        # one batched step at the smallest bucket covering every live
        # sequence's NEXT position
        bucket = self._bucket_for(int(max(self._pos[i] for i in live)) + 1)
        n_pages_b = bucket // self.page_size
        s = self.max_seqs
        host = self._host_args("decode", bucket)
        args = host.numpy()
        tables = args[:s * n_pages_b].reshape(s, n_pages_b)
        tables[:] = 0
        for i in live:
            tables[i] = self.pages.padded_row(self._slots[i].pages,
                                              n_pages_b)
        args[s * n_pages_b:s * n_pages_b + s] = self._pos
        args[s * n_pages_b + s:] = self._tok
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"decode[{bucket}]"):
            nxt = self._dispatch("decode", bucket, (host,))
            toks = nxt.cpu().numpy()     # the per-step response boundary
        dur = time.perf_counter() - t0
        self.stats["decode_s"] += dur
        self.stats["decode_steps"] += 1
        self.stats["tokens_out"] += len(live)
        rec = self._rec()
        if rec is not None:
            self._note_decode(rec, live, bucket, dur)
        for i in live:
            self._pos[i] += 1
            tok = int(toks[i])
            self._tok[i] = tok
            self._gen[i].append(tok)
            act = self._slots[i]
            if (len(self._gen[i]) >= act.request.max_new_tokens
                    or tok == act.request.stop_token):
                self._finish(i)
        return True

    def _note_decode(self, rec, live: List[int], bucket: int,
                     dur: float) -> None:
        """One decode step's event, its span for each traced request in
        it (finished in this step or not), the step histogram and the
        tokens/s gauge."""
        rec.event("serving", phase="decode", active=len(live),
                  bucket=bucket, dur=round(dur, 6))
        tracer = self._tracer()
        if tracer is not None:
            for i in live:
                act = self._slots[i]
                if act.trace is not None:
                    tracer.emit("decode_step", act.trace, parent=act.root,
                                dur=dur, slot=i, bucket=bucket,
                                batch_size=len(live))
        rec.metrics.histogram("serving_decode_step_s").observe(dur)
        now = time.perf_counter()
        if self._t_rate is not None:
            rec.metrics.gauge("serving_tokens_per_s").set(
                len(live) / max(now - self._t_rate, 1e-9))
        self._t_rate = now

    def _finish(self, slot: int) -> None:
        act = self._slots[slot]
        gen = self._gen[slot]
        req = act.request
        if req.stop_token is not None and req.stop_token in gen:
            gen = gen[:gen.index(req.stop_token) + 1]
        t_done = time.perf_counter()
        decode_s = t_done - act.t_prefill_done
        ttft_s = act.t_prefill_done - act.t_submit
        tpot_s = (decode_s / (len(gen) - 1)
                  if decode_s > 0 and len(gen) > 1 else None)
        timings = {
            "queue_wait_s": act.t_admit - act.t_submit,
            "prefill_s": act.t_prefill_done - act.t_admit,
            "decode_s": decode_s,
            "total_s": t_done - act.t_submit,
            "ttft_s": ttft_s,
            "tpot_s": tpot_s,
            "tok_per_s": ((len(gen) - 1) / decode_s
                          if decode_s > 0 and len(gen) > 1 else None),
        }
        self.pages.free(act.pages)
        self._slots[slot] = None
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._gen[slot] = []
        self.stats["completed"] += 1
        rec = self._rec()
        if rec is not None:
            rec.metrics.histogram("serving_ttft_s").observe(ttft_s)
            if tpot_s is not None:
                rec.metrics.histogram("serving_tpot_s").observe(tpot_s)
            rec.metrics.histogram("serving_e2e_s").observe(
                timings["total_s"])
            fields = {} if act.trace is None else {"trace": act.trace}
            rec.event("serving", phase="done", slot=slot, bucket=act.bucket,
                      n_tokens=len(gen), **fields, **timings)
            tracer = self._tracer() if act.trace is not None else None
            if tracer is not None:
                # the root, last, with the span id allocated at submit
                tracer.emit("request", act.trace, span=act.root,
                            dur=timings["total_s"], slot=slot,
                            bucket=act.bucket, n_tokens=len(gen),
                            ttft_s=round(ttft_s, 6))
        act.completion._set(ServedResult(
            tokens=np.asarray(gen, np.int64), timings=timings,
            bucket=act.bucket))

    # -- threaded serving ----------------------------------------------------
    def start(self) -> "ServingEngine":
        """Run the scheduler on a background thread (idempotent): callers
        just :meth:`submit` and wait."""
        if self._serve_thread is None or not self._serve_thread.is_alive():
            self._serve_stop.clear()
            self._serve_thread = threading.Thread(
                target=self._serve_loop, daemon=True,
                name="apex-tpu-torch-serving")
            self._serve_thread.start()
        return self

    def _serve_loop(self) -> None:
        while not self._serve_stop.is_set():
            if not self.step():
                self._serve_stop.wait(0.002)    # idle: don't spin

    def close(self) -> None:
        """Stop the serve thread and the weight watcher; fail queued AND
        in-flight requests so no caller waits forever, and return their
        KV pages."""
        with self._qcond:
            if self._closed:
                return
            self._closed = True
        if self.watcher is not None:
            self.watcher.close()
        self._serve_stop.set()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)
            self._serve_thread = None
        with self._qcond:
            abandoned, self._queue = self._queue, []
            self._qcond.notify_all()
        closed = ServedResult(tokens=np.zeros((0,), np.int64),
                              timings={}, error="engine closed")
        for _req, comp, _t, _trace, _root in abandoned:
            comp._set(closed)
        for i, act in enumerate(self._slots):
            if act is None:
                continue
            self.pages.free(act.pages)
            self._slots[i] = None
            act.completion._set(closed)
        self._aot.clear()              # the graphs and their pool
        self._pool = None

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
