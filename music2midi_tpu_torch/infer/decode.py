"""Autoregressive decode over a static KV cache, as one captured program.

Port of ``music2midi_tpu/infer/decode.py::generate_tokens``:
decoder_start = 1, ``suppress_tokens`` masked to -inf before the
selection, greedy argmax or temperature / top-k sampling, finished rows
emit PAD, and the loop exits once every row has emitted EOS.

The JAX loop is one compiled ``while_loop``.  Here the loop is a
``DecodeProgram``: static state for one key (batch width, encoder
length, ``T5Config``, ``DecodeConfig``, device) allocated once and reused
by every generation with that key -- tokens, done, the step (a 0-d int32
on the device), the token, the self cache, the cross-KV buffers
(transposed under ``pallas_cross``), the decode parameters, the bias rows,
the int8 kernel's launch plan and the suppression index.  A generation
copies its cross-KV and the decode parameters into those buffers and
resets tokens, done, step and token (the prologue); then one body of
``unroll`` decode steps (``models/t5.py::decode_step`` with the device
step) runs until every row is done or ``max_length - 1`` tokens are
generated, with one read-back of ``done`` a body.  On a CUDA device the
body is a CUDA graph: the first body of a phase runs eagerly (it warms
up what the capture records), the next is captured on a side stream, and
every later one, in this generation and the next, replays the graph, so
that a body costs the host one graph launch where it cost ~85 kernel
launches.  A capture that fails raises; nothing falls back to the eager
loop.  On the CPU the same body runs eagerly over the same static state.

As in JAX the token buffer is padded to ``1 + ceil((max_length - 1) /
unroll) * unroll`` so that a body never writes past it, and the output is
cut to ``max_length``: tokens do not depend on ``unroll``.  The int8
kernel route reads the step's keys itself, so its program has one phase
over the whole cache; the plain attention routes read a static prefix
with the keys after the step masked, so their programs grow the prefix in
phases (64, 128, ... the cache's length), one graph each, as the JAX loop
grows its cache, and a step at the start of a 1024-key cache does not
read all of it.

``generate_tokens`` runs the program of its key, kept per model (the
eight most recent keys); ``generate_tokens_eager`` is its plain twin, the
same body over a fresh program's state with nothing captured, which the
tests and ``chip_smoke.py`` hold the captured program against.  Launch
counts stay true under replay: a capture records how many launches of
each kernel wrapper its graph holds, and a replay adds them.  A
generation is one ``decode`` span (``profiling.span``, recorded while a
profiler or ``profiling.recording()`` is on) with its ``steps``, its
``syncs`` (host reads of the device: one ``done`` check a body), its
graph ``replays``, the ``captures`` made inside it and its
``fused_launches``, the launches of the step's fused glue (kernels 7-10,
``ops/decode_fused.py``; counted over all threads while it runs).

A greedy step selects its tokens and advances the loop's state in one
kernel (``greedy_commit``); sampling keeps its chain of ATen ops, and the
hybrid decoder's loop keeps that chain for every step.

A program's state is one generation's at a time: ``run`` holds the
program's lock from the prologue to the copy of its output, so that two
threads that decode with one key (``Music2MIDI.generate`` from the web
UI's request threads, say) take turns; ``program_for`` holds the model's
table under a lock of its own.

Sampling draws from a ``torch.Generator`` on the decode device, by the
Gumbel-max rule ``jax.random.categorical`` uses.  The program owns one
generator, registered with its graphs, and takes the caller's state into
it at the prologue (and hands it back at the end), so a replay draws what
the eager loop draws from the caller's generator.  JAX's random bits
cannot be reproduced, so sampled tokens are held to their distribution
and to one seed giving one sequence, not to JAX's tokens.

A tensor-parallel shard of the model (``T5Model.tp_group``, its local
config) decodes its heads and hidden units; each layer's o and wo
products are summed over tp by an all-reduce, which leaves every tp rank
the same logits, so the ranks take the same steps and leave the loop
together.  Its program runs eagerly on a card too (``captures``): a gloo
collective cannot be captured in a CUDA graph, and capturing NCCL's is
not done here.

``HybridDecodeProgram`` is the same loop over the hybrid decoder
(``models/granite_hybrid.py``): its static state is the Mamba layers'
SSM states and conv tails beside the attention layer's KV cache, its
prologue the prefill over the prefix (a ``prefill`` span), and its step
``granite_hybrid.decode_step`` at position ``enc_len + step``; the MoE's
routing counters are added up in the graph and read once a generation.
``generate_tokens`` picks it for a ``GraniteHybrid`` model.

``DecodeConfig.pallas_attention`` and ``pallas_cross`` keep the JAX field
names: they route the int8 attention blocks through the decode-attention
kernels (``ops/decode_attention.py``), which run as CUDA kernels on CUDA
tensors and as their plain versions on CPU tensors; the int8 kernel's
calls go through a launch plan built once per program over its caches
(``models/t5.py::int8_attention_plan``).  The JAX package's conditions of
a TPU backend and a batch multiple of its block do not apply; as there,
``pallas_cross`` is ignored unless the KV is quantized at 8 bits.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..models import granite_hybrid as _gh
from ..models.t5 import (
    CrossKV,
    T5Config,
    T5Model,
    decode_step,
    decoder_bias_rows,
    init_kv_cache,
    int8_attention_plan,
    precompute_cross_kv,
    prepare_decode_params,
    transpose_cross_kv,
)
from ..ops import decode_attention as _da
from ..ops import decode_fused as _df
from ..ops import ssm_state_update as _ssu
from ..profiling import span


class DecodeConfig(NamedTuple):
    max_length: int = 1024  # total length including the start token
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no top-k filtering
    suppress_tokens: tuple = ()  # token ids masked to -inf before selection
    quantize_kv: bool = False  # quantized self- and cross-KV (serving mode)
    # int8 weight-only quantization of every decode projection
    # (models/t5.py::_quantize_w, per-column scales)
    quantize_weights: bool = False
    # with quantize_kv: every int8 attention block through
    # decode_attention_int8 with round_pv (the CUDA kernel on a CUDA tensor)
    pallas_attention: bool = False
    # with quantize_kv at 8 bits: the cross-KV stored transposed
    # (B, H, D, L) once per generation, and the cross blocks through
    # decode_attention_cross_t
    pallas_cross: bool = False
    unroll: int = 1  # decode steps between two EOS read-backs
    kv_bits: int = 8  # quantized-KV width: 8 (+-127) or 4 (+-7, in int8)


def suppression_index(dcfg: DecodeConfig, device) -> Optional[torch.Tensor]:
    """The ids ``suppress_tokens`` masks, as an int64 index on ``device``
    (None when none is): built once per program, so that the step's mask
    is a launch and not a host-to-device copy."""
    if not dcfg.suppress_tokens:
        return None
    return torch.tensor(sorted(set(dcfg.suppress_tokens)), dtype=torch.long,
                        device=device)


def _select_next(logits: torch.Tensor, dcfg: DecodeConfig,
                 generator: Optional[torch.Generator],
                 suppress: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, vocab) logits -> (B,) int32 next tokens: suppressed ids to
    -inf, then the argmax (temperature 0), or a draw from
    softmax(logits / temperature) over the top_k largest (all when 0):
    the argmax of the scaled logits plus Gumbel noise from ``generator``.
    ``suppress``: ``suppression_index``'s tensor (made here when None).
    Writes into ``logits``."""
    if suppress is None:
        suppress = suppression_index(dcfg, logits.device)
    if suppress is not None:
        logits.index_fill_(1, suppress, -float("inf"))
    if dcfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / dcfg.temperature
    if dcfg.top_k > 0:
        kth = torch.topk(scaled, dcfg.top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, -float("inf"), scaled)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)


def _phase_lengths(cache_len: int, plain: bool) -> List[int]:
    """The static prefixes the body reads: the whole cache for the int8
    kernel route; 64, 128, ... and then the cache's length for the plain
    routes (the JAX loop's phases)."""
    if not plain:
        return [cache_len]
    out, p = [], 64
    while p < cache_len:
        out.append(p)
        p *= 2
    return out + [cache_len]


def _copy_into(dst, src) -> None:
    """Copy a tree of tensors (dicts, lists, tuples) into one of the same
    shapes, leaf by leaf; a leaf that is the source tensor stays."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif dst is not src:
        dst.copy_(src)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    launches: tuple  # per counted wrapper, the launches one replay makes
    capture_s: float


def _counted() -> tuple:
    """The kernel wrappers whose launch counts a graph carries."""
    return (_da.decode_attention_int8, _da.decode_attention_cross_t,
            _ssu.ssm_state_update, *_df.wrappers())


def _fused_launches() -> int:
    """Kernels 7-10's launches so far (``ops/decode_fused.py``)."""
    return sum(w.launches for w in _df.wrappers())


def captures(model: T5Model, device) -> bool:
    """Whether ``model``'s decode programs on ``device`` run as CUDA
    graphs: on a card, unless the model is a tp shard (its loop holds
    all-reduces, and runs eagerly)."""
    return torch.device(device).type == "cuda" and model.tp_group is None


class DecodeProgram:
    """The decode loop of one key, over static state; see the module
    docstring.  ``run`` captures where ``captures`` says so and runs
    eagerly otherwise."""

    def __init__(self, model: T5Model, cfg: T5Config, dcfg: DecodeConfig,
                 batch: int, enc_len: int, device):
        dev = torch.device(device)
        self.cfg, self.dcfg, self.device = cfg, dcfg, dev
        self.tp_group = model.tp_group
        self.captures = captures(model, dev)
        self.unroll = max(1, int(dcfg.unroll))
        self.n_gen = dcfg.max_length - 1
        self.buf_len = 1 + -(-self.n_gen // self.unroll) * self.unroll
        cache_len = max(dcfg.max_length, self.buf_len - 1)
        quant = dcfg.quantize_kv
        self.transposed = bool(dcfg.pallas_cross and quant
                               and dcfg.kv_bits == 8)
        with torch.no_grad():
            zeros = torch.zeros(batch, enc_len, cfg.d_model, dtype=cfg.dtype,
                                device=dev)
            cross = precompute_cross_kv(model, zeros, cfg, quantize=quant,
                                        bits=dcfg.kv_bits)
            self.cross: CrossKV = (transpose_cross_kv(cross)
                                   if self.transposed else cross)
            self.dparams = prepare_decode_params(
                model, cfg, quantize_weights=dcfg.quantize_weights)
            # float32 (exact from bf16) and contiguous: the plan keeps
            # these very rows, so the prologue's refill reaches the kernel
            self.bias_rows = decoder_bias_rows(
                self.dparams["rel_bias"], cache_len, cfg).float().contiguous()
        self.cache = init_kv_cache(batch, cache_len, cfg, quantize=quant,
                                   device=dev, bits=dcfg.kv_bits)
        self.plan = int8_attention_plan(self.cache, self.cross,
                                        self.bias_rows, cfg.dtype) \
            if dcfg.pallas_attention and quant else None
        self.suppress = suppression_index(dcfg, dev)
        self.phases = _phase_lengths(cache_len, self.plan is None)
        self.first_pos = 0  # the cache position of the start token
        self._loop_state(batch, dev)

    def _loop_state(self, batch: int, dev: torch.device) -> None:
        """The loop's own static state: tokens, token, done, step, the
        generator, the graphs and the lock."""
        dcfg = self.dcfg
        self.tokens = torch.empty((batch, self.buf_len), dtype=torch.int32,
                                  device=dev)
        self.token = torch.empty(batch, dtype=torch.int32, device=dev)
        self.done = torch.empty(batch, dtype=torch.bool, device=dev)
        self.step = torch.zeros((), dtype=torch.int32, device=dev)
        self.generator = (torch.Generator(device=dev)
                          if dcfg.temperature != 0.0 else None)
        self.graphs: dict = {}  # phase length -> _Graph
        self._pool = None
        self._stream = None
        self._lock = threading.Lock()  # one generation at a time

    # ------------------------------------------------------------------ #

    def _prologue(self, model: T5Model, encoder_hidden: torch.Tensor,
                  generator: Optional[torch.Generator]) -> None:
        cfg, dcfg = self.cfg, self.dcfg
        fresh = precompute_cross_kv(model, encoder_hidden, cfg,
                                    quantize=dcfg.quantize_kv,
                                    bits=dcfg.kv_bits)
        for dst, src in zip(self.cross.layers, fresh.layers):
            for d, s in zip(dst, src):  # K, then V
                if isinstance(d, tuple):  # int8 (values, scales)
                    d[0].copy_(s[0].transpose(2, 3) if self.transposed
                               else s[0])
                    d[1].copy_(s[1])
                else:
                    d.copy_(s)
        _copy_into(self.dparams, prepare_decode_params(
            model, cfg, quantize_weights=dcfg.quantize_weights))
        self.bias_rows.copy_(decoder_bias_rows(
            self.dparams["rel_bias"], self.bias_rows.shape[1], cfg))
        self._reset(generator)

    def _reset(self, generator: Optional[torch.Generator]) -> None:
        """Tokens, done, step and the generator's state for a new
        generation."""
        cfg = self.cfg
        self.tokens.fill_(cfg.pad_token_id)
        self.tokens[:, 0] = cfg.decoder_start_token_id
        self.token.fill_(cfg.decoder_start_token_id)
        self.done.zero_()
        self.step.zero_()
        if self.generator is not None:
            if generator is None:  # the JAX loop's PRNGKey(0)
                generator = torch.Generator(device=self.device).manual_seed(0)
            self.generator.set_state(generator.get_state())

    def _body(self, phase: int) -> None:
        """``unroll`` decode steps over the static state, in place; the
        keys the plain routes read are the first ``phase``."""
        for _ in range(self.unroll):
            self._commit(self._logits(phase))

    def _commit(self, logits: torch.Tensor) -> None:
        """Select the next tokens from a step's logits and advance the
        loop's state: kernel 10 (``greedy_commit``) when greedy."""
        if self.dcfg.temperature != 0.0:
            return self._commit_chain(logits)
        _df.greedy_commit(logits, self.suppress, self.done, self.tokens,
                          self.token, self.step, self.cfg.pad_token_id,
                          self.cfg.eos_token_id)

    def _commit_chain(self, logits: torch.Tensor) -> None:
        """``_commit`` as a chain of ATen ops, for sampling (and every step
        of the hybrid decoder)."""
        cfg = self.cfg
        nxt = _select_next(logits, self.dcfg, self.generator, self.suppress)
        nxt = torch.where(self.done, cfg.pad_token_id, nxt)
        self.done |= nxt == cfg.eos_token_id
        self.tokens.index_copy_(1, (self.step + 1).view(1).long(),
                                nxt[:, None])
        self.token.copy_(nxt)
        self.step += 1

    def _logits(self, phase: int) -> torch.Tensor:
        """One decode step's logits over the static state."""
        return decode_step(self.dparams, self.token, self.step, self.cache,
                           self.cross, self.cfg, self.bias_rows, self.plan,
                           cache_len=phase, tp_group=self.tp_group)

    def _counters(self, steps: int) -> dict:
        """A generation's counters beyond the loop's, for its span."""
        return {}

    def _capture(self, phase: int) -> _Graph:
        """The body as a CUDA graph on the program's side stream (its
        first run, eager, warms up what is recorded); the counted
        wrappers' launches during the capture are what a replay makes, and
        are taken back off their counts (a capture launches nothing)."""
        wrappers = _counted()
        before = tuple(w.launches for w in wrappers)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        # another thread's host allocation (the staging of the next batch)
        # must not fail the capture; this thread makes no such call in it
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            self._body(phase)
        if self._pool is None:
            self._pool = graph.pool()
        delta = tuple(w.launches - b for w, b in zip(wrappers, before))
        for w, b in zip(wrappers, before):
            w.launches = b
        return _Graph(graph, delta, time.perf_counter() - t0)

    def _iterate(self, phase: int, capture: bool) -> None:
        if not capture:
            self._body(phase)
            return
        g = self.graphs.get(phase)
        if g is not None:
            g.graph.replay()
            for w, n in zip(_counted(), g.launches):
                w.launches += n
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            self._body(phase)
        current.wait_stream(self._stream)
        self.graphs[phase] = self._capture(phase)

    @torch.no_grad()
    def run(self, model: T5Model, encoder_hidden: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            capture: Optional[bool] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One generation -> (tokens (B, max_length) int32, lengths (B,)
        int32), fresh tensors; ``capture`` defaults to ``captures``.
        Another thread's call on this program waits for it."""
        if capture is None:
            capture = self.captures
        if capture and self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device")
        if capture and self.tp_group is not None:
            raise ValueError("a tp shard's decode loop holds collectives; "
                             "it runs eagerly (capture=False)")
        with self._lock:
            return self._run(model, encoder_hidden, generator, capture)

    def _run(self, model: T5Model, encoder_hidden: torch.Tensor,
             generator: Optional[torch.Generator], capture: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        with span("decode") as sp:
            fused = _fused_launches()
            self._prologue(model, encoder_hidden, generator)
            graphs = len(self.graphs)
            # as the JAX loop's phases: a phase runs while a whole body
            # fits its prefix, the last one to n_gen; each body ends in
            # one host read of the device (syncs)
            steps, syncs, finished = 0, 0, False
            for phase in self.phases:
                limit = self.n_gen if phase == self.phases[-1] else \
                    min(self.n_gen, phase - self.first_pos - self.unroll)
                while not finished and steps < limit:
                    self._iterate(phase, capture)
                    steps += self.unroll
                    finished = bool(self.done.all())
                    syncs += 1
            if generator is not None and self.generator is not None:
                generator.set_state(self.generator.get_state())
            max_len = self.dcfg.max_length
            tokens = self.tokens[:, :max_len].clone()
            eos = tokens == self.cfg.eos_token_id
            has_eos = eos.any(dim=1)
            first_eos = eos.to(torch.int8).argmax(dim=1).to(torch.int32)
            lengths = torch.where(has_eos, first_eos + 1,
                                  max_len).to(torch.int32)
            # a body that captures its graph runs eagerly and replays
            # nothing; every other captured body is one replay
            captured = len(self.graphs) - graphs
            sp.set(steps=steps, syncs=syncs, captures=captured,
                   replays=syncs - captured if capture else 0,
                   fused_launches=_fused_launches() - fused,
                   **self._counters(steps))
        return tokens, lengths

    @property
    def capture_seconds(self) -> List[float]:
        """Seconds each phase's capture took (its eager first body
        excluded)."""
        return [g.capture_s for g in self.graphs.values()]


class HybridDecodeProgram(DecodeProgram):
    """The decode loop of the hybrid decoder (``models/granite_hybrid.py``)
    for one key, over static state: per Mamba layer the SSM state and the
    conv tail (fixed size a row), per attention layer a KV cache of the
    prefix's and the generated positions, side by side in one captured
    step.  The prologue is the prefill over the prefix (a ``prefill``
    span, ``rows`` and ``positions``), which fills that state where the
    T5 loop precomputes its cross-KV; the start token is then the first
    captured step, at position ``enc_len``.  Attention reads a static
    prefix of the cache in phases (256, 512, ... its length), as the plain
    T5 routes do.  The MoE's routed tokens per expert and each layer
    step's busiest expert are added up on the card inside the graph and
    read back once a generation, after the loop, into the ``decode``
    span's ``expert_tokens`` (per expert, over layers and steps),
    ``expert_max_sum`` and ``moe_layer_steps``, beside ``ssm_layers``,
    ``state_bytes_per_step`` (the SSM states and conv tails, read and
    written once a step) and ``routed_per_layer_step`` (rows x top-k).
    The program keeps no reference to the model between generations."""

    def __init__(self, model: "_gh.GraniteHybrid", cfg: "_gh.HybridConfig",
                 dcfg: DecodeConfig, batch: int, enc_len: int, device):
        dev = torch.device(device)
        self.cfg, self.dcfg, self.device = cfg, dcfg, dev
        self.tp_group = None
        self.captures = captures(model, dev)
        self.unroll = max(1, int(dcfg.unroll))
        self.n_gen = dcfg.max_length - 1
        self.buf_len = 1 + -(-self.n_gen // self.unroll) * self.unroll
        self.first_pos = enc_len
        cache_len = enc_len + max(dcfg.max_length, self.buf_len - 1)
        self.state = _gh.init_state(model, batch, cache_len, dev)
        n, E = len(model.layers), cfg.num_local_experts
        self.counters = (torch.zeros((n, E), dtype=torch.int64, device=dev),
                         torch.zeros(n, dtype=torch.int64, device=dev))
        self.fixed_counters = {
            "ssm_layers": model.mamba_layers,
            "state_bytes_per_step": 2 * self.state.nbytes_fixed(),
            "routed_per_layer_step": batch * cfg.num_experts_per_tok}
        self.suppress = suppression_index(dcfg, dev)
        self.phases = [p for p in _phase_lengths(cache_len, True)
                       if p > enc_len]
        self._model = None  # the model, during a generation
        self._loop_state(batch, dev)

    def _run(self, model, encoder_hidden, generator, capture):
        self._model = model
        try:
            return super()._run(model, encoder_hidden, generator, capture)
        finally:
            self._model = None

    def _prologue(self, model, encoder_hidden, generator) -> None:
        B, L = encoder_hidden.shape[:2]
        with span("prefill", rows=B, positions=L):
            _gh.prefill(model, encoder_hidden, self.state)
        for c in self.counters:
            c.zero_()
        self._reset(generator)

    def _logits(self, phase: int) -> torch.Tensor:
        return _gh.decode_step(self._model, self.token,
                               self.step + self.first_pos, self.state, phase,
                               self.counters)

    _commit = DecodeProgram._commit_chain

    def _counters(self, steps: int) -> dict:
        per_expert = self.counters[0].sum(0)
        read = torch.cat([per_expert, self.counters[1].sum().view(1)])
        read = read.tolist()  # the one read-back of a generation's counts
        return {**self.fixed_counters, "expert_tokens": read[:-1],
                "expert_max_sum": read[-1],
                "moe_layer_steps": steps * self.counters[1].shape[0]}


def _program_class(model) -> type:
    return HybridDecodeProgram if isinstance(model, _gh.GraniteHybrid) \
        else DecodeProgram


_MAX_PROGRAMS = 8  # keys kept per model
_PROGRAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_PROGRAMS_LOCK = threading.Lock()  # over _PROGRAMS and each model's table


def decode_programs(model: T5Model) -> "OrderedDict":
    """The programs kept for ``model``, by key, oldest first."""
    return _PROGRAMS.setdefault(model, OrderedDict())


def program_for(model: T5Model, encoder_hidden: torch.Tensor, cfg: T5Config,
                dcfg: DecodeConfig) -> DecodeProgram:
    """The program of this key, made on first use (at most
    ``_MAX_PROGRAMS`` kept a model, the least recently used dropped)."""
    B, L = encoder_hidden.shape[:2]
    key = (B, L, cfg, dcfg, encoder_hidden.device)
    with _PROGRAMS_LOCK:
        kept = decode_programs(model)
        prog = kept.pop(key, None)
        if prog is None:
            prog = _program_class(model)(model, cfg, dcfg, B, L,
                                         encoder_hidden.device)
        kept[key] = prog
        while len(kept) > _MAX_PROGRAMS:
            kept.popitem(last=False)
        return prog


@torch.no_grad()
def generate_tokens(
    model: T5Model,
    encoder_hidden: torch.Tensor,  # (B, L, d_model)
    cfg: T5Config,
    dcfg: DecodeConfig = DecodeConfig(),
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens (B, max_length) int32 starting with decoder_start and
    PAD-filled after EOS, lengths (B,) int32 including start and EOS).

    Greedy when ``dcfg.temperature == 0``, else temperature / top-k
    sampling from ``generator`` (on the decode device; a generator seeded
    0 when None, as the JAX loop takes ``PRNGKey(0)``).  The key's
    ``DecodeProgram``: captured and replayed on a CUDA device (unless the
    model is a tp shard), eager on the CPU."""
    return program_for(model, encoder_hidden, cfg, dcfg).run(
        model, encoder_hidden, generator)


@torch.no_grad()
def generate_tokens_eager(
    model: T5Model,
    encoder_hidden: torch.Tensor,
    cfg: T5Config,
    dcfg: DecodeConfig = DecodeConfig(),
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``generate_tokens``' plain twin: the same body, step by step from
    the host over a fresh program's state, nothing captured or kept."""
    B, L = encoder_hidden.shape[:2]
    return _program_class(model)(model, cfg, dcfg, B, L,
                                 encoder_hidden.device).run(
        model, encoder_hidden, generator, capture=False)
