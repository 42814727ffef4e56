"""Whole-song inference: audio file or waveform -> MIDI piano cover.

Port of ``music2midi_tpu/infer/pipeline.py`` (``Music2MIDI``): the
single-song path ``generate`` -> ``sample_notes``, the throughput path
``generate_batch`` (many songs in one stream of chunk batches) and
``warmup``:

  * the song is zero-padded to a multiple of the 3-s window and reshaped
    to a (num_chunks, 48000) batch; batches are padded up to a bucket size
    (8, 16, 32, 64, 128), capped by ``inference.batch_size``;
  * per batch, on the device: int16 wave transport (serving mode) ->
    log-mel -> conditioning prepend -> encoder -> greedy decode (int8
    self- and cross-KV in serving mode) -> detokenize;
  * the host trims the rows and stitches the chunks in token time.

Two modes, as in the JAX package: ``dtype=torch.float32`` is the parity
mode (``torch.fft`` mel, no quantization); ``dtype=torch.bfloat16`` is the
serving mode (on a CUDA device the hand-written CUDA mel kernel, and int8
KV with every attention block of the decode loop in the decode-attention
kernel; ``pallas_cross`` adds the transposed-cross kernel).  The JAX
engine's knobs are attributes with its names and defaults:
``suppress_tokens``, ``int8_kv``, ``int8_weights``, ``kv_bits``,
``unroll``, ``temperature``, ``top_k``, ``sample_seed``,
``input_dither`` and ``mel_noise_floor``.

Everything runs on ``device`` (``cuda`` unless the caller passes
``device="cpu"``).  ``mesh`` (``parallel/mesh.py::make_mesh``, every rank
of it building the engine and making the same calls) serves on a
``(dp, tp)`` mesh, as the JAX engine's ``mesh``: each rank holds its tp
shard of the parameters (H / tp heads, d_ff / tp) at the local config
``t5_config``; a call's chunk batches are padded to a multiple of dp and
each dp rank runs its rows (mel, encoder, decode; the o and wo products
summed over tp), and the tokens are gathered over dp, so every rank
returns the whole result.  A tp shard's decode loop runs eagerly
(``infer/decode.py::captures``), which ``last_decode_stats`` records.

A config whose ``model.decoder`` block names ``type: granitemoehybrid``
(``configs/granite4h_small_p1.yaml``) serves granite-4.0-h's hybrid
decoder (``models/granite_hybrid.py``, random from the block's ``seed``)
behind the same tower: the encoder's output is its prefix, and the decode
loop (``infer/decode.py::HybridDecodeProgram``) prefills over it and
emits the event ids greedily; ids past the MIDI vocabulary are no event
(``ops/detokenize.py``).  Everything else here runs it unchanged.

The decode loop of each batch is one captured program
(``infer/decode.py``): the first batch of a bucket captures it, later ones
replay it.  ``generate_batch`` splits the host's work from the card's, as
the JAX engine's dispatcher does: the calling thread stacks, pads and
transport-encodes each batch into one of two staging buffers (pinned
memory on a card) in row slices on a persistent 2-thread pool, while one
card thread of the call's own (``torch.no_grad``) uploads the batch before,
runs it and copies its notes back: exactly one thread issues the card's
work, and staging batch k + 1 overlaps the card's work on batch k.  The
same call loads its ``audio_paths`` ahead of the stream (4 workers, 8 songs
ahead); its threads end before it returns, and the staging pool when the
engine is collected.  The staging buffers are the engine's, so two
``generate_batch`` calls on one engine take turns (a lock over the
stream), as two decodes of one bucket do (``infer/decode.py``).
Checkpoints: the npz export
(``from_npz``) and the reference's Lightning ``.ckpt``
(``from_torch_checkpoint``), and the training checkpoints and exports of
either package (``from_orbax``, with the JAX engine's signature, and
``from_checkpoint``, both through ``weights.py::restore_params``): the
JAX trainer's orbax directories are read by the port's own OCDBT / zarr
reader and zstd decoder (``orbax.py``), with no orbax or tensorstore.

Spans (``profiling.span``, recorded while a profiler or
``profiling.recording()`` is on): a ``generate_batch`` call is the root
(``songs``, ``chunks``); on the calling thread a ``stage`` per batch
(``k``, ``width``, ``rows``; its ``slot_wait`` the wait for a free
staging buffer) and the final ``midi``; on the card thread a ``batch``
(``k``) under the root, with ``upload``, ``mel``, ``encode``, ``decode``
(``infer/decode.py``: its steps, host syncs, replays and captures),
``tokens`` (the lengths read back) and ``detokenize``.  ``on_batch_tokens``
(default None), when set, is called as ``on_batch_tokens(k, tokens)`` with
each batch's index in the call and the tokens ``_run_batch`` returns.
"""

from __future__ import annotations

import functools
import threading
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Union)

import numpy as np
import torch

from .. import audio
from ..config import ConfigNode, resolve_config
from ..midi import MidiFile
from ..models.convert import reference_checkpoint_to_params
from ..models.granite_hybrid import (
    GraniteHybrid,
    HybridConfig,
    hybrid_config_from,
)
from ..models.t5 import (
    T5Config,
    T5Model,
    conditioning_prepend,
    encode,
    init_params,
    t5_config_from,
)
from ..ops.detokenize import detokenize_to_host
from ..ops.mel import (
    LogMelConfig,
    log_mel_config_from,
    log_mel_spectrogram,
    log_mel_spectrogram_fast,
    num_frames,
)
from ..parallel.mesh import (
    axis_group,
    axis_size,
    batch_sharding,
    gather_tensor,
    local_config,
    shard_params,
)
from ..profiling import span
from ..tokenizer import MidiTokenizer
from ..utils import numpy_to_midi
from ..weights import load_npz, restore_params
from .decode import DecodeConfig, captures, generate_tokens

_BUCKET_SIZES = (8, 16, 32, 64, 128)


@functools.lru_cache(maxsize=4)
def _dither_tile(split_size: int) -> np.ndarray:
    """Unit-RMS gaussian dither tile for ``Music2MIDI.input_dither``, one
    for every chunk: numpy's ``default_rng(0xD17E12)``, the JAX engine's
    tile bit for bit, so the same waveform gives the same output in both
    engines and across processes."""
    return np.random.default_rng(0xD17E12).standard_normal(
        split_size
    ).astype(np.float32)


_LOAD_WORKERS, _LOAD_AHEAD = 4, 8  # generate_batch's audio_paths prefetch


def _prefetched(pool: ThreadPoolExecutor, paths, sr: int):
    """Yield ``audio.load(path, sr=sr)[0]`` for each path in order, with at
    most ``_LOAD_AHEAD`` loads submitted ahead: a decoded 3-minute song is
    ~11.5 MB, so submitting every load at once would hold the whole set in
    host memory when decoding outpaces the card."""
    pending: deque = deque()
    it = iter(paths)
    for p in it:
        pending.append(pool.submit(audio.load, p, sr=sr))
        if len(pending) >= _LOAD_AHEAD:
            break
    while pending:
        f = pending.popleft()
        nxt = next(it, None)
        if nxt is not None:
            pending.append(pool.submit(audio.load, nxt, sr=sr))
        yield f.result()[0]


_STAGE_WORKERS, _STAGE_SLICES = 2, 4  # generate_batch's staging pool


class _Slot(NamedTuple):
    """A staging buffer of ``generate_batch``: (max batch, split) host
    samples in the transport dtype (pinned on a card), and ``free``, set
    while no batch is staged in it or being uploaded from it."""
    host: torch.Tensor
    free: threading.Event


def _bucket(n: int, cap: int) -> int:
    for b in _BUCKET_SIZES:
        if n <= b and b <= cap:
            return b
    return cap


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; without a card only an explicit CPU device
    is accepted."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run on the CPU"
        )
    return dev


class Music2MIDI:
    """Song -> MIDI inference engine.

    Example:
        model = Music2MIDI.from_npz("checkpoints/model_of_record.npz",
                                    dtype=torch.bfloat16)
        model.generate(audio_path="song.wav").write("cover.mid")
    """

    def __init__(
        self,
        params: Dict[str, Union[torch.Tensor, np.ndarray]],
        config: Optional[Union[ConfigNode, dict]] = None,
        dtype: torch.dtype = torch.float32,
        decode_max_length: int = 1024,
        device_detokenize: bool = True,
        device=None,
        mesh=None,
    ):
        """params: a flat state_dict (``weights.load_npz``,
        ``weights.params_from_jax`` or ``models.t5.init_params``), whole.
        mesh: a ``(dp, tp)`` DeviceMesh (``parallel.make_mesh``) to serve
        on; ``t5_config`` is then a tp rank's local config."""
        self.device = resolve_device(device)
        self.config = resolve_config(config)
        self.mesh = mesh
        self.t5_config: T5Config = local_config(
            t5_config_from(self.config, dtype=dtype), mesh)
        self.mel_config: LogMelConfig = log_mel_config_from(self.config)
        self.tokenizer = MidiTokenizer(self.config)
        sd = shard_params({k: torch.as_tensor(v) for k, v in params.items()},
                          mesh)
        self.model = T5Model.from_state_dict(
            sd, self.t5_config, axis_group(mesh, "tp")).to(self.device)
        # a config whose model.decoder block names another decoder serves
        # it behind the tower (mel, T5 encoder, conditioning) in place of
        # the T5 decoder: granitemoehybrid, random from the block's seed
        self.decoder: Optional[GraniteHybrid] = None
        self.hybrid_config: Optional[HybridConfig] = None
        block = self.config.model.get("decoder")
        if block is not None:
            if mesh is not None:
                raise ValueError("the hybrid decoder serves on one device: "
                                 "no mesh")
            self.hybrid_config = hybrid_config_from(self.config, dtype=dtype)
            self.decoder = GraniteHybrid.from_seed(
                self.hybrid_config, int(block.get("seed", 0)), self.device)
        self.decode_max_length = decode_max_length
        self.device_detokenize = device_detokenize
        self.num_conditioning = len(self.config.conditioning)
        # per batch of the last call: {"batch_width", "real_rows", "steps"
        # (decode steps run = longest row), "tokens_real", "row_steps"};
        # under a mesh also "loop_steps" (this rank's decode loop: its
        # rows' longest) and "captured" (it ran as a CUDA graph)
        self.last_decode_stats: List[dict] = []
        # serving mode: the cross blocks through the transposed-cross
        # kernel (ops/decode_attention.py::decode_attention_cross_t) over a
        # cross-KV stored (B, H, D, L); off as in the JAX engine, and
        # ignored unless the KV is quantized at 8 bits
        self.pallas_cross: bool = False
        # token ids masked to -inf in the decode loop, e.g. (eos,) to force
        # every chunk to decode_max_length tokens
        self.suppress_tokens: tuple = ()
        # quantized self- and cross-KV: None = on exactly when the dtype is
        # not fp32 (serving mode); True / False override
        self.int8_kv: Optional[bool] = None
        # int8 weight-only quantization of the decode projections
        # (models/t5.py::_quantize_w); off, as in the JAX engine
        self.int8_weights: bool = False
        # quantized-KV width: 8 (+-127 levels) or 4 (+-7 levels, stored in
        # int8); a width other than 8 implies quantized KV
        self.kv_bits: int = 8
        # decode steps between two EOS read-backs; greedy tokens unchanged
        self.unroll: int = 1
        # sampling: temperature 0.0 is greedy; top_k 0 keeps every token;
        # one generator a batch from sample_seed (_sample_rng)
        self.temperature: float = 0.0
        self.top_k: int = 0
        self.sample_seed: int = 0
        # RMS of a fixed gaussian dither added to every chunk
        # (_chunk_waveform); 0.0 = off, the JAX engine's default
        self.input_dither: float = 0.0
        # called as on_batch_tokens(k, tokens) with each batch's index in
        # its call and the tokens _run_batch returns (None: not called)
        self.on_batch_tokens: Optional[
            Callable[[int, torch.Tensor], None]] = None
        # generate_batch's two staging buffers (_staging_slots), one call
        # at a time
        self._slots: Optional[List[_Slot]] = None
        self._stream_lock = threading.Lock()

    @property
    def mel_noise_floor(self) -> float:
        """RMS sigma of the white-noise floor at which every mel bin is
        clamped before the log (``ops/mel.py::noise_mel_floor``); bins
        above it are unchanged.  0.0 = off, the JAX engine's default."""
        return self.mel_config.noise_floor_sigma

    @mel_noise_floor.setter
    def mel_noise_floor(self, sigma: float) -> None:
        self.mel_config = self.mel_config._replace(
            noise_floor_sigma=float(sigma))

    # ------------------------------------------------------------------ #
    # constructors                                                        #
    # ------------------------------------------------------------------ #

    @classmethod
    def from_npz(cls, path: Union[str, Path],
                 config: Optional[Union[ConfigNode, dict]] = None,
                 **kw) -> "Music2MIDI":
        """Load a single-file npz export (the checkpoint of record)."""
        sd, saved_cfg = load_npz(path)
        return cls(sd, config if config is not None else saved_cfg, **kw)

    @classmethod
    def from_torch_checkpoint(cls, ckpt_path: Union[str, Path],
                              config: Optional[Union[ConfigNode, dict]] = None,
                              **kw) -> "Music2MIDI":
        """Load the reference's PyTorch-Lightning checkpoint (or a bare HF
        ``T5ForConditionalGeneration`` state_dict) through
        ``models/convert.py``.  A ``.ckpt`` embeds no config, so ``config``
        (default: the packaged one) must name its architecture."""
        blob = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        state_dict = blob.get("state_dict", blob)
        cfg = resolve_config(config)
        params = reference_checkpoint_to_params(state_dict,
                                                t5_config_from(cfg))
        return cls(params, cfg, **kw)

    @classmethod
    def from_checkpoint(cls, path: Union[str, Path],
                        config: Optional[Union[ConfigNode, dict]] = None,
                        **kw) -> "Music2MIDI":
        """Load anything ``weights.py::restore_params`` reads: an
        npz export (from either package), a ``save_params`` directory, or
        a training checkpoint (a step directory, or a training root taking
        its latest step), of either package's trainer."""
        params, saved_cfg = restore_params(path)
        return cls(params, config if config is not None else saved_cfg, **kw)

    @classmethod
    def from_orbax(cls, ckpt_dir: Union[str, Path],
                   config: Optional[Union[ConfigNode, dict]] = None,
                   **kw) -> "Music2MIDI":
        """The JAX engine's ``from_orbax``: the params of a JAX run's
        orbax directory (a ``save_params`` export, a training step dir or
        a training root taking its latest step), or of any other layout
        ``restore_params`` reads; the saved config unless ``config``."""
        params, saved_cfg = restore_params(ckpt_dir)
        return cls(params, config if config is not None else saved_cfg, **kw)

    @classmethod
    def from_random(cls, config: Optional[Union[ConfigNode, dict]] = None,
                    seed: int = 0, **kw) -> "Music2MIDI":
        """Random HF-scheme weights from ``seed`` (the same numbers as the
        JAX package's ``Music2MIDI.from_random(seed=seed)``)."""
        cfg = resolve_config(config)
        num_cond = tuple(len(v) for v in cfg.conditioning.values())
        params = init_params(seed, t5_config_from(cfg), num_cond)
        return cls(params, cfg, **kw)

    # ------------------------------------------------------------------ #
    # the device program                                                  #
    # ------------------------------------------------------------------ #

    def cond_index_from_names(self, **names) -> List[int]:
        """Conditioning names -> indices, e.g.
        ``cond_index_from_names(genre="pop", difficulty="beginner")`` ->
        ``[1, 0]``; a type not named takes its first category."""
        out = []
        for key in self.config.conditioning.keys():
            values = list(self.config.conditioning[key])
            name = names.get(key, values[0])
            if name not in values:
                raise ValueError(f"unknown {key} {name!r}; choices: {values}")
            out.append(values.index(name))
        return out

    def _sample_rng(self, batch_start: int) -> Optional[torch.Generator]:
        """The sampling generator of one batch (None when greedy): a
        ``torch.Generator`` on the engine's device seeded with the first
        64-bit word of ``numpy.random.SeedSequence((sample_seed,
        batch_start))``, so every batch of a call draws its own numbers and
        one seed gives one output.  The JAX engine folds batch_start into
        ``PRNGKey(sample_seed)``; its bits cannot be reproduced here."""
        if self.temperature == 0.0:
            return None
        seed = np.random.SeedSequence(
            (int(self.sample_seed), int(batch_start))
        ).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _dcfg(self) -> DecodeConfig:
        """The JAX engine's ``_dcfg``: quantized self- and cross-KV when
        ``int8_kv`` says so (None: exactly when the dtype is not fp32) or
        when ``kv_bits`` is not 8, with its sampling, suppression, weight
        quantization, width, unroll and ``pallas_cross``.

        With quantized KV every attention block goes through the
        decode-attention kernel (``pallas_attention``), where the JAX
        engine leaves its Pallas kernel off: on the TPU that kernel lost to
        XLA's fusion (``music2midi_tpu/ops/decode_attention.py``), while on
        the H100 the decode loop is bound by the host's launches (PERF.md,
        section 5) and one launch of the kernel replaces about ten of the
        plain chain.  The kernel runs with ``round_pv``, so the engine
        serves the JAX engine's arithmetic (``_attention_int8``: ``p * vs``
        rounded to the compute dtype), in bf16 and, through its f32
        instance, in fp32.  ``pallas_cross`` moves the cross blocks of an
        8-bit cache to the transposed-cross kernel.

        The hybrid decoder keeps its KV in the compute dtype and its
        projections unquantized: it takes none of the KV, weight or kernel
        options (setting one raises), only the length, sampling,
        suppression and unroll."""
        if self.decoder is not None:
            if self.int8_kv or self.kv_bits != 8 or self.int8_weights \
                    or self.pallas_cross:
                raise ValueError("the hybrid decoder takes no int8_kv, "
                                 "kv_bits, int8_weights or pallas_cross")
            return DecodeConfig(
                max_length=self.decode_max_length,
                temperature=self.temperature, top_k=self.top_k,
                suppress_tokens=tuple(self.suppress_tokens),
                unroll=int(self.unroll))
        quant = self.int8_kv
        if quant is None:
            quant = self.t5_config.dtype != torch.float32
        if self.kv_bits != 8:
            quant = True  # a width other than 8 implies quantized KV
        return DecodeConfig(
            max_length=self.decode_max_length,
            temperature=self.temperature,
            top_k=self.top_k,
            suppress_tokens=tuple(self.suppress_tokens),
            quantize_kv=bool(quant),
            quantize_weights=bool(self.int8_weights),
            pallas_attention=bool(quant),
            pallas_cross=bool(self.pallas_cross),
            unroll=int(self.unroll),
            kv_bits=int(self.kv_bits),
        )

    @property
    def encoder_len(self) -> int:
        """Encoder sequence length of one chunk: its mel frames plus the
        prepended conditioning vectors (the L of ``profiling.decode_flops``;
        190 for the 3-s chunk)."""
        return num_frames(self._split_size(), self.mel_config) \
            + self.num_conditioning

    def _encode_wave(self, batch: np.ndarray) -> np.ndarray:
        """Wave transport: int16 in serving mode (round half up through
        the uint16 bias, as the JAX engine does; lossless for 16-bit
        audio), float32 in the parity mode."""
        if self.t5_config.dtype == torch.bfloat16:
            y = batch * 32768.0
            np.clip(y, -32768.0, 32767.0, out=y)
            y += 32768.5
            return (y.astype(np.uint16) ^ np.uint16(0x8000)).view(np.int16)
        return batch

    def _device_wave(self, wave_chunks: np.ndarray) -> torch.Tensor:
        """(B, split) host chunks -> float32 wave on the device, through
        the mode's transport."""
        return self._transport_to_float(
            torch.from_numpy(self._encode_wave(wave_chunks)).to(self.device))

    @staticmethod
    def _transport_to_float(wave: torch.Tensor) -> torch.Tensor:
        if not wave.is_floating_point():
            wave = wave.to(torch.float32) / 32768.0
        return wave

    @functools.cached_property
    def _stage_pool(self) -> ThreadPoolExecutor:
        """Persistent 2-thread staging pool of ``generate_batch`` (the JAX
        engine's ``_stage_pool``), shut down when the engine is
        collected."""
        pool = ThreadPoolExecutor(max_workers=_STAGE_WORKERS,
                                  thread_name_prefix="m2m-stage")
        weakref.finalize(self, pool.shutdown, wait=False)
        return pool

    def _staging_slots(self) -> List[_Slot]:
        """The two staging buffers, made on first use by the thread that
        drives the card (pinned memory is a CUDA allocation)."""
        shape = (self._width(int(self.config.inference.batch_size)),
                 self._split_size())
        if self._slots is None or tuple(self._slots[0].host.shape) != shape:
            dtype = (torch.int16 if self.t5_config.dtype == torch.bfloat16
                     else torch.float32)
            pin = self.device.type == "cuda"
            self._slots = [_Slot(torch.empty(shape, dtype=dtype,
                                             pin_memory=pin),
                                 threading.Event()) for _ in range(2)]
        for slot in self._slots:
            slot.free.set()
        return self._slots

    def _stage(self, slot: _Slot, rows: List[np.ndarray], b: int) -> None:
        """Stack, zero-pad to ``b`` rows and transport-encode ``rows`` into
        ``slot``'s buffer, in row slices on the staging pool (the JAX
        engine's ``_stage_wave``); the values of ``_encode_wave`` over the
        padded batch, row by row."""
        out = slot.host.numpy()
        n = len(rows)

        def fill(lo: int, hi: int) -> None:
            if lo < min(hi, n):
                out[lo:min(hi, n)] = self._encode_wave(
                    np.stack(rows[lo:min(hi, n)]))
            if hi > max(lo, n):
                out[max(lo, n):hi] = 0

        if b < 2 * _STAGE_SLICES:
            fill(0, b)
            return
        bounds = np.linspace(0, b, _STAGE_SLICES + 1, dtype=int)
        list(self._stage_pool.map(fill, bounds[:-1], bounds[1:]))

    def _upload(self, slot: _Slot, b: int) -> torch.Tensor:
        """The first ``b`` staged rows -> float32 wave on the device; the
        slot is free again once the copy has landed."""
        try:
            wave = slot.host[:b].to(self.device, non_blocking=True, copy=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        finally:
            slot.free.set()
        return self._transport_to_float(wave)

    def _log_mel(self, wave: torch.Tensor) -> torch.Tensor:
        """The plain FFT mel in the parity mode; the serving mel (the CUDA
        kernel on a CUDA tensor) in the serving mode."""
        if self.t5_config.dtype == torch.float32:
            return log_mel_spectrogram(wave, self.mel_config)
        return log_mel_spectrogram_fast(wave, self.mel_config)

    @torch.no_grad()
    def _encoder(self, mel: torch.Tensor,
                 cond_index: np.ndarray) -> torch.Tensor:
        """Conditioning prepend -> encoder hidden states."""
        cond = torch.from_numpy(cond_index).to(self.device)
        embeds = conditioning_prepend(self.model, mel, cond)
        return encode(self.model, embeds, self.t5_config)

    def _decode(self, encoder_hidden: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """Decode of the batch -> (tokens, lengths); ``generator`` draws
        the samples when the engine samples.  The hybrid decoder takes the
        encoder's output as its prefix."""
        if self.decoder is not None:
            return generate_tokens(self.decoder, encoder_hidden,
                                   self.hybrid_config, self._dcfg(),
                                   generator)
        return generate_tokens(self.model, encoder_hidden, self.t5_config,
                               self._dcfg(), generator)

    def _encode_and_generate(self, wave_chunks,
                             cond_index: np.ndarray,
                             generator: Optional[torch.Generator] = None):
        """(B, split) chunks (host samples, or the float32 wave already on
        the device) + (B, n_cond) conditioning -> (tokens, lengths) on the
        device: log-mel -> conditioning -> encoder -> decode."""
        if isinstance(wave_chunks, np.ndarray):
            with span("upload"):
                wave_chunks = self._device_wave(wave_chunks)
        with span("mel"):
            mel = self._log_mel(wave_chunks)
        with span("encode"):
            hidden = self._encoder(mel, cond_index)
        return self._decode(hidden, generator)

    # ------------------------------------------------------------------ #
    # inference                                                           #
    # ------------------------------------------------------------------ #

    def _split_size(self) -> int:
        """Samples per chunk (3 s at the model rate)."""
        return int(self.config.model.sample_rate
                   * float(self.config.dataset.segment_duration))

    def _n_steps(self) -> int:
        """Token time steps per chunk: a chunk's offset in its song."""
        return round(float(self.config.dataset.segment_duration)
                     / self.tokenizer.time_step)

    def _chunk_waveform(self, waveform: np.ndarray) -> np.ndarray:
        """Zero-pad to a 3-s multiple and reshape to (n_chunks, split);
        with ``input_dither`` add the dither tile, scaled, to every chunk
        (pad included), as the JAX engine does here, the one place that
        ``sample_notes`` and ``generate_batch`` share."""
        split_size = self._split_size()
        wave = np.asarray(waveform, dtype=np.float32)
        n_chunks = max(1, -(-len(wave) // split_size))
        padded = np.zeros(n_chunks * split_size, dtype=np.float32)
        padded[: len(wave)] = wave
        chunks = padded.reshape(n_chunks, split_size)
        if self.input_dither > 0.0:
            chunks = chunks + np.float32(self.input_dither) * \
                _dither_tile(split_size)
        return chunks

    def _width(self, n: int) -> int:
        """The batch width of n chunks: their bucket, rounded up to a
        multiple of dp under a mesh (the JAX engine's ``_bucket``)."""
        b = _bucket(n, int(self.config.inference.batch_size))
        dp = axis_size(self.mesh, "dp")
        return -(-b // dp) * dp

    def _pad_batch(self, batch: np.ndarray,
                   cond_index: Optional[Sequence[int]] = None):
        """(n, split) chunks -> (chunks zero-padded to the batch width,
        (width, n_cond) conditioning indices)."""
        n = len(batch)
        b = self._width(n)
        if n < b:
            batch = np.concatenate(
                [batch, np.zeros((b - n, batch.shape[1]), np.float32)]
            )
        if cond_index is None:
            cond = np.zeros((self.num_conditioning,), dtype=np.int64)
        else:
            cond = np.asarray(cond_index, dtype=np.int64)
        return batch, np.broadcast_to(cond, (b, len(cond))).copy()

    def _run_batch(self, batch, cond: np.ndarray, n: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """A bucket-padded batch (host chunks or the device wave) whose
        first n rows are real -> their tokens
        (n, width) on the device, the columns trimmed to the longest real
        row (the rest is PAD); appends the batch's decode stats.  Under a
        mesh this rank runs its dp rows and the tokens are gathered."""
        mesh_stats = {}
        if self.mesh is None:
            tokens, lengths = self._encode_and_generate(batch, cond, generator)
        else:
            rows = batch_sharding(self.mesh)
            tokens, lengths = self._encode_and_generate(
                rows.local(batch), rows.local(cond), generator)
            mesh_stats = {"loop_steps": int(lengths.max()) - 1,
                          "captured": captures(self.model, self.device)}
            # one gather over dp of tokens and lengths, exact in float32
            packed = torch.cat([tokens, lengths[:, None]], dim=1).float()
            packed = gather_tensor(packed, 0, self.mesh, "dp").to(torch.int32)
            tokens, lengths = packed[:, :-1], packed[:, -1]
        with span("tokens"):
            len_h = lengths.cpu().numpy()
        self.last_decode_stats.append({
            "batch_width": int(len(batch)),
            "real_rows": int(n),
            "steps": int(len_h.max()) - 1,
            "tokens_real": int(len_h[:n].sum()) - n,
            "row_steps": (len_h[:n] - 1).tolist(),
            **mesh_stats,
        })
        tokens = tokens[:n, :int(len_h[:n].max())]
        if self.on_batch_tokens is not None:
            self.on_batch_tokens(len(self.last_decode_stats) - 1, tokens)
        return tokens

    def _token_batches(self, chunks: np.ndarray,
                       cond_index: Optional[Sequence[int]] = None):
        """Yield (global chunk start, tokens (n, width)) per batch of one
        song's chunks (``_run_batch``)."""
        max_bs = int(self.config.inference.batch_size)
        self.last_decode_stats = []
        for start in range(0, len(chunks), max_bs):
            real = chunks[start:start + max_bs]
            batch, cond_batch = self._pad_batch(real, cond_index)
            yield start, self._run_batch(batch, cond_batch, len(real),
                                         self._sample_rng(start))

    def generate(
        self,
        audio_path: Optional[Union[str, Path]] = None,
        audio_y: Optional[np.ndarray] = None,
        sr: Optional[int] = None,
        cond_index: Optional[Sequence[int]] = None,
    ) -> MidiFile:
        """Song -> MidiFile: load a WAV at the model rate (16 kHz), chunk,
        decode, stitch."""
        if audio_path is None and audio_y is None:
            raise ValueError("Either audio_path or audio_y should be specified")
        model_sr = int(self.config.model.sample_rate)
        if sr is None:
            sr = model_sr
        elif sr != model_sr:
            raise ValueError(f"sr must be {model_sr}, got {sr}")
        if audio_y is None:
            audio_y, sr = audio.load(audio_path, sr=model_sr)
        audio_y = np.asarray(audio_y, dtype=np.float32)
        return numpy_to_midi(self.sample_notes(audio_y, cond_index))

    def sample_notes(self, waveform: np.ndarray,
                     cond_index: Optional[Sequence[int]] = None) -> np.ndarray:
        """waveform (S,) at the model rate -> stitched (N, 4) note array.

        Detokenization runs on the device by default; ``device_detokenize
        =False`` takes the host tokenizer instead (the cross-check)."""
        split_duration = float(self.config.dataset.segment_duration)
        chunks = self._chunk_waveform(waveform)
        n_steps = self._n_steps()
        if self.device_detokenize:
            parts: List[np.ndarray] = []
            for start, tokens in self._token_batches(chunks, cond_index):
                start_idx = torch.arange(
                    start, start + tokens.shape[0], device=tokens.device
                ) * n_steps
                parts.extend(detokenize_to_host(
                    tokens, start_idx, self.tokenizer.time_step
                ))
            if not parts:
                return np.zeros((0, 4))
            return np.concatenate(parts)
        tokens_list = self.sample_tokens_batched(chunks, cond_index)
        return self.tokenizer.decode(
            tokens_list, mode="sequential", duration_per_batch=split_duration
        )

    def generate_batch(
        self,
        waveforms: Optional[Sequence[np.ndarray]] = None,
        cond_indices: Optional[Sequence[Optional[Sequence[int]]]] = None,
        audio_paths: Optional[Sequence[Union[str, Path]]] = None,
    ) -> List[MidiFile]:
        """Throughput serving: many songs -> one MidiFile per song, in song
        order.

        All songs' 3-s chunks go into ONE stream of batches of
        ``inference.batch_size`` chunks, each dispatched as soon as it is
        full, so batches cross song boundaries (a 3-minute song alone fills
        half a 128-wide batch).  Conditioning is per chunk row, from its
        song's entry of ``cond_indices`` (None: all zeros); the rows that
        pad the last batch to its bucket get zero audio and zero
        conditioning.  Each row's time offset is its chunk index within
        its own song.  ``audio_paths`` are loaded (``audio.load`` at the
        model rate) on a pool of 4 threads, at most 8 songs ahead of the
        stream and in input order, so that decoding and resampling overlap
        the card's work on earlier songs.  This thread stages each batch
        while the call's card thread runs the batch before
        (``_generate_stream``).  ``last_decode_stats`` holds one entry
        per dispatched batch.  When sampling, batch k draws from
        ``_sample_rng(k)``, as in the JAX engine."""
        if (waveforms is None) == (audio_paths is None):
            raise ValueError("pass exactly one of waveforms / audio_paths")
        n_songs = len(waveforms if waveforms is not None else audio_paths)
        if cond_indices is None:
            cond_indices = [None] * n_songs
        elif len(cond_indices) != n_songs:
            raise ValueError(f"cond_indices has {len(cond_indices)} entries "
                             f"for {n_songs} songs")
        pool = None
        if audio_paths is not None:
            pool = ThreadPoolExecutor(max_workers=_LOAD_WORKERS)
            waves = _prefetched(pool, audio_paths,
                                int(self.config.model.sample_rate))
        else:
            waves = iter(waveforms)
        try:
            return self._generate_stream(waves, cond_indices)
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

    def _generate_stream(self, waves, cond_indices) -> List[MidiFile]:
        """``generate_batch`` over an iterator of waveforms: this thread
        forms the batches and stages each into a free slot (``_stage``);
        the call's card thread uploads, runs and detokenizes them in order
        (``_card_batch``); results are collected in order, and the first
        failed batch's exception is raised here.  Another thread's call
        waits for this one."""
        with self._stream_lock:
            return self._generate_locked(waves, cond_indices)

    def _generate_locked(self, waves, cond_indices) -> List[MidiFile]:
        with span("generate_batch", songs=len(cond_indices)) as root:
            max_bs = int(self.config.inference.batch_size)
            n_cond = self.num_conditioning
            self.last_decode_stats = []
            spans: List[tuple] = []
            rows: List[np.ndarray] = []
            conds: List[np.ndarray] = []
            local_idx: List[int] = []
            pending: list = []
            card = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="m2m-card")
            try:
                slots = card.submit(self._staging_slots).result()

                def dispatch():
                    # stop staging once a batch has failed
                    for f in pending:
                        if f.done() and f.exception() is not None:
                            f.result()
                    n = len(rows)
                    b = self._width(n)
                    with span("stage", k=len(pending), width=b, rows=n):
                        slot = slots[len(pending) % len(slots)]
                        with span("slot_wait"):
                            slot.free.wait()
                        slot.free.clear()
                        try:
                            self._stage(slot, rows, b)
                        except BaseException:
                            slot.free.set()
                            raise
                        cond = np.zeros((b, n_cond), np.int64)
                        cond[:n] = np.stack(conds)
                        pending.append(card.submit(
                            self._card_batch, slot, b, n, cond,
                            list(local_idx), len(pending), root))
                    rows.clear()
                    conds.clear()
                    local_idx.clear()

                n_total = 0
                for wave, cond in zip(waves, cond_indices):
                    song_chunks = self._chunk_waveform(wave)
                    c = (np.zeros(n_cond, np.int64) if cond is None
                         else np.asarray(cond, np.int64))
                    spans.append((n_total, n_total + len(song_chunks)))
                    n_total += len(song_chunks)
                    for k, row in enumerate(song_chunks):
                        rows.append(row)
                        conds.append(c)
                        local_idx.append(k)
                        if len(rows) == max_bs:
                            dispatch()
                if rows:
                    dispatch()
                root.set(chunks=n_total)
                per_chunk: List[np.ndarray] = []
                for f in pending:
                    per_chunk.extend(f.result())
            finally:
                card.shutdown(wait=True, cancel_futures=True)
            out = []
            with span("midi"):
                for start, end in spans:
                    parts = per_chunk[start:end]
                    out.append(numpy_to_midi(np.concatenate(parts) if parts
                                             else np.zeros((0, 4))))
            return out

    def _card_batch(self, slot: _Slot, b: int, n: int, cond: np.ndarray,
                    local_idx: List[int], k: int, root) -> List[np.ndarray]:
        """On the card thread: upload a staged batch, run it (batch k of
        the call draws from ``_sample_rng(k)``, as in the JAX engine) and
        copy its per-chunk notes back; its span is a child of the call's
        ``root``."""
        with torch.no_grad(), span("batch", parent=root, k=k):
            with span("upload"):
                wave = self._upload(slot, b)
            tokens = self._run_batch(wave, cond, n, self._sample_rng(k))
            with span("detokenize"):
                start_idx = torch.as_tensor(
                    local_idx, device=tokens.device) * self._n_steps()
                return detokenize_to_host(tokens, start_idx,
                                          self.tokenizer.time_step)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run each batch width a serving process will use once, on
        silence, before the first request: builds the CUDA kernels (at
        their first use), captures the decode program of each batch
        width and warms PyTorch's caching allocator and the matmul
        libraries.  Per bucket b, a chunk count (default: every
        bucket up to ``inference.batch_size``, and that size itself), one
        silent song of b chunks through ``generate_batch`` and through
        ``generate``, as the JAX engine's warmup runs both of its
        programs."""
        max_bs = int(self.config.inference.batch_size)
        if buckets is None:
            buckets = {b for b in _BUCKET_SIZES if b <= max_bs} | {max_bs}
        split = self._split_size()
        for b in sorted(set(buckets)):
            silent = np.zeros(b * split, dtype=np.float32)
            self.generate_batch([silent])
            self.generate(audio_y=silent)

    def sample_tokens_batched(self, chunks: np.ndarray,
                              cond_index: Optional[Sequence[int]] = None
                              ) -> List[np.ndarray]:
        """Token sequences per chunk, EOS-trimmed, on the host."""
        out: List[np.ndarray] = []
        eos_id = self.t5_config.eos_token_id
        for _, tokens in self._token_batches(chunks, cond_index):
            for row in tokens.cpu().numpy():
                eos = np.nonzero(row == eos_id)[0]
                end = int(eos[0]) + 1 if len(eos) else len(row)
                out.append(row[:end].astype(np.int64))
        return out
