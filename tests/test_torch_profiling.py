"""Port FLOPs accounting against the JAX package's, and the card peak
table.

Bars: every FLOPs function equal to the JAX package's on a grid of
configurations and shapes; the dense bf16 peak looked up by card name
(H100 SXM5, PCIe, NVL), None for another card and for a CPU device.
"""

import itertools

import pytest
import torch

from music2midi_tpu import profiling as jprof
from music2midi_tpu.models import t5 as jt5
from music2midi_tpu_torch import profiling as pprof
from music2midi_tpu_torch.models import t5 as pt5

CONFIGS = [dict(), dict(d_model=64, d_kv=16, num_heads=4, d_ff=96,
                        num_layers=2, num_decoder_layers=3, vocab_size=123)]


@pytest.mark.parametrize("shape", CONFIGS)
def test_flops_functions_equal_jax(shape):
    pcfg, jcfg = pt5.T5Config(**shape), jt5.T5Config(**shape)
    for b, enc, n in itertools.product((1, 8, 128), (25, 190), (1, 100,
                                                                1023)):
        assert pprof.encoder_fwd_flops(pcfg, b, enc) \
            == jprof.encoder_fwd_flops(jcfg, b, enc)
        for name in ("decoder_fwd_flops", "train_step_flops",
                     "decode_flops"):
            got = getattr(pprof, name)(pcfg, b, enc, n)
            assert got == getattr(jprof, name)(jcfg, b, enc, n), (name, b,
                                                                  enc, n)
            assert got > 0


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12),
    ("NVIDIA H100 SXM5 80GB", 989.4e12),
    ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12),
    ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None),
])
def test_peak_lookup_by_name(name, peak):
    assert pprof.peak_flops_for_name(name) == peak


def test_no_peak_for_a_cpu_device():
    assert pprof.device_peak_flops("cpu") is None
    assert pprof.device_peak_flops(torch.device("cpu")) is None
