"""The Mamba-2 decode state update (kernel 6): wrapper, plain version and
launch count.

Replaces no TPU kernel: the JAX package has no such model.  The hybrid
decoder's step (``models/granite_hybrid.py``) keeps, per row and mamba
layer, an SSM state h of (H, P, N) and at each step computes::

    h <- exp(dt * A) * h + dt * x (outer) B        (per head; B, C per group)
    y  = h . C + D * x

``ssm_state_update`` does this in place over a batch of rows: a CUDA
tensor goes to ``csrc/ssm_state_update.cu`` (built by ``ops/_build.py`` at
first use) and a failed launch raises; a CPU tensor goes to
``ssm_state_update_plain``, the same arithmetic in PyTorch.  The state is
float32 (the serving precision) or bfloat16 (the configuration's
control); the new state is computed in float32 and y is read from it
before it is rounded to the state's dtype.  Neither version allocates
anything but y or reads back anything, so the kernel is captured in the
decode loop's CUDA graph as it is.

Bound on the H100: the state's bytes, read and written once: 2 B H P N x
4 bytes, 1.07 GB a layer step at 128 rows of 128 x 64 x 128 (0.32 ms at
3.35 TB/s).  ``ssm_state_update.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from . import _build

_STATE_DTYPES = (torch.float32, torch.bfloat16)


def ssm_state_update_plain(state: torch.Tensor, x: torch.Tensor,
                           dt: torch.Tensor, A: torch.Tensor,
                           Bm: torch.Tensor, Cm: torch.Tensor,
                           D: torch.Tensor) -> torch.Tensor:
    """state (B, H, P, N) updated in place; x (B, H, P), dt (B, H) after
    softplus, A (H,) negative, Bm and Cm (B, G, N), D (H,), all float32
    -> y (B, H, P) float32."""
    H, G = state.shape[1], Bm.shape[1]
    heads_of = torch.arange(H, device=state.device) // (H // G)
    Bh, Ch = Bm[:, heads_of], Cm[:, heads_of]  # (B, H, N)
    new = state.float() * torch.exp(dt * A)[..., None, None] \
        + (dt[..., None] * x)[..., None] * Bh[:, :, None, :]
    y = (new * Ch[:, :, None, :]).sum(-1) + D[:, None] * x
    state.copy_(new)
    return y


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes=(torch.float32,)
           ) -> None:
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, needs one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, needs {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: needs a contiguous, 16-byte aligned "
                         "tensor")


@torch.no_grad()
def ssm_state_update(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                     A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                     D: torch.Tensor) -> torch.Tensor:
    """One step of the state update over a batch of rows -> y (B, H, P)
    float32; ``state`` is updated in place.  The kernel for CUDA tensors
    (every operand contiguous and 16-byte aligned, N a multiple of 4),
    ``ssm_state_update_plain`` for CPU tensors."""
    if state.device.type != "cuda":
        return ssm_state_update_plain(state, x, dt, A, Bm, Cm, D)
    B, H, P, N = state.shape
    G = Bm.shape[1]
    if N % 4 or H % G:
        raise ValueError(f"N = {N} must be a multiple of 4 and H = {H} of "
                         f"G = {G}")
    _check("state", state, (B, H, P, N), _STATE_DTYPES)
    _check("x", x, (B, H, P))
    _check("dt", dt, (B, H))
    _check("A", A, (H,))
    _check("D", D, (H,))
    _check("B", Bm, (B, G, N))
    _check("C", Cm, (B, G, N))
    devices = {t.device for t in (state, x, dt, A, D, Bm, Cm)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    y = torch.empty((B, H, P), dtype=torch.float32, device=state.device)
    if B * H:
        _build.check(_build.load().m2m_ssm_state_update(
            state.data_ptr(), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), y.data_ptr(), B, H,
            P, N, G, int(state.dtype == torch.bfloat16),
            torch.cuda.current_stream(state.device).cuda_stream),
            "m2m_ssm_state_update")
        ssm_state_update.launches += 1
    return y


ssm_state_update.launches = 0
