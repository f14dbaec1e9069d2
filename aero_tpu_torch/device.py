"""Device selection, float32 math settings and the CUDA-graph switch for
the port.

Every tensor the port creates names its device explicitly; nothing sets a
global default device.  ``resolve_device("cuda")`` on a machine without
CUDA raises instead of falling back to the CPU, so a run that was meant to
measure the card can never quietly measure the host.

The device steps of the stations and banks run as CUDA-graph replays on a
card (``utils/graphs.py``); ``disable_graphs()``, the counterpart of
``jax.disable_jit()``, runs them eagerly on the card instead, to compare
the two modes.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_GRAPHS = contextvars.ContextVar("aero_tpu_torch_graphs", default=True)


def resolve_device(name) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` (or a torch.device) -> device.

    Raises RuntimeError for a CUDA device when CUDA is not available."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False (no CUDA build of torch, or no visible card)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def set_fp32_precision() -> None:
    """Full IEEE float32 for cuBLAS matmuls and cuDNN convolutions.

    The JAX reference runs at float32.  torch's cuDNN convolutions default
    to TF32 (about three decimal digits): the matched filter and the PFB
    fold would then disagree with the reference far beyond float32 error.
    Sets the legacy ``allow_tf32`` flags and, where this torch has it, the
    newer per-backend ``fp32_precision`` API (conv and rnn together, so a
    later read of the legacy flag sees one consistent setting), then
    asserts the result."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    backends = [getattr(torch.backends.cuda, "matmul", None),
                getattr(torch.backends.cudnn, "conv", None),
                getattr(torch.backends.cudnn, "rnn", None)]
    backends = [b for b in backends if b is not None
                and hasattr(b, "fp32_precision")]
    for b in backends:
        b.fp32_precision = "ieee"
    for b in backends:
        assert b.fp32_precision == "ieee", (b, b.fp32_precision)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def graphs_enabled() -> bool:
    """Whether device steps on a card run as CUDA-graph replays (the
    default) rather than eagerly."""
    return _GRAPHS.get()


@contextlib.contextmanager
def disable_graphs():
    """Inside, every ``GraphedStep`` on a card runs its step eagerly, op by
    op, through the same static buffers (the counterpart of
    ``jax.disable_jit()``; the tests and ``chip_smoke.py`` compare the two
    modes with it).  The only switch: graphs are on everywhere else."""
    token = _GRAPHS.set(False)
    try:
        yield
    finally:
        _GRAPHS.reset(token)
