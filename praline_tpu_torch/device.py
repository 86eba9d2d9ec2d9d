"""Explicit device resolution and the f32 exactness switches.

Every entry point of the port takes a ``device`` argument and passes it
here.  Nothing is global: no default device is installed, and asking for
``"cuda"`` on a machine without a card raises instead of quietly running
on the CPU.

The switches pin float32 matrix products to full precision.  The score
producer's plain version multiplies integer-valued operands whose partial
sums stay below 2**24 (``praline_tpu/oracle/score.py``), which is exact
only when the product really runs in f32: TF32 keeps 10 mantissa bits and
would round the operands.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """Return the ``torch.device`` for ``device`` and set the exactness
    switches.  ``"cuda"`` without a visible card raises RuntimeError."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    # full-precision f32 products everywhere: no TF32 in matmul or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev
