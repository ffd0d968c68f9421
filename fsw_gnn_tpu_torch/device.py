"""Where the port's entry points run.

Every constructor and server takes an explicit `device`.  None means the
card: with no CUDA device present that raises, so nothing quietly carries
on on the CPU.  Pass device='cpu' to run the plain PyTorch versions of the
kernels (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None -> 'cuda'.  Raises when a CUDA
    device is asked for (or implied) and none is available.

    On the card this also pins float32 matrix products and convolutions to
    full float32 (no TF32), so the MLP head computes what the CPU does up
    to summation order."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run the '
                'plain PyTorch path on the CPU')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {dev}')
    return dev
