"""Where the port's tensors live: every public function that takes a
`device` runs on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None; raises when the card is asked
    for and there is none."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev
