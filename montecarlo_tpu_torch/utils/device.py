"""Where an entry point puts the tensors it creates from nothing.

The package runs on the card: an entry point that makes tensors (the
``init_chains`` of the models, ``interop.chains_from_reference``,
``init_gradient_data``, ``software_bits``) puts them on ``cuda`` unless the
caller names a device.  There is no test for a card here and no fall-back:
on a machine without one, a call without ``device=`` raises torch's own
error.  Functions that receive tensors (``Simulation``, the sweep wrappers,
``checkpoint.restore``) follow their inputs instead.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``torch.device(device)``, or ``torch.device("cuda")`` for None."""
    return torch.device("cuda" if device is None else device)
