"""System protocol — what a user must supply to simulate their model.

Port of ``montecarlo_tpu/core/system.py``.  A system is a static descriptor
(:class:`SystemDef`) of plain functions over a chain-batched state: every
leaf of the state has a leading chain axis, and each function works on all
chains at once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..utils.tree import tree_map

__all__ = ["SystemDef", "stack_chains"]


def _default_format_frame(t: int, frame) -> str:
    return f"{t}, {frame}"


@dataclasses.dataclass(frozen=True)
class SystemDef:
    """Static description of a simulatable system.

    Fields
    ------
    name:
        Human-readable name (written to ``summary.log``).
    log_target:
        ``state -> (M,)`` unnormalised log target density per chain.  Only
        needed by generic-apply moves.
    frame:
        ``state -> tree`` observable snapshot of all chains (leading chain
        axis), used by the trajectory recorders.  Defaults to the state.
    format_frame:
        ``(t, frame) -> str`` one text line for ONE chain's frame (a numpy
        value or Python scalar).
    parse_frame:
        Optional ``line -> frame`` inverse of ``format_frame``.
    refresh:
        Optional ``state -> state`` revalidation of derived caches, applied
        at every observation point.
    """

    name: str
    log_target: Optional[Callable[[Any], Any]] = None
    frame: Callable[[Any], Any] = lambda state: state
    format_frame: Callable[[int, Any], str] = _default_format_frame
    parse_frame: Optional[Callable[[str], Any]] = None
    refresh: Optional[Callable[[Any], Any]] = None


def stack_chains(states: list):
    """Stack a list of single-chain states into one chain-major state."""
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                    *states)
