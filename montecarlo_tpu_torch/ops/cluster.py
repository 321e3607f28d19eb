"""Whole-lattice connected-component labelling for cluster Monte Carlo.

Port of ``montecarlo_tpu/ops/cluster.py``: given per-bond activation masks
on a periodic 2-D lattice, label every activated-bond connected component
as a fixpoint of whole-lattice tensor operations, batched over chains
(masks of shape (M, L1, L2)).

Algorithm: *min-label propagation with pointer jumping*.

1. Every site starts with its own label (its linear index).
2. Each sweep takes the minimum of a site's label and the labels of the up
   to four neighbours reachable through active bonds (four rolls, selects
   and minima over the whole lattice).
3. A pointer-jumping step replaces each site's label by the label of the
   site it points at (``l = l.flat[l]``, one ``torch.gather`` per chain),
   doubling the distance information travels per iteration.
4. Iterate to the fixpoint: O(log(diameter)) iterations.

``labels[c, i, j]`` is the minimum linear index over the component of site
(i, j) of chain c.  Labels are integers, so they equal the reference's
exactly for the same bonds.

Both loops run to a fixpoint on every chain at once; an iteration past a
chain's fixpoint leaves it unchanged, so the fixpoint is read on the host
only every ``check_every`` iterations (each read waits for the card).
"""

from __future__ import annotations

import torch

__all__ = ["component_labels", "seed_component_mask"]

#: iterations between two reads of a loop's fixpoint on the host
CHECK_EVERY = 4


def _batched(*masks):
    """The masks with a leading chain axis, and whether one was added."""
    single = masks[0].dim() == 2
    return tuple(m[None] if single else m for m in masks), single


def _min_propagate(labels, act_right, act_down):
    """One sweep: min over self and the bond-connected neighbours."""
    # right bond connects (i, j) <-> (i, j+1); act_right[i, j] gates it
    from_right = torch.where(act_right, torch.roll(labels, -1, 2), labels)
    from_left = torch.where(torch.roll(act_right, 1, 2),
                            torch.roll(labels, 1, 2), labels)
    # down bond connects (i, j) <-> (i+1, j); act_down[i, j] gates it
    from_down = torch.where(act_down, torch.roll(labels, -1, 1), labels)
    from_up = torch.where(torch.roll(act_down, 1, 1),
                          torch.roll(labels, 1, 1), labels)
    return torch.minimum(
        torch.minimum(torch.minimum(from_right, from_left),
                      torch.minimum(from_down, from_up)), labels)


def _fixpoint(step, x, check_every):
    """Apply ``step`` until ``x`` stops changing, reading the fixpoint only
    every ``check_every`` iterations."""
    while True:
        for _ in range(check_every - 1):
            x = step(x)
        prev, x = x, step(x)
        if torch.equal(prev, x):
            return x


def component_labels(act_right, act_down, check_every: int = CHECK_EVERY):
    """Label the activated-bond connected components of periodic 2-D
    lattices.

    Args:
      act_right: (M, L1, L2) bool (or one (L1, L2) lattice): bond
        (i, j)–(i, j+1 mod L2) active.
      act_down: the same shape: bond (i, j)–(i+1 mod L1, j) active.

    Returns:
      int32 labels of the masks' shape; sites of a chain share a value iff
      they are connected through active bonds, and the value is the
      component's minimum linear index.
    """
    (act_right, act_down), single = _batched(act_right, act_down)
    m, lx, ly = act_right.shape
    init = torch.arange(lx * ly, dtype=torch.int64,
                        device=act_right.device).reshape(1, lx, ly)
    init = init.expand(m, lx, ly).contiguous()

    def step(labels):
        new = _min_propagate(labels, act_right, act_down)
        # pointer jumping: adopt the label of the site my label points at
        flat = new.reshape(m, lx * ly)
        return torch.gather(flat, 1, flat).reshape(m, lx, ly)

    labels = _fixpoint(step, init, check_every).to(torch.int32)
    return labels[0] if single else labels


def seed_component_mask(act_right, act_down, site,
                        check_every: int = CHECK_EVERY):
    """Boolean mask of the component containing linear ``site``: an (M,)
    integer tensor, one site a chain (or an int for one (L1, L2) lattice).

    The Wolff primitive: dilate a one-hot seed through active bonds until
    the fixpoint; O(cluster diameter) iterations of four rolls."""
    (act_right, act_down), single = _batched(act_right, act_down)
    m, lx, ly = act_right.shape
    site = torch.as_tensor(site, device=act_right.device).reshape(-1)
    mask = (torch.arange(lx * ly, device=act_right.device)[None, :]
            == site[:, None]).reshape(m, lx, ly)

    def dilate(mask):
        return (mask
                | torch.roll(mask & act_right, 1, 2)
                | (torch.roll(mask, -1, 2) & act_right)
                | torch.roll(mask & act_down, 1, 1)
                | (torch.roll(mask, -1, 1) & act_down))

    mask = _fixpoint(dilate, mask, check_every)
    return mask[0] if single else mask
