"""The training comparison: the plain reference follows the program's first
three train steps from the same initial weights, batches and dropout draws,
and three numbers are read, each a relative gap:

* ``loss_gap``: the widest |loss - reference loss| / |reference loss| over
  the three steps;
* ``grad_gap``: over the leaves, the widest gap between the norm of the
  first step's gradient as the program's optimizer got it and the
  reference's, against the reference's norm of that leaf or of the median
  leaf, whichever is larger;
* ``change_gap``: the same of each leaf's change over the three steps.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's (a key's bias under the softmax) move by round-off alone under
  Adam and are left out of it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .model import Adam, Reference, dropout_fn, no_tf32, train_loss

SMALL_GRAD = 1e-3


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def follow(params0: Dict[str, torch.Tensor], cfg: Dict, batches: Sequence[Dict[str, torch.Tensor]],
           gen_state: torch.Tensor, device, scored: torch.Tensor, lr: float, rate: float,
           keep_scale: float, quant: str = "none", rows: Optional[slice] = None):
    """The reference's losses of the three steps, its first gradient's and
    its change's leaf norms.  ``rows`` keeps only those rows of each batch
    (a planted fault: part of the batch left out)."""
    no_tf32()
    params = {k: v.detach().to(device).float().clone().requires_grad_(True) for k, v in params0.items()}
    ref = Reference(params, cfg, quant=quant)
    opt = Adam({k: v.detach() for k, v in params.items()}, lr)
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    drop = dropout_fn(gen, rate, keep_scale)
    losses: List[float] = []
    first = None
    for batch in batches:
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        loss = train_loss(ref, batch, scored, drop)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        if first is None:
            first = norms(grads)
        losses.append(float(loss.detach()))
        opt.step({k: v.data for k, v in params.items()}, grads)
    change = norms({k: params[k].detach() - params0[k].to(device).float() for k in params})
    return losses, first, change


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's gap, against its norm or the median leaf's."""
    median = float(np.median([want[k] for k in want]))
    return {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30)
            for k in want if keep is None or keep(k)}


def readings(prog_losses, prog_grad, prog_change, ref_losses, ref_grad, ref_change,
             detail: bool = False) -> Dict:
    """The three numbers of one run (leaf norms as dicts of floats);
    ``detail`` adds the worst leaves and the median leaf's gaps."""
    median = float(np.median(list(ref_grad.values())))
    moved = lambda k: ref_grad[k] >= SMALL_GRAD * median  # noqa: E731
    grad, change = leaf_gaps(prog_grad, ref_grad), leaf_gaps(prog_change, ref_change, moved)
    out = dict(
        loss_gap=max(abs(a - b) / abs(b) for a, b in zip(prog_losses, ref_losses)),
        grad_gap=max(grad.values()),
        change_gap=max(change.values()),
    )
    if detail:
        out.update(
            loss_gap_first=abs(prog_losses[0] - ref_losses[0]) / abs(ref_losses[0]),
            grad_gap_median=float(np.median(list(grad.values()))),
            change_gap_median=float(np.median(list(change.values()))),
            grad_worst=sorted(grad, key=grad.get)[-3:], change_worst=sorted(change, key=change.get)[-3:],
            left_out=sorted(set(ref_change) - set(change)))
    return out
