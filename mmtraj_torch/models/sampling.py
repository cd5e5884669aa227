"""Diverse K-subset selection over sampled rollouts (counterpart of
``mmtraj/models/sampling.py``).

Best-of-K scores the best of the K submitted trajectories, so a K-set that
covers the predictive distribution beats K i.i.d. draws.  Both functions
oversample R candidates and keep K by greedy farthest-point selection on the
endpoints: start from candidate 0, then repeatedly add the candidate whose
nearest chosen endpoint is farthest.  The picks use ``torch.argmax``, whose
first maximal index wins as in the JAX package (padded agents have identical
endpoints, so their ties are exact), and ``torch.gather``.
"""

from __future__ import annotations

import torch


def _greedy_picks(d2: torch.Tensor, k: int) -> torch.Tensor:
    """d2 (R, R, *rest) pairwise squared distances -> (k, *rest) indices of
    the greedy max-min picks, starting from candidate 0."""
    R = d2.shape[0]
    picks = [torch.zeros(d2.shape[2:], dtype=torch.long, device=d2.device)]
    mind = d2[0]  # (R, *rest): each candidate's distance to the chosen set
    for _ in range(k - 1):
        nxt = torch.argmax(mind, dim=0)
        picks.append(nxt)
        d_new = torch.gather(d2, 1, nxt[None, None].expand((R, 1) + nxt.shape))[:, 0]
        mind = torch.minimum(mind, d_new)
    return torch.stack(picks)


def diverse_select(preds: torch.Tensor, k: int) -> torch.Tensor:
    """Greedy farthest-point K-subset per agent: preds (R, B, N, Tp, 2) ->
    (K, B, N, Tp, 2).  R == K returns the input; R < K raises."""
    R = preds.shape[0]
    if k > R:
        raise ValueError(f"cannot select {k} from {R} candidates")
    if k == R:
        return preds
    end = preds[..., -1, :].float()  # (R, B, N, 2)
    d2 = ((end[:, None] - end[None, :]) ** 2).sum(-1)  # (R, R, B, N)
    sel = _greedy_picks(d2, k)  # (K, B, N)
    return torch.gather(preds, 0, sel[..., None, None].expand((k,) + preds.shape[1:]))


def diverse_select_joint(preds: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Greedy farthest-point K-subset per window, joint samples kept whole:
    preds (R, B, N, Tp, 2), mask (B, N) -> (K, B, N, Tp, 2).  Two joint
    samples are as far apart as the masked mean over agents of their squared
    endpoint distances."""
    R = preds.shape[0]
    if k > R:
        raise ValueError(f"cannot select {k} from {R} candidates")
    if k == R:
        return preds
    end = preds[..., -1, :].float()
    m = mask.float()  # (B, N)
    denom = m.sum(dim=1).clamp_min(1.0)
    d2 = (((end[:, None] - end[None, :]) ** 2).sum(-1) * m).sum(-1) / denom  # (R, R, B)
    sel = _greedy_picks(d2, k)  # (K, B)
    return torch.gather(preds, 0, sel[:, :, None, None, None].expand((k,) + preds.shape[1:]))
