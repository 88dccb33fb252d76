"""Plain ProtoNet refinement (PIGEON, arXiv:2307.05845, section 4.3),
worked out again from the raw bank.

A cell's clusters are its prototype rows, the largest first, at most
``max_protos_per_cell``; a cluster's prototype is the mean embedding of
its first ``max_members_per_cluster`` members. For each of the top
``refiner_topk`` candidate cells, the nearest prototype's negative
euclidean distance is the candidate's logit; the candidates' geocell
probabilities times the softmax of those logits over the temperature
pick a cell, and within its nearest cluster the nearest member's
location (a cluster of one: its prototype's location) is the guess.
Where that guess lies farther than ``max_refinement_km`` from the
top-1 cell's centroid, the geocell probabilities pick the cell alone.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.model import haversine_matrix


class Bank:
    """The bank's clusters by cell, from the raw rows: ``rows`` of
    (cell, lng, lat, member indices), the members' embeddings and
    locations."""

    def __init__(self, rows, bank_emb: torch.Tensor, bank_lla: np.ndarray,
                 cfg: dict):
        self.emb, self.lla, self.cfg = bank_emb, bank_lla, cfg
        by_cell = {}
        for cell, lng, lat, idx in rows:
            by_cell.setdefault(int(cell), []).append((lng, lat, list(idx)))
        self.clusters = {
            c: sorted(v, key=lambda r: -len(r[2]))[:cfg["max_protos_per_cell"]]
            for c, v in by_cell.items()}

    def members(self, idx):
        return idx[:self.cfg["max_members_per_cluster"]]

    def cell(self, c: int, e: torch.Tensor):
        """The cell's clusters: their distances to ``e``, their members'
        distances, locations and counts."""
        out = []
        for lng, lat, idx in self.clusters.get(int(c), []):
            m = torch.as_tensor(self.members(idx), device=self.emb.device)
            emb = self.emb[m]
            out.append({"proto_d": (emb.mean(0) - e).norm().item(),
                        "member_d": (emb - e).norm(dim=-1),
                        "member_lla": self.lla[np.asarray(self.members(idx))],
                        "proto_lla": np.float32([lng, lat]),
                        "count": len(idx)})
        return out


def _guess(clusters):
    """The nearest cluster's index and its location (nearest member, or
    the prototype's for a cluster of one)."""
    p = int(np.argmin([c["proto_d"] for c in clusters]))
    c = clusters[p]
    if c["count"] > 1:
        return p, c["member_lla"][int(c["member_d"].argmin())]
    return p, c["proto_lla"]


def refine(bank: Bank, e: torch.Tensor, cand_cells, cand_probs,
           centroid_top1):
    """The refined guess ``(cell, (lng, lat))`` for the view-mean
    embedding ``e`` and the candidate cells and probabilities, the first
    ``refiner_topk`` of them."""
    cfg = bank.cfg
    k = cfg["refiner_topk"]
    cells = [int(c) for c in cand_cells[:k]]
    probs = torch.as_tensor(np.asarray(cand_probs[:k], np.float64))
    per = [bank.cell(c, e) for c in cells]
    logits = torch.tensor([-min(c["proto_d"] for c in cl) if cl else -1e5
                           for cl in per], dtype=torch.float64)
    final = probs * torch.softmax(logits / cfg["refiner_temperature"], -1)

    def guess(j):
        return _guess(per[j])[1] if per[j] else np.float32([0.0, 0.0])

    moved = haversine_matrix(
        torch.as_tensor(np.float32([centroid_top1])),
        torch.as_tensor(np.float32([guess(int(final.argmax()))]))).item()
    if moved > cfg["max_refinement_km"]:
        final = probs
    pick = int(final.argmax())
    return cells[pick], guess(pick)
