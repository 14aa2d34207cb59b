"""Verification trees (paper §III-C1, Fig. 8).

A verification tree of width W decides which combinations of Medusa head
candidates are verified in one step.  Node 0 is the root (the last committed
token — always correct); a node at depth d (1..H) holds head d's rank-r
candidate.  Construction:

  1. *Accuracy-based estimation*: per-head top-k calibration accuracies
     acc[h][r]; a candidate sequence's probability is the product of its
     node accuracies; expected acceptance length = 1 + sum of path products
     over all non-root nodes.  Greedy: repeatedly add the frontier node with
     the highest path product until W nodes.
  2. *Brute-force refinement*: local search over leaf swaps (and same-level
     alternatives), scored by a pluggable evaluator — the estimator by
     default, or empirical acceptance on calibration data (ARCA runtime).

Everything here is preprocessing: plain numpy, producing a static
``TreeSpec`` whose arrays the verify step consumes as a ``Tree`` of device
tensors.  The builder is a copy of ``repro/core/speculative/tree.py``
(that module imports jax when it loads).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


# Node = (parent_index, depth, rank); root = (-1, 0, 0).
@dataclasses.dataclass(frozen=True)
class TreeSpec:
    width: int
    max_depth: int                    # deepest node depth + 1 (committed slots)
    depth: np.ndarray                 # (W,) int32 — node depth (root=0)
    parent: np.ndarray                # (W,) int32 — parent index (root=-1)
    rank: np.ndarray                  # (W,) int32 — head candidate rank
    mask: np.ndarray                  # (W,W) bool — ancestor-or-self
    paths: np.ndarray                 # (P,D) int32 — root->leaf chains (padded
                                      #   by repeating the leaf)
    node_path: np.ndarray             # (W,) int32 — a path through each node
    node_depth: np.ndarray            # (W,) int32 — == depth
    n_paths: int

    def shape(self) -> tuple:
        """Shape bucket ``(width, max_depth, n_paths)``."""
        return (self.width, self.max_depth, self.n_paths)


@dataclasses.dataclass(frozen=True)
class Tree:
    """Device view of a TreeSpec: its arrays as tensors on one device, used
    by ``model.verify`` and the speculative step.  Index arrays are int64
    (torch's index type); ``mask`` is bool."""
    width: int
    max_depth: int
    depth: torch.Tensor
    mask: torch.Tensor
    paths: torch.Tensor
    node_path: torch.Tensor
    node_depth: torch.Tensor
    parent: torch.Tensor
    rank: torch.Tensor

    def shape(self) -> tuple:
        """Shape bucket, mirroring ``TreeSpec.shape``."""
        return (self.width, self.max_depth, int(self.paths.shape[0]))

    @staticmethod
    def from_spec(spec: "TreeSpec", device) -> "Tree":
        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)
        return Tree(width=spec.width, max_depth=spec.max_depth,
                    depth=t(spec.depth),
                    mask=torch.as_tensor(spec.mask, device=device),
                    paths=t(spec.paths), node_path=t(spec.node_path),
                    node_depth=t(spec.node_depth), parent=t(spec.parent),
                    rank=t(spec.rank))


def spec_from_nodes(nodes: Sequence[Tuple[int, int, int]]) -> TreeSpec:
    """nodes: list of (parent, depth, rank); nodes[0] must be the root."""
    W = len(nodes)
    parent = np.array([n[0] for n in nodes], np.int32)
    depth = np.array([n[1] for n in nodes], np.int32)
    rank = np.array([n[2] for n in nodes], np.int32)
    assert parent[0] == -1 and depth[0] == 0
    assert all(parent[i] < i for i in range(1, W)), "nodes must be topo-ordered"
    # ancestor-or-self mask
    mask = np.zeros((W, W), bool)
    for i in range(W):
        j = i
        while j >= 0:
            mask[i, j] = True
            j = parent[j]
    # root->leaf paths
    children = [[] for _ in range(W)]
    for i in range(1, W):
        children[parent[i]].append(i)
    leaves = [i for i in range(W) if not children[i]]
    D = int(depth.max()) + 1
    paths = np.zeros((len(leaves), D), np.int32)
    for p, leaf in enumerate(leaves):
        chain = []
        j = leaf
        while j >= 0:
            chain.append(j)
            j = parent[j]
        chain = chain[::-1]
        chain += [leaf] * (D - len(chain))       # pad by repeating the leaf
        paths[p] = chain
    node_path = np.zeros((W,), np.int32)
    for p in range(len(leaves)):
        for d_i in range(D):
            node_path[paths[p, d_i]] = p
    return TreeSpec(width=W, max_depth=D, depth=depth, parent=parent,
                    rank=rank, mask=mask, paths=paths, node_path=node_path,
                    node_depth=depth, n_paths=len(leaves))


def chain_spec(length: int) -> TreeSpec:
    """Degenerate single-path tree: node i at depth i under node i-1, so
    ``depth = arange(length)`` and the ancestor mask is lower-triangular.
    ``verify`` over it is plain causal attention at the cache's offset —
    the chunked-prefill pieces (runtime/engine.py ``sched_extend``) reuse
    the tree-verification path with this spec instead of growing a second
    multi-token forward."""
    return spec_from_nodes([(-1, 0, 0)]
                           + [(i - 1, i, 0) for i in range(1, length)])


# --------------------------------------------------------------------------
# expected acceptance length (the paper's estimator)
# --------------------------------------------------------------------------
def path_products(spec: TreeSpec, accs: np.ndarray) -> np.ndarray:
    """accs: (H, K) per-head top-k accuracies -> (W,) path product per node
    (root = 1)."""
    prods = np.ones((spec.width,), np.float64)
    for i in range(1, spec.width):
        h = spec.depth[i] - 1
        prods[i] = prods[spec.parent[i]] * accs[h, spec.rank[i]]
    return prods


def expected_acceptance_length(spec: TreeSpec, accs: np.ndarray) -> float:
    """E[AL] = 1 (bonus token) + sum of per-node acceptance probabilities."""
    return float(1.0 + path_products(spec, accs)[1:].sum())


# --------------------------------------------------------------------------
# greedy construction (estimation step of Fig. 8)
# --------------------------------------------------------------------------
def build_tree_greedy(accs: np.ndarray, width: int,
                      max_depth: Optional[int] = None) -> TreeSpec:
    """Add the highest-path-probability candidate node until ``width`` nodes."""
    H, K = accs.shape
    max_depth = min(max_depth or H, H)
    nodes: List[Tuple[int, int, int]] = [(-1, 0, 0)]
    prods = [1.0]
    # frontier: candidate (prob, parent_idx, depth, rank)
    import heapq
    heap: list = []

    def push_children(idx):
        d = nodes[idx][1] + 1
        if d > max_depth:
            return
        for r in range(K):
            heapq.heappush(heap, (-prods[idx] * accs[d - 1, r],
                                  len(heap), idx, d, r))

    used = set()                                  # (parent, rank) pairs
    push_children(0)
    while len(nodes) < width and heap:
        negp, _, parent, d, r = heapq.heappop(heap)
        if (parent, r) in used:
            continue
        used.add((parent, r))
        nodes.append((parent, d, r))
        prods.append(-negp)
        push_children(len(nodes) - 1)
    return spec_from_nodes(nodes)


# --------------------------------------------------------------------------
# brute-force refinement (search step of Fig. 8)
# --------------------------------------------------------------------------
def refine_tree(spec: TreeSpec, accs: np.ndarray,
                evaluator: Optional[Callable[[TreeSpec], float]] = None,
                max_rounds: int = 4) -> TreeSpec:
    """Local search: try replacing each leaf with an alternative candidate
    (sibling ranks and children of other nodes at the same level), keep any
    strict improvement.  ``evaluator`` defaults to the estimator but ARCA can
    pass an empirical acceptance measurer (paper compares *real* acceptance
    lengths)."""
    H, K = accs.shape
    if evaluator is None:
        evaluator = lambda s: expected_acceptance_length(s, accs)

    best = spec
    best_score = evaluator(spec)
    for _ in range(max_rounds):
        improved = False
        nodes = list(zip(best.parent.tolist(), best.depth.tolist(),
                         best.rank.tolist()))
        children = [[] for _ in nodes]
        for i in range(1, len(nodes)):
            children[nodes[i][0]].append(i)
        leaves = [i for i in range(1, len(nodes)) if not children[i]]
        used = {(p, r) for (p, _, r) in nodes[1:]}
        # alternatives: any (parent, rank) not in the tree; parent index must
        # precede the leaf (keeps topo order, prevents ancestor cycles)
        for leaf in leaves:
            for parent in range(leaf):
                d = nodes[parent][1] + 1
                if d > H:
                    continue
                for r in range(K):
                    if (parent, r) in used:
                        continue
                    cand = list(nodes)
                    cand[leaf] = (parent, d, r)
                    # replacing a leaf keeps all other parent links valid
                    try:
                        cspec = spec_from_nodes(cand)
                    except AssertionError:
                        continue
                    s = evaluator(cspec)
                    if s > best_score + 1e-12:
                        best, best_score, improved = cspec, s, True
                        nodes = cand
                        used = {(p, r2) for (p, _, r2) in nodes[1:]}
                        break
                if improved:
                    break
            if improved:
                break
        if not improved:
            break
    return best


def build_tree(accs: np.ndarray, width: int,
               evaluator: Optional[Callable[[TreeSpec], float]] = None,
               refine: bool = True) -> TreeSpec:
    spec = build_tree_greedy(accs, width)
    if refine and width > 2:
        spec = refine_tree(spec, accs, evaluator)
    return spec


def candidate_spec(accs: np.ndarray, width: int,
                   evaluator: Optional[Callable[[TreeSpec], float]] = None
                   ) -> TreeSpec:
    """The candidate tree ARCA considers at a given width: the degenerate
    root-only spec at width 1 (acceptance is exactly 1, nothing to draft
    or refine), else greedy construction + refinement.  The ONE place the
    width-1 special case lives — choose_strategy, profile_engine and the
    serve/bench candidate sets all build through here."""
    if width == 1:
        return spec_from_nodes([(-1, 0, 0)])
    return build_tree(accs, width, evaluator=evaluator)


# --------------------------------------------------------------------------
# default calibration accuracies
# --------------------------------------------------------------------------
def default_accs(H: int = 4, K: int = 10, a1: float = 0.72, head_decay: float = 0.82,
                 rank_decay: float = 0.42) -> np.ndarray:
    """Synthetic per-head top-k accuracy table in the regime Medusa reports
    (head-1 top-1 ~0.6-0.75, decaying with head index and rank).  The exact
    values used for Table-I validation are fitted in benchmarks/acceptance.py."""
    h = np.arange(H)[:, None]
    r = np.arange(K)[None, :]
    return a1 * (head_decay ** h) * (rank_decay ** r)
