"""Tree verification through recurrent (SSM) blocks (counterpart of
``repro/models/recurrent_verify.py``).

A state-space recurrence cannot attend sparsely to a token tree the way
attention can: the tree's paths are verified by replicating the state per
path and stepping each path's tokens, depth by depth (a Python loop over
the tree's depth D where the reference scans).  Node outputs are recovered
from (path, depth) coordinates: paths sharing a prefix give the same
output there, so any covering path works.  The draft then costs P x D
steps instead of W tree slots.
"""
from __future__ import annotations

import torch

from repro_torch.core.hcmp.sharding import empty, per_row


def expand_paths(x_nodes, paths):
    """x_nodes: (B, W, d); paths: (P, D) node ids -> (D, B, P, d)."""
    return x_nodes[:, paths].permute(2, 0, 1, 3)


def collapse_nodes(y_steps, node_path, node_depth):
    """y_steps: (D, B, P, d) -> node outputs (B, W, d)."""
    return y_steps[node_depth, :, node_path].transpose(0, 1)


def replicate_state(state, P):
    """Tile each (B, ...) state leaf to (B*P, ...)."""
    def rep(s):
        return s[:, None].expand((s.shape[0], P) + tuple(s.shape[1:])) \
            .reshape((s.shape[0] * P,) + tuple(s.shape[1:]))
    return {k: rep(v) for k, v in state.items()}


def path_verify(step_fn, x_nodes, state, paths, node_path, node_depth,
                out=None):
    """Run ``step_fn`` over every tree path with per-path state.

    ``step_fn(x_t (B*P, d), state, slot) -> (y (B*P, d), state)``, where
    ``slot`` holds this depth's entries of the per-depth states (a dict of
    (B*P, ...) tensors): a step may write its new state there, else it is
    copied in.  ``out`` gives the per-depth state tensors, each leaf
    (D, B*P, ...) (allocated when None).  Returns (y_nodes (B, W, d), the
    per-depth states): the states AFTER each depth, which
    ``select_committed_state`` reads once the accepted path is known."""
    B, W, d = x_nodes.shape
    P, D = paths.shape
    xs = expand_paths(x_nodes, paths).reshape(D, B * P, d)
    st = replicate_state(state, P)
    if out is None:
        out = {k: empty((D,) + tuple(v.shape), v, range(1, v.dim() + 1))
               for k, v in st.items()}
    ys = []
    for t in range(D):
        slot = {k: v[t] for k, v in out.items()}
        y, new = step_fn(xs[t], st, slot)
        for k, v in new.items():
            if v is not slot[k]:
                slot[k].copy_(v)
        st = slot
        ys.append(y)
    y_nodes = collapse_nodes(torch.stack(ys).reshape(D, B, P, -1),
                             node_path, node_depth)
    return y_nodes, out


def committed_index(n_accept, D):
    """Depth index of each row's committed state: n_accept - 1, a
    negative index wrapped as JAX's dynamic index wraps it (a row with
    n_accept == 0 reads depth D - 1; the hybrid commit keeps the row's
    previous state there)."""
    return torch.remainder(n_accept.long() - 1, D)


def select_committed_state(per_depth_states, path_idx, n_accept, batch, P):
    """State after accepting ``n_accept[b]`` tokens along path
    ``path_idx[b]`` for each sequence b.  per_depth_states leaves:
    (D, B*P, ...); path_idx/n_accept: (B,).  Returns leaves (B, ...)."""
    rows = torch.arange(batch, device=path_idx.device)

    def sel(s, path_idx, n_accept):
        b = path_idx.shape[0]                 # on DTensors: this rank's rows
        sbp = s.reshape((s.shape[0], b, P) + tuple(s.shape[2:]))
        return sbp[committed_index(n_accept, s.shape[0]),
                   rows if b == batch else rows[:b], path_idx.long()]

    return {k: per_row(sel, v, path_idx, n_accept, batch_dim=1)
            for k, v in per_depth_states.items()}
