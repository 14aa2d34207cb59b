"""The expert layers of a model with experts: the least time of each
layer's expert block, counted from the configuration and the routing the
program recorded, never from the kernels that ran, and the readers of the
program's expert records in the traced slice.

The program (``repro_torch.runtime.trace``) records, for each decode
chunk's last step, the expert blocks' device ms summed over the layers
(``PhaseRecord.moe``, from timing events around each layer's block in the
captured step) and, per layer, the (token, choice) rows routed, the
experts that took a row and the largest expert's rows (``RouteRecord``).
A program without those records (one whose step has no expert tap) has
nothing to read: each reader returns None.

A layer's least time is the larger of its bytes over the HBM rate and its
operations over the bf16 peak (``yardstick``'s peaks).  Bytes: each hit
expert's three bf16 weight matrices (3 x d x f x 2 B), read once, and the
gathered input rows and the output rows (rows x d x 2 B each).
Operations: the three expert products, 6 x d x f a row, and the float32
router, 2 x d x E a token (rows / K tokens).
"""
from __future__ import annotations

from portbench import spans, yardstick


def layer_bytes(cfg: dict, rows: int, hit: int) -> float:
    m = yardstick.dims(cfg)
    d, f = m["d"], m["f"]
    return float(yardstick.BF16 * (3 * d * f * hit + 2 * rows * d))


def layer_ops(cfg: dict, rows: int) -> float:
    m = yardstick.dims(cfg)
    d, f = m["d"], m["f"]
    return 6.0 * d * f * rows + 2.0 * d * m["E"] * rows / m["K"]


def bound_s(cfg: dict, rows, hit) -> float:
    """Least time of one step's expert blocks: per layer (``rows`` and
    ``hit`` give a value a layer) the larger of bytes over the HBM rate
    and operations over the bf16 peak, summed over the layers."""
    return sum(max(layer_bytes(cfg, r, h) / yardstick.HBM_BYTES_PER_S,
                   layer_ops(cfg, r) / yardstick.PEAK_BF16_FLOPS)
               for r, h in zip(rows, hit))


def _in_slice(ctx, key: str) -> list:
    """The snapshot's ``key`` records ("phases", "routes") read in the
    traced slice; [] when there is no slice, tracer or such record."""
    tr = ctx.trace
    snap = spans.snapshot(ctx) if tr is not None else None
    if snap is None:
        return []
    lo, hi = tr["t0"] * 1e9, tr["t1"] * 1e9
    return [r for r in snap.get(key) or () if lo <= r.t <= hi]


def _moe_phases(ctx) -> list:
    return [p for p in _in_slice(ctx, "phases")
            if getattr(p, "moe", None) is not None]


def expert_ms(ctx):
    """Mean device ms a step of the expert blocks, summed over the
    layers, over the chunks read in the slice."""
    ms = [p.moe for p in _moe_phases(ctx)]
    return sum(ms) / len(ms) if ms else None


def roofline(ctx):
    """The steps' least expert time over their device time, in %, over
    the chunks whose step has both records in the slice (one read)."""
    ms = {p.t: p.moe for p in _moe_phases(ctx)}
    bound = dev = 0.0
    for r in _in_slice(ctx, "routes"):
        if r.t in ms:
            bound += bound_s(ctx.cfg, r.rows, r.hit)
            dev += ms[r.t] / 1e3
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None


def load_max_over_mean(ctx):
    """The largest expert's rows over the mean rows an expert (rows / E),
    per layer, mean over the layers and the chunks read in the slice."""
    E = yardstick.dims(ctx.cfg)["E"]
    vals = [top * E / rows for r in _in_slice(ctx, "routes")
            for rows, top in zip(r.rows, r.top) if rows]
    return sum(vals) / len(vals) if vals else None
