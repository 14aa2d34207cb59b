"""engine.prefill_graphed_share: the share of the prompt tokens landed in
the traced slice that a replayed graph landed: the tokens of the
program's ``engine.prefill`` (``sched_prefill``/``sched_admit``) and
``engine.extend`` (``sched_extend``) spans whose ``graphed`` attribute is
1, over the tokens of those that carry the attribute.  A program whose
spans carry no such attribute (one without captured prefill calls) reads
nothing."""
from portbench import spans


def read(ctx):
    got = [s for s in spans.spans_in(ctx) or ()
           if s.name in ("engine.prefill", "engine.extend")
           and getattr(s, "graphed", None) is not None]
    toks = sum(s.tokens for s in got)
    return sum(s.tokens for s in got if s.graphed) / toks if toks else None
