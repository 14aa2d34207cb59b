"""device.idle_prefill_share: the share of the traced slice in which the
device was idle while the innermost program span was one of prompt
processing (``engine.prefill``, ``engine.extend`` and their parts). With
the other two ``device.idle_*_share`` metrics and the unlabelled rest it
sums to ``device.idle_share`` (``portbench/spans.py::idle_by_class``)."""
from portbench import spans


def read(ctx):
    return spans.idle_share(ctx, "prefill")
