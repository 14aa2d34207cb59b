"""step.verify_ms: device ms a decode step of the verify forward over the
tree, between the timing events the captured step records at its phase
boundaries (``core/speculative/verify.py::spec_step``), read after each
chunk's host transfer for the chunk's last step, mean over the chunks of
the traced slice."""
from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "verify")
