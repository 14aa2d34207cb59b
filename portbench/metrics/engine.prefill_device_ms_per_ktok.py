"""engine.prefill_device_ms_per_ktok: the device's time from the start to
the end of each ``engine.prefill`` and ``engine.extend`` call of the
traced slice, timed by the program's CUDA events at the call's start and
end (read after a later host transfer, never synchronised), in ms a
thousand prompt tokens.  The device waits for launches inside that time
too: near ``engine.prefill_launch_ms_per_ktok`` the host sets the pace."""
from portbench import spans


def read(ctx):
    got = [d for d in spans.device_in(ctx) or ()
           if d.name in ("engine.prefill", "engine.extend")]
    toks = sum(d.tokens for d in got)
    return sum(sum(d.ms) for d in got) / (toks / 1e3) if toks else None
