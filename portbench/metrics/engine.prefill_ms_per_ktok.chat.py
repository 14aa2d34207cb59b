"""engine.prefill_ms_per_ktok.chat: ``engine.prefill_ms_per_ktok`` in the
open-loop chat cell, where it moves the time to first token."""
from portbench import spec

read = spec.reader("engine.prefill_ms_per_ktok").read
