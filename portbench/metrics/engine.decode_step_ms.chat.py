"""engine.decode_step_ms.chat: ``engine.decode_step_ms`` in the open-loop
chat cell, where it moves the time between tokens."""
from portbench import spec

read = spec.reader("engine.decode_step_ms").read
