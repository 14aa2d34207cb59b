"""device.idle_share.chat: ``device.idle_share`` in the open-loop chat
cell, where it moves the time between tokens."""
from portbench import spec

read = spec.reader("device.idle_share").read
