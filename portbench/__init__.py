"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on an NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything a cell needs is found by name: its model
configuration in ``portbench/configs/``, its traffic mix in
``portbench/traffic/`` and each metric's reader in ``portbench/metrics/``.

The yardstick lives here and nowhere in the program: the traffic
generator, the window arithmetic, the profiler reduction, the peaks and
the operation and byte counts, and the plain float32 reference
(``portbench/reference/``) that decides ``correct``.  From the program the
benchmark takes only the serving stack it drives (the streaming server,
the continuous scheduler and the decode engine), the engine's slot-protocol
calls it wraps in spans, and the kernel names in the device trace.
"""
