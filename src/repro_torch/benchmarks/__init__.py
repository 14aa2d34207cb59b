"""The paper's evaluation harness on the port (counterpart of the
repository's ``benchmarks/`` and ``repro/benchlib.py``): Table I, Fig. 9,
Fig. 10a/10b, the ablations, the microbenchmarks, the measured engine and
scheduler benches and the roofline note.  ``run.py`` is the entry point:

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]

Table I, Fig. 9, Fig. 10a and the ablations are analytic: their numbers
are predictions of the paper's Jetson model (``core/arca.py``), not times
of the device the harness runs on.
"""
