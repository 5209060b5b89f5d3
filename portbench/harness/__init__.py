"""The shared core of the port's benchmark: files, traffic, weights, spans,
the profiler slice, the roofline arithmetic and the three drivers.

What belongs to one configuration, one traffic mix, one per-layer metric or
one cell's limits lives in a file of its own under ``portbench/configs``,
``portbench/traffic``, ``portbench/metrics`` and ``portbench/limits``; this
package finds them by the names in ``BENCHMARK.json``.  Only ``port.py``
imports the program (``repro_torch``).
"""
