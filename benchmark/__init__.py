"""The benchmark of colbert_torch on an NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line. Cells,
configurations, traffic drivers and per-layer metrics are files of their
own under this folder, found by name (:mod:`benchmark.registry`). The
yardstick (generators, the plain reference, the roofline arithmetic and the
comparison that decides ``correct``) lives here too and imports nothing of
the program.
"""
