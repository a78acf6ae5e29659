"""The benchmark of ``image_restoration_sde_tpu_torch`` on NVIDIA GPUs.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that decides a number lives here: traffic
generation, the window's arithmetic, the reduction of profiler traces, the
table of peaks, each kernel's bytes and operations, a plain float32
reference of every configuration and the comparison that decides
``correct``.  From the port it takes only the system under test and its
counters.
"""
