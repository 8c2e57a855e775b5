"""The benchmark of neural_admixture_tpu_torch: training throughput of the
port on one NVIDIA H100, driven by the cells of ``BENCHMARK.json``.

Run one cell once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result as one JSON object.
"""
