"""The benchmark of ``dust_tpu_torch`` on one card: ``python3
benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` (see ``run.py``)."""
