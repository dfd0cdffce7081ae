"""The benchmark of neighborretr_tpu_torch: `python benchmark/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>`, cells listed in
BENCHMARK.json at the checkout's root."""
