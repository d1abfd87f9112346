"""The benchmark of flow_tpu_torch: python3 flowbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>."""
