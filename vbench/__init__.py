"""The benchmark of the PyTorch and CUDA port (``vision_tpu_torch``) on one
H100: ``python3 vbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``. See ``vbench/harness.py``."""
