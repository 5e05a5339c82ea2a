"""The benchmark of clip_fsar_torch, the PyTorch and CUDA port of CLIP-FSAR: one run of one cell
is ``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
