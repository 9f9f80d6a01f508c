"""The benchmark's plain PyTorch reference of the tracking path: the four
nets (nets.py), the ops they and the stages use (ops.py), and the stages,
the merge and run_sequence (pipeline.py). It imports nothing of the
measured program."""
