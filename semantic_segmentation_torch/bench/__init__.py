"""Benchmarks of the port's kernels on the card: ``conv_down`` (the port of
``scripts/bench_conv_down.py``) and ``kernels`` (the port of
``scripts/bench_pallas.py``). Run as ``python -m
semantic_segmentation_torch.bench.<name>``; each needs a CUDA card."""
