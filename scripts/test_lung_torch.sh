#!/usr/bin/env bash
# The port's test_lung.sh: in-domain JSRT Dice and OOD NLM(MC)/NLM(SZ).
# Pass --data.dataroot=<JSRT dir>,
# --data.ood_roots=nlm:<NLM dir>,sz:<SZ dir>:_mask, and the trained run's
# --run.save_dir/--run.name (the checkpoint is loaded from there).
exec python -m semantic_segmentation_torch.train.test_seg "$@"
