#!/usr/bin/env bash
# The port's train_end2end_isic.sh: the 40-shot ISIC regime (Jaccard loss,
# the fake_trans photometric post-process), on the card.
exec python -m semantic_segmentation_torch.train.train_end2end \
    --preset=end2end_isic "$@"
