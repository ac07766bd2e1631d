#!/usr/bin/env bash
# The port's train_pix2pix_isic.sh: stage 1 at output_nc 3 on ISIC2018, on
# the card.
exec python -m semantic_segmentation_torch.train.train_pix2pix \
    --preset=pix2pix_isic "$@"
