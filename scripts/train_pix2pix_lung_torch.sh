#!/usr/bin/env bash
# The port's train_pix2pix_lung.sh: stage-1 pix2pix pre-training on JSRT
# (200 epochs x 80 images, batch 2), on the card.
exec python -m semantic_segmentation_torch.train.train_pix2pix \
    --preset=pix2pix_jsrt "$@"
