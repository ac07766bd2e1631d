#!/usr/bin/env bash
# The port's test_isic.sh: the ISIC test split and the PH2/DermIS OOD sets.
exec python -m semantic_segmentation_torch.train.test_seg \
    --data.dataset=isic "$@"
