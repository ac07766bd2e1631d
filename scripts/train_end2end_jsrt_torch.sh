#!/usr/bin/env bash
# The port's train_end2end_jsrt.sh: end-to-end bilevel GenSeg on the 9-shot
# JSRT regime, on the card (--run.device=cpu for the CPU). Flags:
# --data.dataroot=<JSRT dir>, --run.pretrained_pix2pix=<stage-1 ckpt dir>.
exec python -m semantic_segmentation_torch.train.train_end2end \
    --preset=end2end_jsrt "$@"
