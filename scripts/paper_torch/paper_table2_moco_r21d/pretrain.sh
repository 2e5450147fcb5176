#!/bin/sh
# port of scripts/paper/paper_table2_moco_r21d/pretrain.sh
. "$(dirname "$0")/../common.sh"
python -m dualvar_tpu_torch.train.pretrain --preset paper_table2_moco_r21d --name_prefix "$EXP_NAME" $DATA_ARGS
