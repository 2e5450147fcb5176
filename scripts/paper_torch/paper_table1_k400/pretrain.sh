#!/bin/sh
# port of scripts/paper/paper_table1_k400/pretrain.sh
. "$(dirname "$0")/../common.sh"
python -m dualvar_tpu_torch.train.pretrain --preset paper_table1_k400 --name_prefix "$EXP_NAME" $DATA_ARGS
